"""One rank of the port's spatial-parallel CPU checks (``test_torch_port_
spatial.py`` launches four): ``python torch_port_spatial_worker.py STORE
RANK WORKDIR``. It imports no JAX: the test computes the one-process and
JAX references itself.

Two process groups in turn, on the ``file://`` stores ``STORE.4`` and
``STORE.2``:

* all four ranks, ``data_parallel: 2`` x ``spatial_parallel: 2``: one
  denoiser step at 64^2 on a global batch of 4, and the same step on the
  JAX test's weights and injected numbers (``WORKDIR/jax_inputs_4.pt``);
* ranks 0 and 1, ``spatial_parallel: 2``: one step of the denoiser, the
  swap pair and the balancer at 64^2 on a global batch of 2, the
  denoiser at 32^2 (whose stride-32 level gathers its rows), the
  denoiser under ``remat: dots`` and ``full``, the JAX test's step
  (``WORKDIR/jax_inputs_2.pt``), the census of one step, the balancer's
  scores, the denoiser's panels, and ``fit_denoiser`` for one step from
  ``WORKDIR/images.txt`` with the knobs in its config alone. Ranks 2
  and 3 leave after the first group.

Every U-Net is float64 (``torch_port_dp_worker.float64_states``). Each rank
saves what the test holds to ``WORKDIR/spatial<world>_rank<RANK>.pt``: rank
0 its steps' tensors, the others (and rank 0 for the remat steps, held
bit-equal) only their fingerprints.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

import torch_port_dp_worker as dp

SIZE = 64
# Every step runs at lr 1e-3. The swap pair's model b trains on fakes of
# a's post-step shadow, and Adam's first step moves a weight whose
# gradient lies near its eps by up to 2 lr, by an amount the gradient's
# last digits decide. The fp32 loss of S ranks adds its rows in S shares,
# and that order alone, in one process with nothing exchanged
# (``loss_in_row_shares``), parts b's gradients from the plain step's by
# up to 0.8% of a tensor's largest (the test's witness). So the spatial
# pair is held against the one-process step with its loss in row shares.
LR = 1e-3


@contextlib.contextmanager
def loss_in_row_shares(spatial: int = 2):
    """One process's steps with a spatial run's loss arithmetic:
    ``mse_ssim_loss`` as the sum of the ``spatial`` row blocks' shares
    (``ops/losses.py``'s spatial path), each block's SSIM halo rows cut
    from the whole batch in place of an exchange."""
    from denoising_diffusion_deep_fake_tpu_torch.ops import losses, ssim
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import Mesh
    from denoising_diffusion_deep_fake_tpu_torch.training import state
    whole_loss, exchange = state.mse_ssim_loss, ssim.exchange_rows

    def shares(pred, target, *, mesh=None):
        xy = torch.cat([losses._normalise_between_zero_and_one(
            t.to(torch.float32), -1.0, 1.0) for t in (pred, target)], -1)

        def cut(x, above, below, m, *, dim, pad):
            a, n = m.spatial_index * x.shape[dim], x.shape[dim]
            lo, hi = max(a - above, 0), min(a + n + below, xy.shape[dim])
            return xy.narrow(dim, lo, hi - lo)

        n = pred.shape[1] // spatial
        ssim.exchange_rows = cut
        try:
            return sum(whole_loss(pred[:, s * n:(s + 1) * n],
                                  target[:, s * n:(s + 1) * n],
                                  mesh=Mesh(data=1, spatial=spatial, rank=s,
                                            world=spatial))
                       for s in range(spatial))
        finally:
            ssim.exchange_rows = exchange

    state.mse_ssim_loss = shares
    try:
        yield
    finally:
        state.mse_ssim_loss = whole_loss


def inputs(workload: str, batch: int, size: int = SIZE,
           seed: int = 3) -> list[np.ndarray]:
    """The global uint8 batches of one step (two for the swap pair)."""
    rng = np.random.default_rng(seed)
    n = 2 if workload == "swap" else 1
    return [rng.integers(0, 256, (batch, size, size, 3), np.uint8)
            for _ in range(n)]


def make_trainer(workload: str, batch: int, size: int = SIZE, **extra):
    """``dp.make_trainer`` at this batch and size: the knobs decide the
    layout (``spatial_parallel`` 1 for the one-process reference)."""
    return dp.make_trainer(workload, batch_size=batch, image_size=size,
                           **extra)


def one_step(workload: str, batch: int, size: int = SIZE,
             spatial: int = 1, **extra) -> dict:
    """One step of ``workload`` from float64 U-Nets on this rank's part of
    the global batch (the whole of it for the reference), with the config
    knobs ``extra``."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch,
        shard_state,
    )
    trainer = make_trainer(workload, batch, size, spatial_parallel=spatial,
                           learning_rate=LR, **extra)
    states = shard_state(dp.float64_states(trainer, workload), trainer.mesh)
    batches = [torch.from_numpy(shard_batch(b, trainer.mesh))
               for b in inputs(workload, batch, size)]
    return dp.snapshot(states, trainer.train_step(states, *batches))


def jax_step(path: Path, spatial: int) -> dict:
    """The denoiser step on the JAX test's weights and global numbers."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    data = torch.load(path, weights_only=False)
    batch = data["u8"].shape[0]
    trainer = make_trainer("denoiser", batch, warp_method="gather",
                           learning_rate=0.02, mean=(0.5,) * 3,
                           std=(0.5,) * 3, spatial_parallel=spatial)
    state = trainer.init_state(0)
    state.model.load_state_dict(data["state_dict"])
    state.model.double().dtype = torch.float64
    metrics = trainer.train_step(
        state, shard_batch(data["u8"], trainer.mesh),
        affine_params=data["params"], ratios=data["ratios"],
        noise=data["noise"])
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.clone()
                      for n, p in state.model.named_parameters()},
            "stats": {n: b.clone() for n, b in state.model.named_buffers()}}


def panels(spatial: int = 1) -> dict:
    """The denoiser's TensorBoard panels of one fp32 step at 64^2 x2 (a
    spatial rank's rows gathered over its data row)."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    trainer = make_trainer("denoiser", 2, spatial_parallel=spatial)
    state = trainer.init_state(0)
    batch = torch.from_numpy(shard_batch(inputs("denoiser", 2)[0],
                                         trainer.mesh))
    return trainer.train_step(state, batch, with_images=True)[1]


def census() -> dict:
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step,
        census_summary,
        census_violations,
    )
    c = census_of_train_step("denoiser", image_size=SIZE, batch_size=2,
                             encoder_name=dp.ENCODER,
                             compute_dtype="float32", device="cpu",
                             spatial=2)
    return {"summary": census_summary(c),
            "violations": census_violations(c, spatial=True),
            "data_only": census_violations(c, spatial=False)}


def scores() -> torch.Tensor:
    """The balancer's scores of one batch of 3 on the rows of each rank,
    float64 U-Net."""
    trainer = make_trainer("balance", 2, spatial_parallel=2)
    state = dp.float64_states(trainer, "balance")
    batch = torch.from_numpy(inputs("balance", 3, seed=5)[0])
    return trainer.make_validation_step()(state, batch, offset=9)


def fit(workdir: Path) -> dict:
    """``fit_denoiser`` for one step at 32^2 from the knobs alone, as
    ``tests/test_parallel.py:118-150`` runs JAX's."""
    from denoising_diffusion_deep_fake_tpu_torch import config
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)
    cfg = config.config_from_dict(config.DenoiserConfig, dict(
        input_image_list_path=str(workdir / "images.txt"), batch_size=2,
        spatial_parallel=2, image_size=32, learning_rate=1e-3,
        max_epochs=1, encoder_name=dp.ENCODER, compute_dtype="float32",
        noise_exponential_sampling_lambda=3.0, log_images=False,
        log_dir=str(workdir / "fit_logs"),
        checkpoint_dir=str(workdir / "fit_ckpt")))
    seen = []
    state, trainer, ctx = fit_denoiser(
        cfg, max_steps=1, verbose=False, device="cpu",
        step_callback=lambda step, states, metrics: seen.append(
            float(metrics["loss"])))
    return {"losses": seen, "mesh": (trainer.mesh.data,
                                     trainer.mesh.spatial),
            "weights": [t.clone() for t in state.model.state_dict().values()]}


def _lean(out: dict, rank: int, prints=()) -> dict:
    """``out`` with the steps' snapshots of a rank other than 0, and those
    named in ``prints``, cut to their fingerprints."""
    return {k: {"fingerprint": v["fingerprint"]}
            if isinstance(v, dict) and "fingerprint" in v
            and (rank or k in prints) else v for k, v in out.items()}


def main(store: str, rank: int, workdir: Path) -> None:
    torch.set_num_threads(1)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import distributed

    distributed.initialize(f"{store}.4", 4, rank, device="cpu")
    out = {"denoiser": one_step("denoiser", 4, spatial=2),
           "jax": jax_step(workdir / "jax_inputs_4.pt", 2)}
    torch.save(_lean(out, rank), workdir / f"spatial4_rank{rank}.pt")
    distributed.shutdown()
    if rank >= 2:
        return
    distributed.initialize(f"{store}.2", 2, rank, device="cpu")
    out = {w: one_step(w, 2, spatial=2)
           for w in ("denoiser", "swap", "balance")}
    out["denoiser_32"] = one_step("denoiser", 2, 32, spatial=2)
    out.update({f"remat_{p}": one_step("denoiser", 2, spatial=2, remat=p)
                for p in ("dots", "full")})
    out["jax"] = jax_step(workdir / "jax_inputs_2.pt", 2)
    out["census"] = census()
    out["scores"] = scores()
    out["panels"] = panels(2)
    out["fit"] = fit(workdir)
    torch.save(_lean(out, rank, ("remat_dots", "remat_full")),
               workdir / f"spatial2_rank{rank}.pt")
    distributed.shutdown()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
