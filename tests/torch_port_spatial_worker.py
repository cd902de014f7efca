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

Every U-Net is float64 (``float64_states``). Each rank saves what the
test holds to ``WORKDIR/spatial<world>_rank<RANK>.pt``: rank 0 its steps'
tensors, the others (and rank 0 for the remat steps, held bit-equal) only
their fingerprints.

``python torch_port_spatial_worker.py STORE RANK WORKDIR families`` is one
rank of ``test_torch_port_spatial_families.py`` (four ranks,
``families_main``): efficientnet-b0 at data 2 x spatial 2, then on ranks 0
and 1 each of ``FAMILY_CASES`` over spatial 2, the JAX test's forwards
(``WORKDIR/jax_forward_<key>.pt``) and the census of a b0 step, while
ranks 2 and 3, out of any group, take turns at each case's one-process
reference. Rank 0 writes each case's step to ``WORKDIR/fam_<key>.pt``,
ranks 2 and 3 its reference to ``WORKDIR/ref_<key>.pt``, as soon as it
has run (the test compares and deletes them); every rank ends with its
fingerprints in ``WORKDIR/families_rank<RANK>.pt``.
"""

from __future__ import annotations

import contextlib
import hashlib
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


def float64_states(trainer, workload: str):
    """``dp.float64_states``, a patchified model's inner U-Net computing in
    float64 too."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states)
    states = dp.float64_states(trainer, workload)
    for state in model_states(states):
        for model in (state.model, state.ema_model):
            if hasattr(model, "unet"):
                model.unet.dtype = torch.float64
    return states


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
    states = shard_state(float64_states(trainer, workload), trainer.mesh)
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


# ------------------------------------------------- the nine other families

# (key, workload, encoder, image size, patchify_stem) of each spatial-2
# case of the families' test, in the order the ranks run them: one name a
# family and the patchified resnet18 at 64^2, three at 32^2 (their deepest
# levels replicated), b0's swap pair and balancer. The two largest
# encoders, whose ops inceptionv4 and the others step through already,
# run a forward and its loss ("forward") to keep the test's time.
FAMILY_CASES = (
    *((name, "denoiser", name, SIZE, 1) for name in (
        "efficientnet-b0", "vgg11_bn", "densenet121", "se_resnext50_32x4d",
        "mobilenet_v2")),
    ("xception", "forward", "xception", SIZE, 1),
    ("inceptionv4", "denoiser", "inceptionv4", SIZE, 1),
    ("inceptionresnetv2", "forward", "inceptionresnetv2", SIZE, 1),
    ("dpn68", "denoiser", "dpn68", SIZE, 1),
    ("resnet18_patchify2", "denoiser", "resnet18", SIZE, 2),
    *((f"{name}_32", "denoiser", name, 32, 1) for name in (
        "efficientnet-b0", "se_resnext50_32x4d", "inceptionv4")),
    ("efficientnet-b0_swap", "swap", "efficientnet-b0", SIZE, 1),
    ("efficientnet-b0_balance", "balance", "efficientnet-b0", SIZE, 1),
)
# The data 2 x spatial 2 case (four ranks, a global batch of 4).
D2S2_CASE = ("efficientnet-b0_d2s2", "denoiser", "efficientnet-b0", SIZE, 1)
# The forwards held against JAX's (1, 2) mesh: (key, encoder, patchify).
JAX_FORWARDS = (("efficientnet-b0", "efficientnet-b0", 1),
                ("resnet18_patchify2", "resnet18", 2))


def family_step(case: tuple, batch: int, spatial: int = 1) -> dict:
    """One step of a ``FAMILY_CASES`` entry over ``spatial`` ranks (the
    one-process reference with 1), or its forward and loss."""
    _, workload, encoder, size, patchify = case
    if workload == "forward":
        return family_forward(encoder, batch, size, spatial)
    return one_step(workload, batch, size, spatial, encoder_name=encoder,
                    patchify_stem=patchify)


def family_forward(encoder: str, batch: int, size: int,
                   spatial: int = 1) -> dict:
    """The denoiser's float64 U-Net, train mode, on a fixed noisy batch over
    ``spatial`` ranks: the whole prediction (the rows gathered over the
    data row) and the loss against the clean batch, as ``metric.loss``,
    with the fingerprint of both."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.losses import (
        mse_ssim_loss)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
    from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
        gather_rows, spatial_all_reduce_)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_rows)
    trainer = make_trainer("denoiser", batch, size, encoder_name=encoder,
                           spatial_parallel=spatial)
    state = float64_states(trainer, "denoiser")
    rng = np.random.default_rng(9)
    target = torch.from_numpy(rng.uniform(-1, 1, (batch, size, size, 3)))
    noisy = 0.7 * target + 0.7 * torch.from_numpy(
        rng.standard_normal(target.shape))
    mesh = trainer.mesh
    state.model.train()
    with torch.no_grad(), halo.row_sharded(mesh):
        pred = state.model(shard_rows(noisy, mesh))
        share = mse_ssim_loss(pred, shard_rows(target, mesh), mesh=mesh)
        pred = gather_rows(pred, mesh, dim=1)
    loss = float(spatial_all_reduce_(share.clone(), mesh))
    digest = hashlib.sha256(pred.numpy().tobytes() + repr(loss).encode())
    return {"metric.loss": loss, "pred": pred,
            "fingerprint": digest.hexdigest()}


def jax_forward(path: Path, spatial: int) -> dict:
    """The train-mode forward of the JAX test's weights on this rank's rows
    of its input (the drop masks injected), in float64, and the loss
    against its target, summed over the data row."""
    from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
        create_unet)
    from denoising_diffusion_deep_fake_tpu_torch.ops.losses import (
        mse_ssim_loss)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
    from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
        spatial_all_reduce_)
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_rows, training_mesh)
    data = torch.load(path, weights_only=False)
    mesh = training_mesh(None, spatial)
    model = create_unet(data["encoder"], patchify=data["patchify"])
    model.load_state_dict(data["state_dict"])
    model.double().dtype = torch.float64
    if hasattr(model, "unet"):
        model.unet.dtype = torch.float64
    model.train()
    with torch.no_grad(), halo.row_sharded(mesh):
        pred = model(shard_rows(data["x"], mesh), data["masks"])
        share = mse_ssim_loss(pred, shard_rows(data["target"], mesh),
                              mesh=mesh)
    return {"pred": pred, "loss": float(spatial_all_reduce_(share.clone(),
                                                            mesh))}


def families_census() -> dict:
    """The census of one fp32 efficientnet-b0 denoiser step over spatial 2:
    its squeeze-excite sums among the all-reduces."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step,
        census_summary,
        census_violations,
    )
    c = census_of_train_step("denoiser", image_size=SIZE, batch_size=2,
                             encoder_name="efficientnet-b0",
                             compute_dtype="float32", device="cpu",
                             spatial=2)
    return {"summary": census_summary(c),
            "violations": census_violations(c, spatial=True)}


def _publish(out: dict, path: Path) -> None:
    """``torch.save`` to ``path`` whole or not at all (the test polls it)."""
    part = path.with_suffix(".part")
    torch.save(out, part)
    part.replace(path)


def families_main(store: str, rank: int, workdir: Path) -> None:
    torch.set_num_threads(1)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import distributed

    prints = {}

    def run(case, batch):
        out = family_step(case, batch, spatial=2)
        prints[case[0]] = out["fingerprint"]
        if rank == 0:
            _publish(out, workdir / f"fam_{case[0]}.pt")

    distributed.initialize(f"{store}.4", 4, rank, device="cpu")
    run(D2S2_CASE, 4)
    distributed.shutdown()
    forwards = census = None
    if rank < 2:
        distributed.initialize(f"{store}.2", 2, rank, device="cpu")
        for case in FAMILY_CASES:
            run(case, 2)
        forwards = {key: jax_forward(workdir / f"jax_forward_{key}.pt", 2)
                    for key, _, _ in JAX_FORWARDS}
        census = families_census()
        distributed.shutdown()
    else:
        cases = [(D2S2_CASE, 4)] + [(c, 2) for c in FAMILY_CASES]
        for case, batch in cases[rank - 2::2]:
            with (loss_in_row_shares(2) if case[1] == "swap"
                  else contextlib.nullcontext()):
                _publish(family_step(case, batch),
                         workdir / f"ref_{case[0]}.pt")
    torch.save({"fingerprints": prints, "jax": forwards, "census": census},
               workdir / f"families_rank{rank}.pt")
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    if sys.argv[4:] == ["families"]:
        families_main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
    else:
        main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
