"""One rank of the port's data-parallel CPU checks (``test_torch_port_
distributed.py`` launches two): ``python torch_port_dp_worker.py STORE
WORLD RANK WORKDIR``. It joins the gloo process group on the ``file://``
store, runs every check below on its rows, and saves what the test holds
to ``WORKDIR/rank<RANK>.pt``. It imports no JAX: the test computes the
one-process and JAX references itself.

The checks, in the order every rank runs them (a rank's collectives must
meet its peer's):

* ``steps``: one step of the denoiser, the swap pair and the balancer at
  the global batch ``dp_inputs`` gives, the U-Net in float64;
* ``jax``: one denoiser step on the weights and injected global numbers in
  ``WORKDIR/jax_inputs.pt``, the U-Net in float64;
* ``census``: the collectives of one fp32 denoiser step;
* ``remat``: one fp32 denoiser step under each ``remat`` policy, with the
  number of all-reduces each issued;
* ``lockstep``: a non-finite metric on rank 1 only, and a SIGTERM flag on
  rank 1 only, through ``LoopContext``;
* ``fit``: ``fit_denoiser`` for 2 steps from ``WORKDIR/images.txt``,
  through the host loader and through the device cache, then a restore of
  the checkpoint.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

SIZE, GLOBAL_BATCH, ENCODER = 64, 4, "resnet18"


def dp_inputs(workload: str, seed: int = 3) -> list[np.ndarray]:
    """The global uint8 batches of one step (two for the swap pair)."""
    rng = np.random.default_rng(seed)
    n = 2 if workload == "swap" else 1
    return [rng.integers(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3), np.uint8)
            for _ in range(n)]


def make_trainer(workload: str, **extra):
    """A trainer of ``workload`` at the test's size, on the CPU."""
    from denoising_diffusion_deep_fake_tpu_torch import config
    common = dict(dict(batch_size=GLOBAL_BATCH, image_size=SIZE,
                       learning_rate=1e-3, encoder_name=ENCODER,
                       compute_dtype="float32"), **extra)
    if workload == "swap":
        from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake \
            import DeepFakeTrainer
        cfg = config.config_from_dict(config.DeepFakeConfig, dict(
            mode="swap", data_path_a="x", data_path_b="y",
            ema_update_after_step=0, **common))
        return DeepFakeTrainer(cfg, steps_per_epoch=10, image_size=SIZE,
                               device="cpu")
    if workload == "balance":
        from denoising_diffusion_deep_fake_tpu_torch.training.balance \
            import BalanceTrainer
        cfg = config.config_from_dict(config.BalanceConfig, dict(
            data_path="x", ratio_of_noise=0.7, **common))
        return BalanceTrainer(cfg, steps_per_epoch=10, image_size=SIZE,
                              device="cpu")
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)
    cfg = config.config_from_dict(config.DenoiserConfig, dict(
        input_image_list_path="x", noise_exponential_sampling_lambda=3.0,
        **common))
    return DenoiserTrainer(cfg, steps_per_epoch=10, image_size=SIZE,
                           device="cpu")


def float64_states(trainer, workload: str):
    """Fresh states with every U-Net (shadows too) in float64: fp32
    gradients of a 64^2 U-Net are too ill-conditioned for 1e-5 (a
    decoder BN's bias gradient is a sum that nearly cancels)."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states)
    states = (trainer.init_states(0) if workload == "swap"
              else trainer.init_state(0))
    for state in model_states(states):
        for model in (state.model, state.ema_model):
            if model is not None:
                model.double().dtype = torch.float64
    return states


def snapshot(states, metrics) -> dict:
    """Metrics, each model's tensors, gradients, Adam moments and
    shadow, under ``<identity>.<kind>.<name>``, the tensors stored in fp32
    (the tests' tolerances are far above its rounding), and
    ``fingerprint``, a digest of their full-precision bytes."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states)
    out = {f"metric.{k}": float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor)}
    for i, state in enumerate(model_states(states)):
        for name, t in state.model.state_dict().items():
            out[f"{i}.model.{name}"] = t
        if state.has_ema:
            for name, t in state.ema_model.state_dict().items():
                out[f"{i}.shadow.{name}"] = t
        for name, p in state.model.named_parameters():
            out[f"{i}.grad.{name}"] = p.grad
            for k, v in state.optimizer.state[p].items():
                if k != "step":
                    out[f"{i}.adam_{k}.{name}"] = v
    digest = hashlib.sha256()
    for k, v in out.items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().numpy().tobytes()
                      if isinstance(v, torch.Tensor) else repr(v).encode())
    out = {k: v.detach().float().clone() if isinstance(v, torch.Tensor)
           else v for k, v in out.items()}
    out["fingerprint"] = digest.hexdigest()
    return out


def one_step(workload: str, mesh_rows) -> dict:
    """One step of ``workload`` on ``mesh_rows(global batch)`` (a rank's
    rows, or the whole batch for the one-process reference)."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_state)
    trainer = make_trainer(workload)
    states = shard_state(float64_states(trainer, workload), trainer.mesh)
    batches = [torch.from_numpy(mesh_rows(b, trainer))
               for b in dp_inputs(workload)]
    return snapshot(states, trainer.train_step(states, *batches))


def jax_step(inputs: dict, rows) -> dict:
    """The denoiser step on the JAX test's weights and global numbers."""
    trainer = make_trainer("denoiser", warp_method="gather",
                           learning_rate=0.02, mean=(0.5,) * 3,
                           std=(0.5,) * 3)
    state = trainer.init_state(0)
    state.model.load_state_dict(inputs["state_dict"])
    state.model.double().dtype = torch.float64
    metrics = trainer.train_step(
        state, rows(inputs["u8"], trainer),
        affine_params=inputs["params"], ratios=inputs["ratios"],
        noise=inputs["noise"])
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.clone()
                      for n, p in state.model.named_parameters()},
            "stats": {n: b.clone() for n, b in state.model.named_buffers()}}


def census() -> dict:
    from denoising_diffusion_deep_fake_tpu_torch.parallel.audit import (
        census_of_train_step,
        census_summary,
        census_violations,
    )
    c = census_of_train_step("denoiser", image_size=SIZE,
                             batch_size=GLOBAL_BATCH, encoder_name=ENCODER,
                             compute_dtype="float32", device="cpu")
    trainer = make_trainer("denoiser")
    grad_bytes = sum(p.numel() * 4 for p in
                     trainer.init_state(0).model.parameters())
    return {"summary": census_summary(c),
            "violations": census_violations(c, spatial=False),
            "all_reduce_bytes": c["all-reduce"].total_bytes,
            "grad_bytes": grad_bytes}


def remat() -> dict:
    """Gradients, BN statistics and all-reduce count of one fp32 step
    under ``remat: none | dots | full`` from the same start: a recompute
    issues batch norm's all-reduces again, on every rank in the same
    order, and writes no statistics."""
    from denoising_diffusion_deep_fake_tpu_torch.parallel import collectives
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    out = {}
    for policy in ("none", "dots", "full"):
        trainer = make_trainer("denoiser", remat=policy)
        state = trainer.init_state(0)
        batch = torch.from_numpy(shard_batch(dp_inputs("denoiser")[0],
                                             trainer.mesh))
        with collectives.recording() as calls:
            trainer.train_step(state, batch)
        out[policy] = {
            "all_reduces": sum(k == "all-reduce" for k, _, _ in calls),
            "grads": [p.grad.clone() for p in state.model.parameters()],
            "buffers": [b.clone() for b in state.model.buffers()]}
    return out


def lockstep(rank: int, workdir: Path) -> dict:
    """A NaN logged by rank 1 alone at step 3, then a SIGTERM flag set on
    rank 1 alone at call 4: where each rank raised and stopped."""
    from denoising_diffusion_deep_fake_tpu_torch.training.loop import (
        LoopContext,
        TrainingDivergedError,
    )
    trainer = make_trainer("denoiser", log_dir=str(workdir / "lock_logs"),
                           checkpoint_dir=str(workdir / "lock_ckpt"),
                           log_images=False, handle_preemption=True)
    out = {}
    ctx = LoopContext(trainer.cfg, {}, workload="lock", mesh=trainer.mesh)
    try:
        for step in range(6):
            loss = float("nan") if (rank == 1 and step == 3) else 0.5
            ctx.log_step({"loss": torch.tensor(loss)})
            ctx.global_step += 1
    except TrainingDivergedError as e:
        out["diverged_at"] = ctx.global_step
        out["diverged_msg"] = str(e)
    ctx.abort()
    ctx = LoopContext(trainer.cfg, {}, workload="lock", mesh=trainer.mesh)
    for call in range(1, 40):
        if rank == 1 and call == 4:
            ctx.preemption._flag = True
        if ctx.preempted():
            out["stopped_at"] = call
            break
    ctx.abort()
    return out


def fit(workdir: Path) -> dict:
    """``fit_denoiser`` for 2 steps from the manifest through the host
    loader and through the device cache, then every rank's restore of the
    checkpoint the cached run leaves."""
    from denoising_diffusion_deep_fake_tpu_torch import config
    from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
        CheckpointManager)
    from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
        fit_denoiser)
    runs = {}
    for cache in ("host", "device"):
        cfg = config.config_from_dict(config.DenoiserConfig, dict(
            input_image_list_path=str(workdir / "images.txt"),
            batch_size=GLOBAL_BATCH, image_size=32, encoder_name=ENCODER,
            compute_dtype="float32", max_epochs=5, data_cache=cache,
            log_dir=str(workdir / f"fit_logs_{cache}"),
            checkpoint_dir=str(workdir / f"fit_ckpt_{cache}"),
            log_images=False))
        runs[cache] = fit_denoiser(cfg, max_steps=2, verbose=False,
                                   device="cpu")
    state, trainer, ctx = runs["device"]
    torch.distributed.barrier()  # the primary's save is on disk
    fresh = make_trainer("denoiser")
    restored, meta = CheckpointManager(cfg.checkpoint_dir).restore(
        lambda: trainer.init_state(1), generator=fresh.generator)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(a.model.state_dict().values(),
                       b.model.state_dict().values()))

    return {"step": state.step, "global_step": ctx.global_step,
            "restored_step": restored.step, "saved_step": meta["step"],
            "generator_equal": torch.equal(fresh.generator.get_state(),
                                           trainer.generator.get_state()),
            "restored_equal": same(restored, state),
            "host_equals_cache": same(runs["host"][0], state)}


def main(store: str, world: int, rank: int, workdir: Path) -> None:
    torch.set_num_threads(1)
    from denoising_diffusion_deep_fake_tpu_torch.parallel import distributed
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch)
    distributed.initialize(store, world, rank, device="cpu")

    def rows(x, trainer):
        return shard_batch(x, trainer.mesh)

    out = {w: one_step(w, rows) for w in ("denoiser", "swap", "balance")}
    if rank:
        # Rank 1 keeps only the digests: the test holds them to rank 0's.
        out = {w: {"fingerprint": v["fingerprint"]} for w, v in out.items()}
    inputs = torch.load(workdir / "jax_inputs.pt", weights_only=False)
    out["jax"] = jax_step(inputs, lambda x, t: shard_batch(x, t.mesh))
    out["census"] = census()
    out["remat"] = remat()
    out["lockstep"] = lockstep(rank, workdir)
    out["fit"] = fit(workdir)
    torch.save(out, workdir / f"rank{rank}.pt")
    distributed.shutdown()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
