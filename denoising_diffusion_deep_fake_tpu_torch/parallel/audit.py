"""Collective census of a train step: what the step sends between ranks.

Port of ``denoising_diffusion_deep_fake_tpu/parallel/audit.py:38-152``.
The JAX package compiles a sharded step and parses its HLO for the
collectives XLA inserted; the port issues every collective itself through
``parallel/collectives.py``, so its census is recorded while one real step
runs (``collectives.recording``): the kind and the bytes of each call. The
policy is JAX's, with its limits: gradients must be reduced, no halo
exchange (``collective-permute``) without spatial sharding, and no
all-gather or all-to-all above 16 MiB (a full tensor gathered). The port
adds one kind, ``broadcast`` (the loop's ``want_images``, the state's
start), which the policy does not judge. A spatial step's halo exchanges
are issued by the port too (``parallel/halo.py``), so its census counts
them as ``collective-permute`` beside the all-reduces, with JAX's policy
as it stands: halos allowed, no all-gather above 16 MiB. The
squeeze-excite blocks' spatial sums (EfficientNet's and SENet's SE means
on a rank's rows, ``collectives.spatial_sum``) are all-reduces too, counted
apart as ``spatial_sums`` of the ``all-reduce`` row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.parallel import collectives

_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all", "broadcast")


@dataclasses.dataclass
class CollectiveStats:
    """One collective kind's aggregate footprint in a step."""

    count: int = 0
    total_bytes: int = 0
    max_bytes: int = 0
    shapes: list = dataclasses.field(default_factory=list)  # (bytes, text)
    spatial_sums: int = 0   # of them, squeeze-excite spatial sums

    def add(self, nbytes: int, shape_text: str) -> None:
        self.count += 1
        self.spatial_sums += shape_text.endswith(collectives.SPATIAL_SUM)
        self.total_bytes += nbytes
        self.max_bytes = max(self.max_bytes, nbytes)
        self.shapes.append((nbytes, shape_text))
        self.shapes.sort(reverse=True)
        del self.shapes[8:]  # keep the top offenders only


def collective_census(calls) -> dict[str, CollectiveStats]:
    """Per-kind aggregates of recorded ``(kind, bytes, text)`` calls."""
    census = {op: CollectiveStats() for op in _COLLECTIVES}
    for kind, nbytes, text in calls:
        census[kind].add(nbytes, text)
    return census


def census_violations(census: dict[str, CollectiveStats], *, spatial: bool,
                      expect_grad_reduce: bool = True,
                      allgather_limit_bytes: int = 16 << 20,
                      alltoall_limit_bytes: int = 16 << 20) -> list[str]:
    """The audit policy. Returns human-readable violations (empty = clean).

    * gradients must be reduced (a data-parallel train step with no
      all-reduce trains each rank on its own rows),
    * halo collective-permutes may appear ONLY in spatial mode,
    * no all-gather / all-to-all near activation/parameter size (default
      limit 16 MiB).
    """
    out = []
    if expect_grad_reduce and census["all-reduce"].count == 0:
        out.append("no all-reduce in the compiled step: gradients are not "
                   "being reduced over the data axis")
    if not spatial and census["collective-permute"].count:
        out.append(
            f"{census['collective-permute'].count} collective-permute(s) in "
            "a data-only program (halo exchanges should not exist)")
    for op, limit in (("all-gather", allgather_limit_bytes),
                      ("all-to-all", alltoall_limit_bytes)):
        st = census[op]
        if st.max_bytes > limit:
            worst = st.shapes[0]
            out.append(
                f"{op} of {worst[0]:,} bytes (> limit {limit:,}): {worst[1]}"
                " — the partitioner is gathering a full tensor")
    return out


def census_summary(census: dict[str, CollectiveStats]) -> dict:
    """JSON-friendly summary: count, total and largest MiB of each kind,
    and the spatial sums among the all-reduces where there are any."""
    out = {
        op: {"count": st.count, "total_mib": round(st.total_bytes / 2**20, 3),
             "max_mib": round(st.max_bytes / 2**20, 3)}
        for op, st in census.items() if st.count
    }
    for op, st in census.items():
        if st.spatial_sums:
            out[op]["spatial_sums"] = st.spatial_sums
    return out


def census_of_train_step(workload: str, *, image_size: int, batch_size: int,
                         encoder_name: str = "resnet34",
                         compute_dtype: str = "bfloat16", device=None,
                         seed: int = 0, spatial: int = 1
                         ) -> dict[str, CollectiveStats]:
    """Run one real train step of ``workload`` (``denoiser``, ``swap`` or
    ``balance``) at the global ``batch_size`` on this rank's rows of a
    random uint8 batch (drawn from ``seed``, the same on every rank), and
    return the census of the collectives it issued, with the batch's
    H rows over ``spatial`` ranks (``spatial_parallel``). Call it on every
    rank of a process group (outside one it records nothing); the
    counterpart of JAX's ``lower_train_step_hlo``."""
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig,
        DeepFakeConfig,
        DenoiserConfig,
        config_from_dict,
    )
    from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
        shard_batch,
        shard_state,
    )

    common = dict(batch_size=batch_size, image_size=image_size,
                  learning_rate=1e-3, encoder_name=encoder_name,
                  compute_dtype=compute_dtype, spatial_parallel=spatial,
                  noise_exponential_sampling_lambda=8.0)
    if workload == "swap":
        from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
            DeepFakeTrainer)
        cfg = config_from_dict(DeepFakeConfig, dict(
            mode="swap", data_path_a="x", data_path_b="y",
            ema_update_after_step=0, **common), validate=False)
        trainer = DeepFakeTrainer(cfg, steps_per_epoch=100,
                                  image_size=image_size, device=device)
        states = trainer.init_states(cfg.seed)
        n_batches = 2
    elif workload in ("denoiser", "balance"):
        if workload == "denoiser":
            from denoising_diffusion_deep_fake_tpu_torch.training.denoiser \
                import DenoiserTrainer as cls
            cfg = config_from_dict(DenoiserConfig, dict(
                input_image_list_path="x", **common), validate=False)
        else:
            from denoising_diffusion_deep_fake_tpu_torch.training.balance \
                import BalanceTrainer as cls
            cfg = config_from_dict(BalanceConfig, dict(
                data_path="x", ratio_of_noise=0.7, **common), validate=False)
        trainer = cls(cfg, steps_per_epoch=100, image_size=image_size,
                      device=device)
        states = trainer.init_state(cfg.seed)
        n_batches = 1
    else:
        raise ValueError(f"unknown workload {workload!r}")
    shard_state(states, trainer.mesh)
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(shard_batch(rng.integers(
        0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8),
        trainer.mesh)) for _ in range(n_batches)]
    with collectives.recording() as calls:
        metrics = trainer.train_step(states, *batches)
        for v in metrics.values():
            if isinstance(v, torch.Tensor):
                v.cpu()  # the step has run
    return collective_census(calls)
