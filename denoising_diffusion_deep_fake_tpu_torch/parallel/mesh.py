"""The data-parallel layout: which rows of the global batch are this rank's.

Port of ``denoising_diffusion_deep_fake_tpu/parallel/mesh.py:60-145``. JAX
builds a ``('data', 'spatial')`` mesh over devices and lets ``jit`` shard
the batch over ``data``; one JAX process drives every device of its host.
A PyTorch process drives one device, so the port's mesh is the process
group itself: ``data`` is the world size, and rank ``r`` of ``data`` holds
rows ``r * lb .. (r + 1) * lb - 1`` of a global batch of ``data * lb``
(``shard_batch``). A single process asked for ``data_parallel > 1`` raises
and says to launch that many processes (``parallel/distributed.py``).

``spatial > 1`` (JAX's H-sharded activations, whose halo exchanges XLA
derives from the convolutions' padding, ``mesh.py:96-115``) has no stock
PyTorch counterpart: every convolution would need a hand-written halo
exchange. It is refused, naming ROADMAP A9b.

``shard_state`` makes every rank start from rank 0's parameters, buffers
and shadows. JAX's ``device_prefetch`` for several processes (each
process's slice into the global array, ``:182-193``) is the port's
``data/loader.py`` ``device_prefetch`` on the rank's device: the slice is
the rank's batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from denoising_diffusion_deep_fake_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout of one rank: ``data`` ranks by ``spatial`` (always 1),
    this process's ``rank`` of ``world``, the process ``group`` (None
    outside one, when every collective is the identity) and ``device``,
    where the loop's host numbers travel for a collective."""

    data: int = 1
    spatial: int = 1
    rank: int = 0
    world: int = 1
    group: object = None
    device: torch.device = torch.device("cpu")

    @property
    def in_group(self) -> bool:
        return self.group is not None


def _refuse_spatial(spatial: int) -> None:
    if spatial > 1:
        raise NotImplementedError(
            f"spatial_parallel={spatial}: H-sharded activations need a halo "
            "exchange in every convolution, not ported to the PyTorch "
            "trainer (ROADMAP A9b)")


def _comm_device() -> torch.device:
    """Where host numbers go for a collective: the rank's GPU under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        from denoising_diffusion_deep_fake_tpu_torch.parallel.distributed \
            import local_device_index
        return torch.device("cuda", local_device_index())
    return torch.device("cpu")


def create_mesh(data_parallel: int | None = None, spatial: int = 1) -> Mesh:
    """The mesh of this process. In a process group the data axis is the
    world size (``data_parallel`` None or equal to it); outside one,
    ``data_parallel`` must be None or 1."""
    _refuse_spatial(spatial)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if data_parallel not in (None, world):
            raise ValueError(f"data_parallel={data_parallel} in a process "
                             f"group of {world}")
        return Mesh(world, 1, dist.get_rank(), world, dist.group.WORLD,
                    _comm_device())
    if data_parallel not in (None, 1):
        raise ValueError(
            f"data_parallel={data_parallel}: a PyTorch process drives one "
            f"device; launch {data_parallel} processes with D3F_COORDINATOR, "
            "D3F_NUM_PROCESSES and D3F_PROCESS_ID set (README, PyTorch / "
            "H100 port)")
    return Mesh()


def training_mesh(data_parallel: int | None = None,
                  spatial: int = 1) -> Mesh:
    """The mesh every trainer and runner builds from its config knobs: in a
    process group the data axis spans every process whatever
    ``data_parallel`` says (JAX ``mesh.py:91-92``), else ``create_mesh``."""
    if dist.is_available() and dist.is_initialized():
        return create_mesh(None, spatial)
    return create_mesh(data_parallel, spatial)


def _rows(x, mesh: Mesh, dim: int):
    if isinstance(x, dict):
        return {k: _rows(v, mesh, dim) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_rows(v, mesh, dim) for v in x)
    if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim <= dim:
        return x
    n = x.shape[dim]
    if n % mesh.data:
        raise ValueError(f"global batch of {n} rows over {mesh.data} ranks")
    lb = n // mesh.data
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.rank * lb, (mesh.rank + 1) * lb)
    return x[tuple(index)]


def shard_batch(global_batch, mesh: Mesh, *, dim: int = 0):
    """This rank's rows of a global batch (a tensor, an array, or dicts and
    lists of them) along ``dim``; the batch itself on a data axis of 1."""
    if global_batch is None or mesh.data == 1:
        return global_batch
    return _rows(global_batch, mesh, dim)


def shard_state(states, mesh: Mesh):
    """Every rank's states made rank 0's: parameters, buffers and shadows
    (``training/state.py``'s ``shadow_tensors``), broadcast in place;
    returns ``states``. Adam's moments are left: they are empty at the
    start, and a restore reads the same files on every rank."""
    from denoising_diffusion_deep_fake_tpu_torch.training.state import (
        model_states,
        shadow_tensors,
    )

    tensors = []
    for state in model_states(states):
        tensors += shadow_tensors(state.model)
        if state.has_ema:
            tensors += shadow_tensors(state.ema_model)
    collectives.broadcast_tensors_(tensors, mesh)
    return states
