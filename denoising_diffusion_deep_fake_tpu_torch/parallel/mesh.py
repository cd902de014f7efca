"""The parallel layout: which rows of the global batch, and which rows of
each image, are this rank's.

Port of ``denoising_diffusion_deep_fake_tpu/parallel/mesh.py:27-145``. JAX
builds a ``('data', 'spatial')`` mesh over devices and lets ``jit`` shard
the batch over ``data`` and, with ``spatial > 1``, the activations' H over
``spatial``; one JAX process drives every device of its host. A PyTorch
process drives one device, so the port's mesh is the process group
itself: ``world = data * spatial`` ranks, rank ``r`` at data index ``d = r
// spatial`` and spatial index ``s = r % spatial``. Rank ``r`` holds rows
``d * lb .. (d + 1) * lb - 1`` of a global batch of ``data * lb``
(``shard_batch``) and, of each of those images, rows ``s * H / spatial ..
(s + 1) * H / spatial - 1`` (``shard_rows``). A single process asked for
``data_parallel > 1`` or ``spatial > 1`` raises and says to launch that
many processes (``parallel/distributed.py``).

With ``spatial > 1`` every rank creates, in the same order, one process
group for each data row (its ``spatial`` ranks: the halo exchanges, the
row gathers and the loss's sums, ``parallel/collectives.py``) and one for
each spatial column (its ``data`` ranks: batch norm at the U-Net's levels
that run replicated, ``parallel/halo.py``). XLA derives the halo
exchanges from each convolution's padding; the port issues them itself
(``parallel/halo.py``), for every encoder family's U-Net and the
patchified one, so the mesh does not depend on the model.

``shard_state`` makes every rank start from rank 0's parameters, buffers
and shadows. JAX's ``device_prefetch`` for several processes (each
process's slice into the global array, ``:182-193``) is the port's
``data/loader.py`` ``device_prefetch`` on the rank's device: the slice is
the rank's batch (a data row's whole images: the warp needs them whole,
and the trainers keep their rows after it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from denoising_diffusion_deep_fake_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The layout of one rank: ``data`` ranks by ``spatial``, this
    process's ``rank`` of ``world``, the process ``group`` (None outside
    one, when every collective is the identity), ``device``, where the
    loop's host numbers travel for a collective, and with ``spatial > 1``
    the ``spatial_group`` of the rank's data row and the ``data_group`` of
    its spatial column."""

    data: int = 1
    spatial: int = 1
    rank: int = 0
    world: int = 1
    group: object = None
    device: torch.device = torch.device("cpu")
    spatial_group: object = None
    data_group: object = None

    @property
    def in_group(self) -> bool:
        return self.group is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def spatial_ranks(self) -> tuple[int, ...]:
        """The global ranks of this rank's data row, in spatial order."""
        first = self.data_index * self.spatial
        return tuple(range(first, first + self.spatial))


def _comm_device() -> torch.device:
    """Where host numbers go for a collective: the rank's GPU under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        from denoising_diffusion_deep_fake_tpu_torch.parallel.distributed \
            import local_device_index
        return torch.device("cuda", local_device_index())
    return torch.device("cpu")


# The sub-groups of each (data, spatial) layout of the open process group:
# every rank creates them once, in the same order (distributed.shutdown
# forgets them).
_SUBGROUPS: dict = {}


def _subgroups(data: int, spatial: int, rank: int) -> tuple:
    """This rank's (spatial group, data group) of the layout."""
    key = (data, spatial)
    if key not in _SUBGROUPS:
        rows = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                for d in range(data)]
        columns = [dist.new_group(list(range(s, data * spatial, spatial)))
                   for s in range(spatial)]
        _SUBGROUPS[key] = rows, columns
    rows, columns = _SUBGROUPS[key]
    return rows[rank // spatial], columns[rank % spatial]


def create_mesh(data_parallel: int | None = None, spatial: int = 1) -> Mesh:
    """The mesh of this process. In a process group of ``world`` ranks the
    data axis is ``world // spatial`` (``data_parallel`` None or equal to
    it); outside one, ``data_parallel`` and ``spatial`` must be None or 1."""
    if spatial <= 0:
        raise ValueError(f"spatial_parallel={spatial} must be positive")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world % spatial:
            raise ValueError(f"spatial_parallel={spatial} does not divide a "
                             f"process group of {world}")
        data = world // spatial
        if data_parallel not in (None, data):
            raise ValueError(f"data_parallel={data_parallel} with "
                             f"spatial_parallel={spatial} in a process group "
                             f"of {world}")
        rank = dist.get_rank()
        spatial_group, data_group = (_subgroups(data, spatial, rank)
                                     if spatial > 1 else
                                     (None, dist.group.WORLD))
        return Mesh(data, spatial, rank, world, dist.group.WORLD,
                    _comm_device(), spatial_group, data_group)
    wanted = (data_parallel or 1) * spatial
    if wanted > 1:
        raise ValueError(
            f"data_parallel={data_parallel}, spatial_parallel={spatial}: a "
            f"PyTorch process drives one device; launch {wanted} processes "
            "with D3F_COORDINATOR, D3F_NUM_PROCESSES and D3F_PROCESS_ID set "
            "(README, PyTorch / H100 port)")
    return Mesh()


def training_mesh(data_parallel: int | None = None,
                  spatial: int = 1) -> Mesh:
    """The mesh every trainer and runner builds from its config knobs: in a
    process group the data axis spans every process over ``spatial``
    whatever ``data_parallel`` says (JAX ``mesh.py:91-92``), else
    ``create_mesh``."""
    if dist.is_available() and dist.is_initialized():
        data_parallel = None
    return create_mesh(data_parallel, spatial)


def config_mesh(cfg) -> Mesh:
    """``training_mesh`` of a config's knobs."""
    return training_mesh(cfg.data_parallel, cfg.spatial_parallel)


def _rows(x, part: int, parts: int, dim: int, what: str):
    if isinstance(x, dict):
        return {k: _rows(v, part, parts, dim, what) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_rows(v, part, parts, dim, what) for v in x)
    if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim <= dim:
        return x
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"{what} of {n} rows over {parts} ranks")
    m = n // parts
    index = [slice(None)] * x.ndim
    index[dim] = slice(part * m, (part + 1) * m)
    return x[tuple(index)]


def shard_batch(global_batch, mesh: Mesh, *, dim: int = 0):
    """This rank's rows of a global batch (a tensor, an array, or dicts and
    lists of them) along ``dim``: its data row's; the batch itself on a
    data axis of 1."""
    if global_batch is None or mesh.data == 1:
        return global_batch
    return _rows(global_batch, mesh.data_index, mesh.data, dim,
                 "global batch")


def shard_rows(images, mesh: Mesh, *, dim: int = 1):
    """This rank's H rows of each image (dim ``dim``, 1 for NHWC) of a
    tensor, an array, or dicts and lists of them, contiguous; the images
    themselves on a spatial axis of 1."""
    if images is None or mesh.spatial == 1:
        return images
    rows = _rows(images, mesh.spatial_index, mesh.spatial, dim, "an image")
    return _contiguous(rows)


def _contiguous(x):
    if isinstance(x, dict):
        return {k: _contiguous(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_contiguous(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.contiguous()
    return np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x


def noise_window(mesh: Mesh, x: torch.Tensor, *,
                 replicated: bool = False) -> dict:
    """The noise kernels' ``element_base`` and ``sample_stride`` for this
    rank's NHWC block ``x`` of the global batch (``ops/cuda/
    noise_kernel.py``): its data row's first image (the batch's first,
    for a batch every data row holds, ``replicated``), its first row, and
    with ``spatial > 1`` the whole image's size from one sample to the
    next."""
    lb, h, w, c = x.shape
    height = h * mesh.spatial
    row = 0 if replicated else mesh.data_index
    return {"element_base": (row * lb * height + mesh.spatial_index * h)
            * w * c,
            "sample_stride": height * w * c if mesh.spatial > 1 else None}


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
