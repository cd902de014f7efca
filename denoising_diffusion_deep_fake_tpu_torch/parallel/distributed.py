"""Multi-process runtime: the process group, its ranks, the batch split.

Port of ``denoising_diffusion_deep_fake_tpu/parallel/distributed.py``. The
JAX package runs one program per host over ``jax.distributed``; the port
runs one process per device over ``torch.distributed``, wired together by
the same launch (one command per process, the same everywhere but the
rank):

    D3F_COORDINATOR=host0:1234 D3F_NUM_PROCESSES=4 D3F_PROCESS_ID=$RANK \\
        python -m denoising_diffusion_deep_fake_tpu_torch.main train new ...

``initialize`` opens the default process group on a store at the
coordinator (a ``TCPStore`` that process 0 serves at ``host:port``, or a
``FileStore`` for a ``file://`` path, which the tests use so that parallel
test workers never race for a port). The backend is NCCL when the
process's device is a GPU and gloo on the CPU; ``backend="gloo"`` on GPU
tensors puts several processes on one card, where NCCL refuses a second
rank ("Duplicate GPU detected"). Process ``p`` drives
``cuda:{p % device_count}`` (``device.resolve_device`` reads the rank).

Batch-size convention, as JAX's: a config's ``batch_size`` is the GLOBAL
batch; each process loads ``batch_size // process_count()`` images a step
from its shard of the manifest (``data_shard``). JAX assembles the global
array from each process's slice (``global_batch_from_local``); the port has
no such step: a process's local batch already is its shard of the global
batch, and the collectives (``parallel/collectives.py``) join the ranks.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "D3F_COORDINATOR"
ENV_NUM_PROCESSES = "D3F_NUM_PROCESSES"
ENV_PROCESS_ID = "D3F_PROCESS_ID"
TIMEOUT = datetime.timedelta(minutes=10)


def _store(coordinator: str, num_processes: int, process_id: int):
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port or "
                         f"file://path, got {coordinator!r}")
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0, timeout=TIMEOUT)


def default_backend(device=None) -> str:
    """``nccl`` for a GPU process (``device`` None on a machine with one,
    or a CUDA device), ``gloo`` otherwise."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, backend: str | None = None,
               device=None) -> None:
    """Open the default process group (idempotent: a second call while one
    is open does nothing). ``backend`` None picks ``default_backend(
    device)``. On a machine with a GPU the process selects
    ``cuda:{process_id % device_count}`` as its current device."""
    if dist.is_initialized():
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    backend = backend or default_backend(device)
    if torch.cuda.is_available() and torch.device(
            device or "cuda").type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=_store(coordinator_address, num_processes, process_id),
        rank=process_id, world_size=num_processes, timeout=TIMEOUT)


def shutdown() -> None:
    """Close the default process group, if one is open."""
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_from_env(*, device=None,
                              backend: str | None = None) -> bool:
    """Open the process group iff the ``D3F_*`` launch environment is set.

    Called at the top of every runner: a no-op for the one-process case.
    """
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    num = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)
    if num is None or pid is None:
        raise ValueError(
            f"{ENV_COORDINATOR} is set but {ENV_NUM_PROCESSES}/"
            f"{ENV_PROCESS_ID} are not — set all three (or none)")
    initialize(coordinator, int(num), int(pid), backend=backend,
               device=device)
    return True


def in_group() -> bool:
    """Is a process group open (at any world size)?"""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def process_index() -> int:
    return dist.get_rank() if in_group() else 0


def is_primary() -> bool:
    """True on the process that owns logging, manifests and checkpoints."""
    return process_index() == 0


def local_device_index() -> int:
    """The CUDA device index of this process: its rank modulo the cards."""
    return process_index() % max(torch.cuda.device_count(), 1)


def local_batch_size(global_batch_size: int) -> int:
    """Per-process share of the global batch (must divide evenly)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch_size {global_batch_size} must be divisible by "
            f"process_count {n}")
    return global_batch_size // n


def data_shard() -> tuple[int, int] | None:
    """(process_index, process_count) for ImageLoader sharding; None if 1."""
    n = process_count()
    return (process_index(), n) if n > 1 else None


def fetch_local(tree):
    """A tree (dicts, lists, tuples) with every tensor as host numpy: this
    process's own values (its rows of a batch, its copy of the state)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: fetch_local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_local(v) for v in tree)
    return np.asarray(tree) if isinstance(tree, np.generic) else tree
