"""Every collective the port issues, in one module.

The JAX package has no counterpart: under ``jit`` over a sharded mesh, XLA
inserts the collectives itself (the gradient all-reduce, batch norm's
cross-device sums), and ``parallel/audit.py`` there finds them in the
compiled HLO. The port issues each one itself, through this module, so
that ``parallel/audit.py`` can count them as they run (``recording``).

Outside a process group every function is the identity and issues
nothing: a one-process run computes exactly what it computed before the
port had data parallelism. Inside a group (at any world size, world size
1 over NCCL included) each call is issued on every rank, in the same
order, on the group of ``mesh`` (``parallel/mesh.py``):

* ``all_reduce_``: the sum over the ranks, in place, which batch norm's
  forward and backward over the global batch issue (``models/resnet.py``,
  the port's own ``torch.autograd.Function``, whose backward carries the
  cross-rank terms);
* ``all_reduce_grads_``: the gradient average of a model, one flat buffer a
  dtype, between the backward and the optimizer step;
* ``mean_metrics``: the metrics of a step averaged over the ranks, in one
  call (the losses of the global batch, the same on every rank);
* ``broadcast_tensors_``: rank 0's tensors to every rank (``shard_state``);
* ``allgather_flags`` and ``broadcast_one``: the training loop's lockstep
  (``training/loop.py``).

NCCL takes only GPU tensors, so the host numbers of the last two travel as
tensors on the mesh's device.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# The census recorders open now (``recording``): lists of (kind, bytes,
# text) to which every call made meanwhile appends itself.
_RECORDERS: list[list] = []


@contextlib.contextmanager
def recording():
    """Collect ``(kind, bytes, text)`` of each collective issued inside, in
    the JAX census's kind names (``all-reduce``, ``all-gather``,
    ``broadcast``)."""
    calls: list = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def _record(kind: str, t: torch.Tensor) -> None:
    for calls in _RECORDERS:
        calls.append((kind, t.numel() * t.element_size(),
                      f"{str(t.dtype).replace('torch.', '')}"
                      f"{list(t.shape)}"))


def group_of(mesh):
    """The process group of ``mesh``; None outside one."""
    return None if mesh is None else mesh.group


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    _record("all-reduce", t)
    dist.all_reduce(t, group=group)
    return t


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, in place (no autograd); ``t``
    outside a group."""
    group = group_of(mesh)
    return t if group is None else _all_reduce(t, group)


def all_reduce_grads_(model: torch.nn.Module, mesh) -> None:
    """Average ``model``'s gradients over the ranks in place: one flat
    buffer a dtype, one all-reduce each. A parameter without a gradient
    gets zeros, so every rank reduces the same buffer."""
    group = group_of(mesh)
    if group is None:
        return
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group_params in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group_params])
        _all_reduce(flat, group)
        flat.div_(mesh.world)
        offset = 0
        for p in group_params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def mean_metrics(metrics: dict, mesh) -> dict:
    """``metrics`` (device scalars) averaged over the ranks in one
    all-reduce; as they are outside a group."""
    group = group_of(mesh)
    if group is None or not metrics:
        return metrics
    names = list(metrics)
    stacked = torch.stack([metrics[n].detach().to(torch.float32)
                           for n in names])
    _all_reduce(stacked, group)
    stacked.div_(mesh.world)
    return {n: stacked[i] for i, n in enumerate(names)}


def broadcast_tensors_(tensors: list[torch.Tensor], mesh,
                       src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` into every rank's, in place:
    one flat buffer a dtype, one broadcast each."""
    group = group_of(mesh)
    if group is None:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _record("broadcast", flat)
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def allgather_flags(flag: bool, mesh) -> list[bool]:
    """Every rank's ``flag``, in rank order; ``[flag]`` outside a group."""
    group = group_of(mesh)
    if group is None:
        return [bool(flag)]
    mine = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    out = [torch.empty_like(mine) for _ in range(mesh.world)]
    _record("all-gather", mine)
    dist.all_gather(out, mine, group=group)
    return [bool(v) for v in torch.cat(out).cpu().tolist()]


def broadcast_one(value: int, mesh, src: int = 0) -> int:
    """Rank ``src``'s integer on every rank; ``value`` outside a group."""
    group = group_of(mesh)
    if group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    _record("broadcast", t)
    dist.broadcast(t, src=src, group=group)
    return int(t.item())
