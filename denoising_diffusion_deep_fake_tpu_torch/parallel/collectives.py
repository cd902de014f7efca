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
* ``all_reduce_grads_``: a model's gradients summed over the ranks and
  divided by the data axis, one flat buffer a dtype, between the backward
  and the optimizer step;
* ``mean_metrics``: the metrics of a step summed over the ranks and
  divided by the data axis, in one call (the losses of the global batch,
  the same on every rank);
* ``broadcast_tensors_``: rank 0's tensors to every rank (``shard_state``);
* ``allgather_flags`` and ``broadcast_one``: the training loop's lockstep
  (``training/loop.py``).

With ``spatial > 1`` (``parallel/mesh.py``; the geometry is
``parallel/halo.py``'s) a rank holds H rows of its data row's images, and
these join the ranks of a data row:

* ``exchange_rows``: the halo exchange, a ``torch.autograd.Function``. Its
  forward sends the rank's top and bottom boundary rows to the neighbours
  above and below and receives theirs (the global edges take padding, or
  nothing); its backward sends the gradients of the rows it received back
  to their owners and adds the ones it gets into its boundary rows.
  Recorded as ``collective-permute``, JAX's name for the exchanges XLA
  derives from a convolution's padding;
* ``gather_rows``: the rows of the whole image on every rank of the data
  row (an all-gather; its backward sums the gradient over the data row
  and keeps the rank's rows), where the U-Net's rows stop dividing;
* ``spatial_all_reduce_``: a sum over the data row (the balancer's
  per-image scores).

The gradient rule: a rank's loss is its rows' share of its data row's loss
(``ops/losses.py``: sums over global counts, so the shares of a data row
add up to its loss) and every cross-rank term of the backward travels
through the exchanges and batch norm's sums, so a rank's gradients are its
rows' share of its data row's. Summed over the world and divided by the
data axis, they are the global batch's mean gradient; with ``spatial = 1``
that is the data-parallel average, the same division. The metrics are
shares alike.

Transport: NCCL sends the halos with ``batch_isend_irecv`` and gathers on
the card. Gloo has no point-to-point and no all-gather on CUDA tensors, so
under gloo the halo and gather buffers go through the host as raw bytes:
that staging is gloo's transport, not a fallback (the census text says
``via host``). A failed exchange raises.

NCCL takes only GPU tensors, so the host numbers of the lockstep travel
as tensors on the mesh's device.
"""

from __future__ import annotations

import contextlib
import math

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


def _record(kind: str, t: torch.Tensor, via: str = "") -> None:
    for calls in _RECORDERS:
        calls.append((kind, t.numel() * t.element_size(),
                      f"{str(t.dtype).replace('torch.', '')}"
                      f"{list(t.shape)}{via}"))


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
    return group_all_reduce_(t, group_of(mesh))


def group_all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the process ``group``, in place
    (no autograd); ``t`` for None."""
    return t if group is None else _all_reduce(t, group)


def all_reduce_grads_(model: torch.nn.Module, mesh) -> None:
    """``model``'s gradients summed over the ranks and divided by the data
    axis (the module docstring's rule), in place: one flat buffer a
    dtype, one all-reduce each. A parameter without a gradient gets
    zeros, so every rank reduces the same buffer."""
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
        flat.div_(mesh.data)
        offset = 0
        for p in group_params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def mean_metrics(metrics: dict, mesh) -> dict:
    """``metrics`` (device scalars, each a rank's share of its data row's
    value) summed over the ranks and divided by the data axis in one
    all-reduce: the global batch's means, on every rank; as they are
    outside a group."""
    group = group_of(mesh)
    if group is None or not metrics:
        return metrics
    names = list(metrics)
    stacked = torch.stack([metrics[n].detach().to(torch.float32)
                           for n in names])
    _all_reduce(stacked, group)
    stacked.div_(mesh.data)
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


# ------------------------------------------------------- the spatial axis


def spatial_all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks of this rank's data row, in place
    (no autograd); ``t`` on a spatial axis of 1."""
    if mesh is None or mesh.spatial == 1:
        return t
    return _all_reduce(t, mesh.spatial_group)


def _over_gloo() -> bool:
    return dist.get_backend() != "nccl"


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` as flat bytes (gloo's transport)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.view(like.dtype).reshape(shape).to(like.device)


def _wait(reqs, what: str) -> None:
    for req in reqs:
        try:
            req.wait()
        except RuntimeError as e:
            raise RuntimeError(f"{what} failed: {e}") from e


def _permute(mesh, x: torch.Tensor, sends: list, recvs: list) -> list:
    """One round of point-to-point: ``sends`` are ``(tensor, spatial
    index)``, ``recvs`` ``(shape, spatial index)`` of tensors like ``x``;
    returns the received tensors, contiguous."""
    ranks = mesh.spatial_ranks
    gloo = _over_gloo()
    for t, _ in sends:
        _record("collective-permute", t, " via host" if gloo else "")
    if not gloo:
        outs = [torch.empty(shape, dtype=x.dtype, device=x.device)
                for shape, _ in recvs]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), ranks[p])
                for t, p in sends]
               + [dist.P2POp(dist.irecv, o, ranks[p])
                  for o, (_, p) in zip(outs, recvs)])
        if ops:
            _wait(dist.batch_isend_irecv(ops), "a halo exchange")
        return outs
    host = [torch.empty(math.prod(shape) * x.element_size(),
                        dtype=torch.uint8) for shape, _ in recvs]
    reqs = ([dist.isend(_as_bytes(t), ranks[p]) for t, p in sends]
            + [dist.irecv(b, ranks[p]) for b, (_, p) in zip(host, recvs)])
    _wait(reqs, "a halo exchange")
    return [_from_bytes(b, x, shape) for b, (shape, _) in zip(host, recvs)]


def _rows_shape(x: torch.Tensor, dim: int, n: int) -> list:
    shape = list(x.shape)
    shape[dim] = n
    return shape


def _assemble(x: torch.Tensor, dim: int, parts: list) -> torch.Tensor:
    """``parts`` (tensors, or None) concatenated along ``dim`` in ``x``'s
    memory format (channels_last stays channels_last)."""
    parts = [t for t in parts if t is not None and t.shape[dim]]
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty(_rows_shape(x, dim, sum(t.shape[dim] for t in parts)),
                      dtype=x.dtype, device=x.device, memory_format=fmt)
    at = 0
    for t in parts:
        out.narrow(dim, at, t.shape[dim]).copy_(t)
        at += t.shape[dim]
    return out


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, mesh, dim, pad):
        s, last = mesh.spatial_index, mesh.spatial - 1
        n = x.shape[dim]
        if above > n or below > n:
            raise ValueError(
                f"a halo of {above} rows above and {below} below needs as "
                f"many rows on each spatial rank, which holds {n}: fewer "
                "spatial ranks, or a larger image")
        sends, recvs = [], []
        if s > 0 and below:
            sends.append((x.narrow(dim, 0, below), s - 1))
        if s < last and above:
            sends.append((x.narrow(dim, n - above, above), s + 1))
        if s > 0 and above:
            recvs.append((_rows_shape(x, dim, above), s - 1))
        if s < last and below:
            recvs.append((_rows_shape(x, dim, below), s + 1))
        got = iter(_permute(mesh, x, sends, recvs))
        top = next(got) if s > 0 and above else None
        bottom = next(got) if s < last and below else None
        if pad is not None:
            if top is None and above:
                top = x.new_full(_rows_shape(x, dim, above), pad)
            if bottom is None and below:
                bottom = x.new_full(_rows_shape(x, dim, below), pad)
        ctx.rows = (0 if top is None else above, n,
                    0 if bottom is None else below)
        ctx.geometry = (above, below, mesh, dim)
        return _assemble(x, dim, [top, x, bottom])

    @staticmethod
    def backward(ctx, grad):
        above, below, mesh, dim = ctx.geometry
        n_top, n, n_bottom = ctx.rows
        s, last = mesh.spatial_index, mesh.spatial - 1
        dx = _assemble(grad, dim, [grad.narrow(dim, n_top, n)])
        sends, recvs = [], []
        if s > 0 and above:
            sends.append((grad.narrow(dim, 0, above), s - 1))
        if s < last and below:
            sends.append((grad.narrow(dim, n_top + n, below), s + 1))
        if s > 0 and below:
            recvs.append((_rows_shape(grad, dim, below), s - 1))
        if s < last and above:
            recvs.append((_rows_shape(grad, dim, above), s + 1))
        got = iter(_permute(mesh, grad, sends, recvs))
        if s > 0 and below:
            dx.narrow(dim, 0, below).add_(next(got))
        if s < last and above:
            dx.narrow(dim, n - above, above).add_(next(got))
        return dx, None, None, None, None, None


def exchange_rows(x: torch.Tensor, above: int, below: int, mesh, *,
                  dim: int, pad: float | None) -> torch.Tensor:
    """``x`` (this rank's rows along ``dim``) with ``above`` rows of the
    rank above it and ``below`` rows of the rank below it around it; at
    the global edges ``pad``-filled rows, or none when ``pad`` is None.
    Differentiable (the module docstring)."""
    if mesh is None or mesh.spatial == 1 or not (above or below):
        return x
    return _ExchangeRows.apply(x, above, below, mesh, dim, pad)


def _gather(x: torch.Tensor, mesh) -> list:
    _record("all-gather", x, " via host" if _over_gloo() else "")
    group = mesh.spatial_group
    if not _over_gloo():
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(mesh.spatial)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return parts
    mine = _as_bytes(x)
    parts = [torch.empty_like(mine) for _ in range(mesh.spatial)]
    dist.all_gather(parts, mine, group=group)
    return [_from_bytes(b, x, x.shape) for b in parts]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.geometry = (mesh, dim, x.shape[dim])
        return _assemble(x, dim, _gather(x, mesh))

    @staticmethod
    def backward(ctx, grad):
        mesh, dim, n = ctx.geometry
        total = grad.contiguous()
        if _over_gloo():
            host = total.cpu().to(torch.promote_types(total.dtype,
                                                      torch.float32))
            _all_reduce(host, mesh.spatial_group)
            total = host.to(grad.device, grad.dtype)
        else:
            _all_reduce(total, mesh.spatial_group)
        mine = total.narrow(dim, mesh.spatial_index * n, n)
        return _assemble(grad, dim, [mine]), None, None


def gather_rows(x: torch.Tensor, mesh, *, dim: int) -> torch.Tensor:
    """The whole images' rows along ``dim`` on every rank of this rank's
    data row, from each rank's ``x``. Differentiable: the gradient of the
    whole is summed over the data row and the rank keeps its rows."""
    if mesh is None or mesh.spatial == 1:
        return x
    return _GatherRows.apply(x, mesh, dim)
