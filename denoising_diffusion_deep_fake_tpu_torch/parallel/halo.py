"""Convolutions and pools over H-sharded rows: the halo geometry, and the
layout of one U-Net forward under ``spatial > 1``.

JAX shards the activations' H over its mesh's ``spatial`` axis and XLA's
partitioner derives each convolution's halo exchange from its padding
(``denoising_diffusion_deep_fake_tpu/parallel/mesh.py:1-16``). The port
has no partitioner: this module works each exchange out from the op's
kernel, stride, padding and dilation, and ``parallel/collectives.py``'s
``exchange_rows`` carries it out.

Geometry. A rank of ``spatial`` ranks holds rows ``a .. a + n - 1`` of the
global H, ``a = s * n``. An op of extent ``e = dilation * (k - 1) + 1``,
stride ``t`` and padding ``p`` along H gives output rows ``a / t .. (a +
n) / t - 1`` (row starts aligned to the stride: ``n % t == 0``), which
read input rows ``a - p`` to ``a + n - t - p + e - 1``: a halo of ``p``
rows above and ``e - t - p`` below (none where that is negative: the
last rows are not read). So a 3x3 conv at stride 1, padding 1 takes 1
and 1, at stride 2 1 and 0, the 7x7 stem at stride 2, padding 3 takes 3
and 2, a 1x1 none, and the stem's 3x3 max pool at stride 2, padding 1, 1
and 0. The op then runs with no H padding on the rows with their halos
(its W padding unchanged). Only the global edges pad: the first rank's
rows above and the last rank's below are zeros for a convolution and
``-inf`` for the max pool (``nn.MaxPool2d``'s implicit padding).

Levels where the rows stop dividing. Every stride-2 step halves a rank's
rows: at 32^2 over 2 ranks the resnet encoder's stride-16 level has one
row a rank, and the stride-2 step after it cannot give each rank whole
output rows. At the first level whose rows are not a multiple of the next
stride (``gather_before_stride``), the rows are gathered over the data
row (``gather_rows``) and the deeper levels run replicated on each of its
ranks; the decoder takes the rank's rows back at the same level
(``take_back``), before it concatenates the skip, which the encoder kept
sharded. Replicated work is not counted S times:

* batch norm at a replicated level reduces over the data group (the
  rank's spatial column, ``data`` ranks) with ``data`` shares, not over
  the world (``batch_norm_group``): every rank of a data row holds the
  same rows;
* in the backward each rank carries only its own rows' loss share
  through the replicated levels, so the gradients there are shares too:
  the world's sum over ``data`` (``all_reduce_grads_``) adds each share
  once, and the gather's backward sums the shares of the gathered
  tensor's gradient before each rank keeps its rows.

The layout is module state, not a context variable: a checkpointed
forward (``remat``) is recomputed by the autograd engine, on the card in
its own thread, and must see the same layout. ``row_sharded(mesh)`` opens
it around a step's forward and backward; ``Unet.forward`` starts each
forward (a recompute included) at ``unet_forward``, sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F

from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    exchange_rows,
    gather_rows,
)


class Halo(NamedTuple):
    """Rows an op reads beyond a rank's own, above and below."""

    above: int
    below: int


def halo_rows(kernel: int, stride: int, padding: int,
              dilation: int = 1) -> Halo:
    """The halo of an op of ``kernel`` taps along H (module docstring)."""
    extent = dilation * (kernel - 1) + 1
    return Halo(padding, max(extent - stride - padding, 0))


@dataclasses.dataclass
class RowLayout:
    """One forward's layout: ``mesh``'s spatial axis shards the rows while
    ``sharded``; after a gather, the whole ``gathered_height`` rows run
    replicated until the decoder takes them back."""

    mesh: object
    sharded: bool = True
    gathered_height: int | None = None


# The mesh that shards the rows (row_sharded) and the forward in progress
# (unet_forward).
_STATE = types.SimpleNamespace(mesh=None, layout=None)


@contextlib.contextmanager
def row_sharded(mesh):
    """Inside, U-Net forwards (and their recomputes) run on this rank's H
    rows over ``mesh``'s spatial axis; nothing changes with ``mesh`` None
    or ``spatial = 1``."""
    if mesh is None or mesh.spatial == 1:
        yield
        return
    previous = _STATE.mesh
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = previous


def sharding_mesh():
    """The mesh ``row_sharded`` opened, or None."""
    return _STATE.mesh


@contextlib.contextmanager
def unet_forward(rows: int):
    """One U-Net forward's layout, sharded at the start (None outside
    ``row_sharded``). ``rows``: the rank's input rows, which the stem's
    stride needs even."""
    mesh = _STATE.mesh
    if mesh is not None and rows % 2:
        raise ValueError(
            f"{rows} image rows a spatial rank: the U-Net's stem halves "
            "them, so image_size / spatial_parallel must be even")
    previous = _STATE.layout
    _STATE.layout = None if mesh is None else RowLayout(mesh)
    try:
        yield _STATE.layout
    finally:
        _STATE.layout = previous


def active() -> RowLayout | None:
    """The layout of the forward in progress while its rows are sharded."""
    layout = _STATE.layout
    return layout if layout is not None and layout.sharded else None


def batch_norm_group():
    """``(group, shares)`` a train-mode batch norm reduces over at a
    replicated level (the data group, ``data`` shares); None elsewhere,
    where it reduces over the world."""
    layout = _STATE.layout
    if layout is None or layout.sharded:
        return None
    return layout.mesh.data_group, layout.mesh.data


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding,
           dilation, groups: int, layout: RowLayout) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` on this rank's rows, halo exchanged."""
    (sh, _), (ph, pw), (dh, _) = map(_pair, (stride, padding, dilation))
    halo = halo_rows(weight.shape[2], sh, ph, dh)
    _check_rows(x, sh)
    x = exchange_rows(x, halo.above, halo.below, layout.mesh, dim=2,
                      pad=0.0)
    return F.conv2d(x, weight, bias, stride, (0, pw), dilation, groups)


def max_pool2d(x: torch.Tensor, kernel, stride, padding,
               layout: RowLayout) -> torch.Tensor:
    """``F.max_pool2d`` of NCHW ``x`` on this rank's rows, the global
    edges padded with ``-inf``."""
    (kh, _), (sh, _), (ph, pw) = map(_pair, (kernel, stride, padding))
    halo = halo_rows(kh, sh, ph)
    _check_rows(x, sh)
    x = exchange_rows(x, halo.above, halo.below, layout.mesh, dim=2,
                      pad=float("-inf"))
    return F.max_pool2d(x, kernel, stride, (0, pw))


def gather_before_stride(y: torch.Tensor, stride: int) -> torch.Tensor:
    """``y`` (NCHW) before an op of ``stride``: as it is, or, where its
    rows are not a multiple of the stride, the whole rows gathered and the
    forward replicated from here (module docstring)."""
    layout = active()
    if layout is None or y.shape[2] % stride == 0:
        return y
    y = gather_rows(y, layout.mesh, dim=2)
    layout.sharded, layout.gathered_height = False, y.shape[2]
    return y


def take_back(y: torch.Tensor) -> torch.Tensor:
    """The decoder's ``y`` (NCHW): at the level the encoder gathered, the
    rank's rows of it, sharded from here; as it is elsewhere."""
    layout = _STATE.layout
    if (layout is None or layout.sharded
            or y.shape[2] != layout.gathered_height):
        return y
    mesh = layout.mesh
    n = y.shape[2] // mesh.spatial
    layout.sharded = True
    return y[:, :, mesh.spatial_index * n:(mesh.spatial_index + 1) * n]


def _pair(v) -> tuple[int, int]:
    """``(H, W)`` of an int or a pair."""
    return (v, v) if isinstance(v, int) else tuple(v)


def _check_rows(x: torch.Tensor, stride: int) -> None:
    if x.shape[2] % stride:
        raise ValueError(f"{x.shape[2]} rows a spatial rank do not divide "
                         f"by the stride {stride}")
