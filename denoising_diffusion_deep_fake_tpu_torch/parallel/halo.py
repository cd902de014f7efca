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

The other families' ops follow the same rule (``t`` divides ``n``):

* a non-square kernel takes its H extent: a 7x1 conv, padding (3, 0),
  takes 3 and 3, a 1x7 none, a 3x1 1 and 1; a 5x5 "same" conv 2 and 2;
* TF "same" padding (EfficientNet's ``SameConv2d``, ``same_conv2d``) is
  worked out from the GLOBAL extent ``N = n * spatial``: ``p = max((ceil(N
  / t) - 1) * t + k - N, 0)``, ``top = p // 2`` above and ``p - top`` below,
  which for ``t | N`` is ``k - t - top``, the halo's ``below``: 3x3/2 at
  448 pads (0, 1), 5x5/2 at 112 (1, 2), 3x3/1 (1, 1), 5x5/1 (2, 2). The
  rank's own extent would pad every rank's bottom, wrong at each interior
  boundary;
* a ceil-mode max pool with no padding (SENet's stem pool 3/2/0) reads
  rows ``a .. a + n``: a halo of 0 and 1, ``-inf`` beyond the global
  bottom, and the rows need no ceil mode (W keeps it);
* the inceptions' count-excluding 3/1/1 average pool
  (``count_include_pad=False``) takes 1 and 1 rows of zeros, sums the
  window and divides by the taps inside the GLOBAL image (4, 6 or 9),
  from the global row and the column (``avg_pool2d``);
* the 2x2/2 pools (densenet's transitions, vgg) need no halo;
* a spatial mean (squeeze-excite) is the rank's sum summed over its data
  row and divided by the global H x W (``spatial_mean``; the sum is
  ``collectives.spatial_sum``, whose backward sums the gradient over the
  data row in turn).

Levels where the rows stop dividing. Every stride-2 step halves a rank's
rows: at 32^2 over 2 ranks the resnet encoder's stride-16 level has one
row a rank, and the stride-2 step after it cannot give each rank whole
output rows; a halo wider than a rank's rows cannot be exchanged with
one neighbour either. Every encoder calls ``gather_before_stride`` at
each stage entry after the first, before the stage's stride-2 op and
before a block that branches (so parallel branches see one layout),
with its ``reach``: the widest halo its ops read (1 for 3x3 convs; 2
for EfficientNet's 5x5; 3 for the inceptions' 7x1). At the first level
whose rows are not a multiple of the stride, or would leave fewer than
``reach`` rows a rank past it, the rows are gathered over the data row
(``gather_rows``) and the deeper levels run replicated on each of its
ranks; the decoder takes the rank's rows back at the same level
(``take_back``), before it concatenates the skip, which the encoder kept
sharded. At 448^2 nothing is gathered over 2 ranks, and the stride-16
level over 4. Replicated work is not counted S times:

* batch norm at a replicated level reduces over the data group (the
  rank's spatial column, ``data`` ranks) with ``data`` shares, not over
  the world (``batch_norm_group``): every rank of a data row holds the
  same rows;
* a spatial mean at a replicated level is the local mean: the rank holds
  every row;
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
    spatial_sum,
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


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF "same" pads (before, after) of a kxk/s op along an extent n."""
    p = max((-(-n // s) - 1) * s + k - n, 0)
    return p // 2, p - p // 2


def same_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride,
                groups: int, layout: RowLayout) -> torch.Tensor:
    """A TF "same" convolution (no dilation) of NCHW ``x`` on this rank's
    rows: the H pads from the global extent (module docstring), the W pads
    from ``x``'s own."""
    (kh, kw), (sh, sw) = weight.shape[2:], _pair(stride)
    _check_rows(x, sh)
    # With the rows a multiple of the stride the pads are the halo.
    top, bottom = same_pads(x.shape[2] * layout.mesh.spatial, kh, sh)
    x = exchange_rows(x, top, bottom, layout.mesh, dim=2, pad=0.0)
    x = F.pad(x, same_pads(x.shape[3], kw, sw))
    return F.conv2d(x, weight, bias, stride, 0, 1, groups)


def max_pool2d(x: torch.Tensor, kernel, stride, padding,
               layout: RowLayout, ceil_mode: bool = False) -> torch.Tensor:
    """``F.max_pool2d`` of NCHW ``x`` on this rank's rows, the global
    edges padded with ``-inf``; ``ceil_mode`` as the whole op's (with no
    H padding its extra row is the halo below)."""
    (kh, _), (sh, _), (ph, pw) = map(_pair, (kernel, stride, padding))
    halo = halo_rows(kh, sh, ph)
    _check_rows(x, sh)
    x = exchange_rows(x, halo.above, halo.below, layout.mesh, dim=2,
                      pad=float("-inf"))
    return F.max_pool2d(x, kernel, stride, (0, pw), ceil_mode=ceil_mode)


def avg_pool2d(x: torch.Tensor, kernel, stride, padding, layout: RowLayout,
               count_include_pad: bool = True) -> torch.Tensor:
    """``F.avg_pool2d`` of NCHW ``x`` on this rank's rows, zeros at the
    global edges; with ``count_include_pad=False`` each window's sum over
    its taps inside the global image (module docstring)."""
    (kh, kw), (sh, sw), (ph, pw) = map(_pair, (kernel, stride, padding))
    halo = halo_rows(kh, sh, ph)
    _check_rows(x, sh)
    n = x.shape[2]
    x = exchange_rows(x, halo.above, halo.below, layout.mesh, dim=2,
                      pad=0.0)
    if count_include_pad:
        return F.avg_pool2d(x, kernel, stride, (0, pw))
    total = F.avg_pool2d(x, kernel, stride, (0, pw), divisor_override=1)
    first = layout.mesh.spatial_index * n // sh
    rows = _taps(first, total.shape[2], sh, kh, ph,
                 n * layout.mesh.spatial)
    cols = _taps(0, total.shape[3], sw, kw, pw, x.shape[3])
    return total / (rows[:, None] * cols[None, :]).to(total)


def _taps(first: int, count: int, stride: int, kernel: int, padding: int,
          extent: int) -> torch.Tensor:
    """How many taps of each of ``count`` windows, the first at output
    index ``first``, fall inside ``0 .. extent - 1``."""
    start = torch.arange(first, first + count) * stride - padding
    return ((start + kernel).clamp(max=extent) - start.clamp(min=0)).double()


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean((2, 3), keepdim=True)`` of NCHW ``x``; on a rank's rows
    the rank's sum (in fp32, float64 for float64), summed over its data
    row and divided by the global H x W, in ``x``'s dtype."""
    layout = active()
    if layout is None:
        return x.mean((2, 3), keepdim=True)
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    total = spatial_sum(acc.sum((2, 3), keepdim=True), layout.mesh)
    size = x.shape[2] * layout.mesh.spatial * x.shape[3]
    return (total / size).to(x.dtype)


def gather_before_stride(y: torch.Tensor, stride: int,
                         reach: int = 1) -> torch.Tensor:
    """``y`` (NCHW) before an op of ``stride``: as it is, or, where its
    rows are not a multiple of the stride or would leave fewer than
    ``reach`` rows a rank past it (the widest halo the encoder reads), the
    whole rows gathered and the forward replicated from here (module
    docstring)."""
    layout = active()
    rows = y.shape[2]
    if layout is None or (rows % stride == 0 and rows // stride >= reach):
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
