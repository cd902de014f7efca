"""EfficientNet-b0..b7 encoders with efficientnet-pytorch topology and flax
numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/efficientnet.py``:
smp's ``efficientnet-b{0..7}`` (lukemelas/EfficientNet-PyTorch), six
levels ``[x, stem, s2, s3, s4, s5]`` at strides (1, 2, 4, 8, 16, 32), the
stage taps at smp's published ``stage_idxs`` (``_SMP_STAGE_IDXS``: b0 taps
the 1/16 level after the first 112-channel block, not at the cumulative
boundary).

* stem: conv 3x3/2 (TF "same" padding) -> BN -> swish;
* MBConv: [1x1 expand conv + BN + swish when the expand ratio is not 1]
  -> depthwise kxk conv (``groups=hidden``, stride s, "same" padding) + BN
  + swish -> squeeze-excite (spatial mean -> ``_se_reduce`` 1x1 with bias,
  width ``max(1, int(cin * 0.25))`` of the block input -> swish ->
  ``_se_expand`` 1x1 with bias -> sigmoid gate) -> 1x1 ``_project_conv`` +
  BN; the residual add when the stride is 1 and the channels match;
* TF "same" padding from the tensor's own extent at the call, as JAX takes
  it from the static shape: at stride 2 it is asymmetric (one more pixel
  after than before), an explicit ``F.pad`` before a conv with no padding;
* BN eps 1e-3, running statistics with flax momentum 0.99 (torch's 0.01);
* every conv keeps torch's default init (``conv_init = "torch"``:
  kaiming-uniform(a=sqrt(5)) weights, uniform(+-1/sqrt(fan_in)) biases).

Stochastic depth (drop-connect): a residual block ``idx`` of ``n`` with
``rate = 0.2 * idx / n > 0`` multiplies its branch by ``mask / keep``
(``keep = 1 - rate``), one mask element a sample, the scale formed in the
compute dtype as JAX's ``y * (mask.astype(y.dtype) / keep)`` (in bf16,
``1 / keep`` rounds in bf16). The encoder draws nothing: the masks are an
argument of ``forward``, an ``(n_drop_blocks, B)`` tensor in block order
(``drops`` gives each such block's index and keep probability in the
same order), or None for no drop. So a recompute of the forward (the
``remat`` policies) and a CUDA-graph replay see the masks the step drew.

On a spatial rank's rows (``parallel/halo.py``) the "same" pads come
from the global extent (``halo.same_conv2d``), the squeeze-excite mean is
summed over the data row (``halo.spatial_mean``), and the encoder gathers
its rows before a stage's stride-2 block where they stop dividing or
would leave fewer than 2 a rank (the 5x5 depthwise convs' halo;
``HALO_REACH``).

The classifier head (``_conv_head``, ``_bn1``, ``_fc``) is left out, as
smp never runs it and the JAX encoder has none. Module names are
efficientnet-pytorch's (``_conv_stem``, ``_bn0``, ``_blocks.{i}.
_expand_conv`` ...), so the state_dict has smp's keys.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
from denoising_diffusion_deep_fake_tpu_torch.parallel.halo import (
    same_pads as _same_pads,
)

# (repeats, kernel, stride, expand_ratio, in_filters, out_filters) at b0
# scale; se_ratio 0.25 throughout (the EfficientNet base block args).
_BASE_BLOCKS = (
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
)

# name -> (width_coefficient, depth_coefficient)
EFFICIENTNET_SPECS = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}

_DROP_CONNECT_RATE = 0.2  # efficientnet-pytorch GlobalParams default
# The widest halo of the encoder's convolutions (a 5x5 "same" conv reads 2
# rows beyond a rank's): a spatial rank keeps at least as many rows.
HALO_REACH = 2

# smp's efficient_net_encoders stage_idxs (the 1/4, 1/8, 1/16 taps).
_SMP_STAGE_IDXS = {
    "efficientnet-b0": (3, 5, 9),
    "efficientnet-b1": (5, 8, 16),
    "efficientnet-b2": (5, 8, 16),
    "efficientnet-b3": (5, 8, 18),
    "efficientnet-b4": (6, 10, 22),
    "efficientnet-b5": (8, 13, 27),
    "efficientnet-b6": (9, 15, 31),
    "efficientnet-b7": (11, 18, 38),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """EfficientNet width scaling (efficientnet-pytorch round_filters)."""
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def block_layout(encoder_name: str) -> list[dict]:
    """Per-block (kernel, stride, expand, cin, cout) after compound
    scaling."""
    width, depth = EFFICIENTNET_SPECS[encoder_name]
    blocks = []
    for repeats, k, s, e, cin, cout in _BASE_BLOCKS:
        cin, cout = round_filters(cin, width), round_filters(cout, width)
        for j in range(round_repeats(repeats, depth)):
            blocks.append(dict(kernel=k, stride=s if j == 0 else 1,
                               expand=e, cin=cin if j == 0 else cout,
                               cout=cout))
    return blocks


@functools.lru_cache(maxsize=None)
def drop_blocks(encoder_name: str) -> tuple[tuple[int, float], ...]:
    """``(block index, keep probability)`` of each block that drops, in
    block order: the residual blocks whose drop-connect rate (0.2 x index
    / blocks, smp's forward) is above 0."""
    blocks = block_layout(encoder_name)
    out = []
    for idx, spec in enumerate(blocks):
        rate = _DROP_CONNECT_RATE * idx / len(blocks)
        if rate > 0 and spec["stride"] == 1 and spec["cin"] == spec["cout"]:
            out.append((idx, 1.0 - rate))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _drop_scale(keep: float, dtype: torch.dtype) -> float:
    """``1 / keep`` as JAX's ``mask.astype(dtype) / keep`` forms it: keep
    rounded to ``dtype`` (a weakly typed scalar), the quotient too."""
    return float(torch.ones((), dtype=dtype)
                 / torch.tensor(keep, dtype=dtype))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class SameConv2d(Conv2d):
    """A conv with TF "same" padding from the input's own extent: given to
    the conv where it is symmetric, an explicit ``F.pad`` where it is not
    (efficientnet-pytorch's Conv2dStaticSamePadding); on a rank's rows
    from the global extent (``halo.same_conv2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        layout = halo.active()
        if layout is not None:
            return halo.same_conv2d(x, self.weight.to(x.dtype), bias,
                                    self.stride, self.groups, layout)
        (k, _), (s, _) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[2], k, s)
        left, right = _same_pads(x.shape[3], k, s)
        padding = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        padding, self.dilation, self.groups)


def _bn(channels: int) -> BatchNorm2d:
    # efficientnet-pytorch: momentum 0.01 (torch) == 0.99 (flax), eps 1e-3.
    return BatchNorm2d(channels, eps=1e-3, momentum=0.99)


class MBConvBlock(nn.Module):
    """efficientnet-pytorch's MBConvBlock (its module names)."""

    def __init__(self, kernel: int, stride: int, expand: int, cin: int,
                 cout: int):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self._expand_conv = Conv2d(cin, hidden, 1, bias=False)
            self._bn0 = _bn(hidden)
        self._depthwise_conv = SameConv2d(hidden, hidden, kernel, stride,
                                          groups=hidden, bias=False)
        self._bn1 = _bn(hidden)
        se_ch = max(1, int(cin * 0.25))
        self._se_reduce = Conv2d(hidden, se_ch, 1)
        self._se_expand = Conv2d(se_ch, hidden, 1)
        self._project_conv = Conv2d(hidden, cout, 1, bias=False)
        self._bn2 = _bn(cout)
        self.expand = expand
        self.stride = stride
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                keep: float = 1.0) -> torch.Tensor:
        y = x
        if self.expand != 1:
            y = swish(self._bn0(self._expand_conv(y)))
        y = swish(self._bn1(self._depthwise_conv(y)))
        se = halo.spatial_mean(y)
        se = self._se_expand(swish(self._se_reduce(se)))
        y = y * torch.sigmoid(se)
        y = self._bn2(self._project_conv(y))
        if not self.residual:
            return y
        if mask is not None:
            y = y * (mask.reshape(-1, 1, 1, 1).to(y.dtype)
                     * _drop_scale(keep, y.dtype))
        return y + x


class EfficientNetEncoder(nn.Module):
    """Feature-pyramid EfficientNet encoder (smp get_stages semantics)."""

    conv_init = "torch"

    def __init__(self, encoder_name: str = "efficientnet-b0",
                 in_channels: int = 3):
        super().__init__()
        self.encoder_name = encoder_name
        self.in_channels = in_channels
        width, _ = EFFICIENTNET_SPECS[encoder_name]
        stem = round_filters(32, width)
        self._conv_stem = SameConv2d(in_channels, stem, 3, 2, bias=False)
        self._bn0 = _bn(stem)
        layout = block_layout(encoder_name)
        self._blocks = nn.ModuleList(MBConvBlock(**spec) for spec in layout)
        self.taps = _SMP_STAGE_IDXS[encoder_name]
        # (block index, keep probability) of each block that drops, in
        # the order of forward's drop_masks.
        self.drops = drop_blocks(encoder_name)

    @property
    def out_channels(self) -> tuple[int, ...]:
        width, _ = EFFICIENTNET_SPECS[self.encoder_name]
        return (self.in_channels,) + tuple(
            round_filters(c, width) for c in (32, 24, 40, 112, 320))

    def forward(self, x: torch.Tensor,
                drop_masks: torch.Tensor | None = None
                ) -> list[torch.Tensor]:
        if drop_masks is not None and drop_masks.shape[0] != len(self.drops):
            raise ValueError(
                f"{self.encoder_name} has {len(self.drops)} blocks that "
                f"drop; got {drop_masks.shape[0]} masks")
        masks = {}
        if drop_masks is not None:
            masks = {idx: (drop_masks[j], keep)
                     for j, (idx, keep) in enumerate(self.drops)}
        features = [x]
        y = swish(self._bn0(self._conv_stem(x)))
        features.append(y)
        for idx, block in enumerate(self._blocks):
            if block.stride == 2:
                y = halo.gather_before_stride(y, 2, HALO_REACH)
            y = block(y, *masks.get(idx, ()))
            if idx + 1 in self.taps:
                features.append(y)
        features.append(y)
        return features
