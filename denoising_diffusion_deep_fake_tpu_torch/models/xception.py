"""The Xception encoder with pretrainedmodels topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/xception.py``: smp's
``xception`` (Cadene's pretrainedmodels aligned Xception) staged as smp's
``XceptionEncoder``:

    stage 0: the raw input
    stage 1: conv1/bn1/relu + conv2/bn2/relu                   @ 1/2, 64
    stage 2: block1                                            @ 1/4, 128
    stage 3: block2                                            @ 1/8, 256
    stage 4: block3 .. block11                                 @ 1/16, 728
    stage 5: block12 + conv3/bn3/relu + conv4/bn4              @ 1/32, 2048

* smp sets ``conv1`` and ``conv2`` to padding 1 (Cadene's are pad 0);
* ``SeparableConv2d`` is a depthwise 3x3 (``conv1``) and a pointwise 1x1
  (``pointwise``), both without bias;
* a ``Block``'s ``rep`` Sequential is built in Cadene's order, and
  ``start_with_relu=False`` (block1) drops its leading ReLU, shifting every
  index after it (``block_rep_layout``); a stride-2 block ends with
  ``MaxPool2d(3, 2, 1)`` and takes a 1x1/2 conv + BN skip (``skip``,
  ``skipbn``), a stride-1 block with equal widths the identity;
* the deepest stage ends at ``bn4`` with no ReLU (``Xception.features``);
* init (``models/unet.py``): N(0, sqrt(2 / (k * k * out))) whatever the
  groups, which is kaiming-normal fan-out.

On a spatial rank's rows (``parallel/halo.py``) the blocks' max pools go
through ``halo`` (the port's ``MaxPool2d``), and the encoder gathers its
rows before each stride-2 block (block1, 2, 3 and 12: ``rep`` and
``skip`` see one layout) where they stop dividing.

The classifier ``fc`` is left out, as smp leaves it; module names are
Cadene's, so the state_dict has smp's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    MaxPool2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo

# (cin, cout, reps, stride, start_with_relu, grow_first) of block1..block12.
_XCEPTION_BLOCKS = (
    (64, 128, 2, 2, False, True),
    (128, 256, 2, 2, True, True),
    (256, 728, 2, 2, True, True),
    *(((728, 728, 3, 1, True, True),) * 8),     # block4..block11
    (728, 1024, 2, 2, True, False),             # block12 (grow_first=False)
)


def block_rep_layout(cin: int, cout: int, reps: int, *,
                     start_with_relu: bool = True, grow_first: bool = True,
                     stride: int = 1) -> list[tuple]:
    """The ``Block.rep`` Sequential as (index, (kind, *args)), in Cadene's
    order: kinds ("relu",), ("sep", cin, cout), ("bn", ch), ("pool",)."""
    ops: list[tuple] = []
    if grow_first:
        ops += [("relu",), ("sep", cin, cout), ("bn", cout)]
        filters = cout
    else:
        filters = cin
    for _ in range(reps - 1):
        ops += [("relu",), ("sep", filters, filters), ("bn", filters)]
    if not grow_first:
        ops += [("relu",), ("sep", cin, cout), ("bn", cout)]
    if not start_with_relu:
        ops = ops[1:]
    indexed = list(enumerate(ops))
    if stride != 1:
        indexed.append((len(ops), ("pool",)))
    return indexed


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (``conv1``) then pointwise 1x1, both without bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cin, 3, 1, 1, groups=cin, bias=False)
        self.pointwise = Conv2d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.conv1(x))


class XceptionBlock(nn.Module):
    """Cadene ``Block``: the ``rep`` Sequential plus a conv or identity
    skip."""

    def __init__(self, cin: int, cout: int, reps: int, stride: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True):
        super().__init__()
        rep = []
        for _, (kind, *args) in block_rep_layout(
                cin, cout, reps, start_with_relu=start_with_relu,
                grow_first=grow_first, stride=stride):
            if kind == "relu":
                # Not in place: the block's input also feeds the skip.
                rep.append(nn.ReLU())
            elif kind == "sep":
                rep.append(SeparableConv2d(*args))
            elif kind == "bn":
                rep.append(BatchNorm2d(*args))
            else:
                rep.append(MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)
        self.stride = stride
        self.skip = self.skipbn = None
        if stride != 1 or cin != cout:
            self.skip = Conv2d(cin, cout, 1, stride, bias=False)
            self.skipbn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class XceptionEncoder(nn.Module):
    """Feature-pyramid Xception encoder (smp ``XceptionEncoder``)."""

    conv_init = "fan_out"

    def __init__(self, encoder_name: str = "xception", in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = Conv2d(in_channels, 32, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(32)
        self.conv2 = Conv2d(32, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        for i, args in enumerate(_XCEPTION_BLOCKS, start=1):
            setattr(self, f"block{i}", XceptionBlock(*args))
        self.conv3 = SeparableConv2d(1024, 1536)
        self.bn3 = BatchNorm2d(1536)
        self.conv4 = SeparableConv2d(1536, 2048)
        self.bn4 = BatchNorm2d(2048)

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, 64, 128, 256, 728, 2048)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        features.append(y)
        for i in range(1, 13):
            block = getattr(self, f"block{i}")
            if block.stride == 2:
                y = halo.gather_before_stride(y, 2)
            y = block(y)
            if i in (1, 2, 11):
                features.append(y)
        y = F.relu(self.bn3(self.conv3(y)))
        features.append(self.bn4(self.conv4(y)))
        return features
