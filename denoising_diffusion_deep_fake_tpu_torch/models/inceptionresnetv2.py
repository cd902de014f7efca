"""The Inception-ResNet-v2 encoder with pretrainedmodels topology and flax
numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/inceptionresnetv2.py``:
smp's ``inceptionresnetv2`` (Cadene's pretrainedmodels) staged with
channels (3, 64, 192, 320, 1088, 1536):

    stage 1: conv2d_1a + conv2d_2a + conv2d_2b                 @ 1/2, 64
    stage 2: maxpool_3a + conv2d_3b + conv2d_4a                @ 1/4, 192
    stage 3: maxpool_5a + mixed_5b + repeat (10 block35)       @ 1/8, 320
    stage 4: mixed_6a + repeat_1 (20 block17)                  @ 1/16, 1088
    stage 5: mixed_7a + repeat_2 (9 block8) + block8 + conv2d_7b  @ 1/32

* smp pads every 3x3 conv and every max-pool by 1, as for inceptionv4
  (the 5x5 keeps pad 2, the (1,7)/(7,1)/(1,3)/(3,1) convs their own);
* ``BasicConv2d`` is inceptionv4's (BN eps 1e-3);
* a residual block's up-projection ``conv2d`` is a plain 1x1 conv with a
  bias and no BN; the block returns ``relu(x + scale * conv2d(cat))``,
  scale 0.17 (block35), 0.10 (block17), 0.20 (repeat_2's block8), and
  the last ``block8`` scale 1.0 with no ReLU;
* init (``models/unet.py``): torch's defaults, kaiming-uniform(a=sqrt(5))
  weights and uniform(+-1/sqrt(fan_in)) ``conv2d`` biases.

On a spatial rank's rows it is inceptionv4's (``HALO_REACH`` 3: the
block17 7x1 convs), the gathers before ``maxpool_3a``, ``maxpool_5a``,
``mixed_6a`` and ``mixed_7a``.

The classifier is left out, as smp leaves it; module names are Cadene's,
so the state_dict has smp's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.inceptionv4 import (
    HALO_REACH,
    AvgPoolValid,
    BasicConv2d,
    maxpool_3x3_s2,
)
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import Conv2d
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo


def _gathered(y: torch.Tensor) -> torch.Tensor:
    return halo.gather_before_stride(y, 2, HALO_REACH)


class ResidualBlock(nn.Module):
    """Cadene Block35 / Block17 / Block8."""

    def __init__(self, kind: str, scale: float, relu: bool = True):
        super().__init__()
        self.scale, self.relu = scale, relu
        B, S = BasicConv2d, nn.Sequential
        if kind == "block35":
            self.branch0 = B(320, 32)
            self.branch1 = S(B(320, 32), B(32, 32, 3, 1, 1))
            self.branch2 = S(B(320, 32), B(32, 48, 3, 1, 1),
                             B(48, 64, 3, 1, 1))
            self.conv2d = Conv2d(128, 320, 1)
        elif kind == "block17":
            self.branch0 = B(1088, 192)
            self.branch1 = S(B(1088, 128), B(128, 160, (1, 7), 1, (0, 3)),
                             B(160, 192, (7, 1), 1, (3, 0)))
            self.conv2d = Conv2d(384, 1088, 1)
        else:
            self.branch0 = B(2080, 192)
            self.branch1 = S(B(2080, 192), B(192, 224, (1, 3), 1, (0, 1)),
                             B(224, 256, (3, 1), 1, (1, 0)))
            self.conv2d = Conv2d(448, 2080, 1)
        self.has_branch2 = kind == "block35"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0(x), self.branch1(x)]
        if self.has_branch2:
            outs.append(self.branch2(x))
        y = x + self.scale * self.conv2d(torch.cat(outs, dim=1))
        return F.relu(y) if self.relu else y


class Mixed(nn.Module):
    """mixed_5b / mixed_6a / mixed_7a in Cadene's wiring."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind
        B, S = BasicConv2d, nn.Sequential
        if kind == "mixed_5b":
            self.branch0 = B(192, 96)
            self.branch1 = S(B(192, 48), B(48, 64, 5, 1, 2))
            self.branch2 = S(B(192, 64), B(64, 96, 3, 1, 1),
                             B(96, 96, 3, 1, 1))
            self.branch3 = S(AvgPoolValid(), B(192, 64))
        elif kind == "mixed_6a":
            self.branch0 = B(320, 384, 3, 2, 1)
            self.branch1 = S(B(320, 256), B(256, 256, 3, 1, 1),
                             B(256, 384, 3, 2, 1))
        else:  # mixed_7a
            self.branch0 = S(B(1088, 256), B(256, 384, 3, 2, 1))
            self.branch1 = S(B(1088, 256), B(256, 288, 3, 2, 1))
            self.branch2 = S(B(1088, 256), B(256, 288, 3, 1, 1),
                             B(288, 320, 3, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0(x), self.branch1(x)]
        if self.kind == "mixed_6a":
            outs.append(maxpool_3x3_s2(x))
        else:
            outs.append(self.branch2(x))
            outs.append(self.branch3(x) if self.kind == "mixed_5b"
                        else maxpool_3x3_s2(x))
        return torch.cat(outs, dim=1)


class InceptionResNetV2Encoder(nn.Module):
    """Feature-pyramid Inception-ResNet-v2 encoder (smp's stages)."""

    conv_init = "torch"

    def __init__(self, encoder_name: str = "inceptionresnetv2",
                 in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.conv2d_1a = BasicConv2d(in_channels, 32, 3, 2, 1)
        self.conv2d_2a = BasicConv2d(32, 32, 3, 1, 1)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
        self.conv2d_3b = BasicConv2d(64, 80)
        self.conv2d_4a = BasicConv2d(80, 192, 3, 1, 1)
        self.mixed_5b = Mixed("mixed_5b")
        self.repeat = nn.Sequential(
            *(ResidualBlock("block35", 0.17) for _ in range(10)))
        self.mixed_6a = Mixed("mixed_6a")
        self.repeat_1 = nn.Sequential(
            *(ResidualBlock("block17", 0.10) for _ in range(20)))
        self.mixed_7a = Mixed("mixed_7a")
        self.repeat_2 = nn.Sequential(
            *(ResidualBlock("block8", 0.20) for _ in range(9)))
        self.block8 = ResidualBlock("block8", 1.0, relu=False)
        self.conv2d_7b = BasicConv2d(2080, 1536)

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, 64, 192, 320, 1088, 1536)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        y = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        features.append(y)
        y = self.conv2d_4a(self.conv2d_3b(maxpool_3x3_s2(_gathered(y))))
        features.append(y)
        y = self.repeat(self.mixed_5b(maxpool_3x3_s2(_gathered(y))))
        features.append(y)
        y = self.repeat_1(self.mixed_6a(_gathered(y)))
        features.append(y)
        y = self.block8(self.repeat_2(self.mixed_7a(_gathered(y))))
        features.append(self.conv2d_7b(y))
        return features
