"""The InceptionV4 encoder with pretrainedmodels topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/inceptionv4.py``: smp's
``inceptionv4`` wraps Cadene's 22-module ``features`` Sequential with
``stage_idxs=(3, 5, 9, 15)``, channels (3, 64, 192, 384, 1024, 1536):

    stage 1: features[0:3]   the stem convs                    @ 1/2, 64
    stage 2: features[3:5]   Mixed_3a + Mixed_4a               @ 1/4, 192
    stage 3: features[5:9]   Mixed_5a + 3 Inception_A          @ 1/8, 384
    stage 4: features[9:15]  Inception_A + Reduction_A + 4 B   @ 1/16, 1024
    stage 5: features[15:]   3 B + Reduction_B + 3 C           @ 1/32, 1536

* smp pads every 3x3 conv and every max-pool by 1 (Cadene's are pad 0);
  the (1,7)/(7,1)/(1,3)/(3,1) convs keep their own pads;
* ``BasicConv2d``: conv without bias -> BN (eps 1e-3) -> ReLU;
* the branch pool is ``AvgPool2d(3, 1, 1, count_include_pad=False)``: an
  edge window divides by its valid elements, which torch's own flag does;
* the branches concatenate in the torch ``forward``'s order (Mixed_3a
  pools first, Mixed_5a convolves first);
* init (``models/unet.py``): torch's defaults, kaiming-uniform(a=sqrt(5)).

On a spatial rank's rows (``parallel/halo.py``) the convs and pools
exchange their halos (a 7x1 conv 3 rows each way; the branch pool divides
by its taps inside the global image), and the encoder gathers its rows
before each stride-2 module (Mixed_3a, Mixed_5a, the reductions) where
they stop dividing or would leave fewer than 3 a rank (``HALO_REACH``).
smp's pad-1 3x3 convs and pools keep the rows as resnet's do: 448^2 over
2 ranks runs 224 -> 112 -> 56 -> 28 -> 14 -> 7 rows a rank.

The classifier ``last_linear`` is left out, as smp leaves it; module names
are Cadene's (``features.6.branch1.0.conv``), so the state_dict has smp's
keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    avg_pool2d,
    max_pool2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo

INCEPTION_EPS = 1e-3
# The widest halo of the inceptions' convolutions (a 7x1 conv reads 3 rows
# beyond a rank's): a spatial rank keeps at least as many rows.
HALO_REACH = 3
# The modules that halve the rows.
STRIDED = ("mixed_3a", "mixed_5a", "reduction_a", "reduction_b")


class BasicConv2d(nn.Module):
    """Cadene BasicConv2d: conv (no bias) -> BN (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel=1, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = BatchNorm2d(cout, eps=INCEPTION_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class AvgPoolValid(nn.Module):
    """``AvgPool2d(3, 1, 1, count_include_pad=False)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def maxpool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(3, stride=2)`` after smp's pad-1 patch."""
    return max_pool2d(x, 3, 2, 1)


class Mixed(nn.Module):
    """One inception module of the ``features`` Sequential; ``kind`` picks
    Cadene's wiring. Attribute names are Cadene's."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind
        B, S = BasicConv2d, nn.Sequential
        if kind == "mixed_3a":
            self.conv = B(64, 96, 3, 2, 1)
        elif kind == "mixed_4a":
            self.branch0 = S(B(160, 64), B(64, 96, 3, 1, 1))
            self.branch1 = S(B(160, 64), B(64, 64, (1, 7), 1, (0, 3)),
                             B(64, 64, (7, 1), 1, (3, 0)), B(64, 96, 3, 1, 1))
        elif kind == "mixed_5a":
            self.conv = B(192, 192, 3, 2, 1)
        elif kind == "inception_a":
            self.branch0 = B(384, 96)
            self.branch1 = S(B(384, 64), B(64, 96, 3, 1, 1))
            self.branch2 = S(B(384, 64), B(64, 96, 3, 1, 1),
                             B(96, 96, 3, 1, 1))
            self.branch3 = S(AvgPoolValid(), B(384, 96))
        elif kind == "reduction_a":
            self.branch0 = B(384, 384, 3, 2, 1)
            self.branch1 = S(B(384, 192), B(192, 224, 3, 1, 1),
                             B(224, 256, 3, 2, 1))
        elif kind == "inception_b":
            self.branch0 = B(1024, 384)
            self.branch1 = S(B(1024, 192), B(192, 224, (1, 7), 1, (0, 3)),
                             B(224, 256, (7, 1), 1, (3, 0)))
            self.branch2 = S(B(1024, 192), B(192, 192, (7, 1), 1, (3, 0)),
                             B(192, 224, (1, 7), 1, (0, 3)),
                             B(224, 224, (7, 1), 1, (3, 0)),
                             B(224, 256, (1, 7), 1, (0, 3)))
            self.branch3 = S(AvgPoolValid(), B(1024, 128))
        elif kind == "reduction_b":
            self.branch0 = S(B(1024, 192), B(192, 192, 3, 2, 1))
            self.branch1 = S(B(1024, 256), B(256, 256, (1, 7), 1, (0, 3)),
                             B(256, 320, (7, 1), 1, (3, 0)),
                             B(320, 320, 3, 2, 1))
        else:  # inception_c
            self.branch0 = B(1536, 256)
            self.branch1_0 = B(1536, 384)
            self.branch1_1a = B(384, 256, (1, 3), 1, (0, 1))
            self.branch1_1b = B(384, 256, (3, 1), 1, (1, 0))
            self.branch2_0 = B(1536, 384)
            self.branch2_1 = B(384, 448, (3, 1), 1, (1, 0))
            self.branch2_2 = B(448, 512, (1, 3), 1, (0, 1))
            self.branch2_3a = B(512, 256, (1, 3), 1, (0, 1))
            self.branch2_3b = B(512, 256, (3, 1), 1, (1, 0))
            self.branch3 = S(AvgPoolValid(), B(1536, 256))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "mixed_3a":
            outs = [maxpool_3x3_s2(x), self.conv(x)]
        elif k == "mixed_5a":
            outs = [self.conv(x), maxpool_3x3_s2(x)]
        elif k == "mixed_4a":
            outs = [self.branch0(x), self.branch1(x)]
        elif k in ("inception_a", "inception_b"):
            outs = [self.branch0(x), self.branch1(x), self.branch2(x),
                    self.branch3(x)]
        elif k in ("reduction_a", "reduction_b"):
            outs = [self.branch0(x), self.branch1(x), maxpool_3x3_s2(x)]
        else:
            x1 = self.branch1_0(x)
            x2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
            outs = [self.branch0(x), self.branch1_1a(x1),
                    self.branch1_1b(x1), self.branch2_3a(x2),
                    self.branch2_3b(x2), self.branch3(x)]
        return torch.cat(outs, dim=1)


# The 22 features modules after the three stem convs, in Sequential order.
_KINDS = (("mixed_3a", "mixed_4a", "mixed_5a") + ("inception_a",) * 4
          + ("reduction_a",) + ("inception_b",) * 7 + ("reduction_b",)
          + ("inception_c",) * 3)
STAGE_IDXS = (3, 5, 9, 15)


class InceptionV4Encoder(nn.Module):
    """Feature-pyramid InceptionV4 encoder (smp stage_idxs (3, 5, 9, 15))."""

    conv_init = "torch"

    def __init__(self, encoder_name: str = "inceptionv4",
                 in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        stem = [BasicConv2d(in_channels, 32, 3, 2, 1),
                BasicConv2d(32, 32, 3, 1, 1), BasicConv2d(32, 64, 3, 1, 1)]
        self.features = nn.Sequential(*stem, *(Mixed(k) for k in _KINDS))

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, 64, 192, 384, 1024, 1536)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        for i, module in enumerate(self.features):
            if i in STAGE_IDXS:
                features.append(x)
            if getattr(module, "kind", None) in STRIDED:
                x = halo.gather_before_stride(x, 2, HALO_REACH)
            x = module(x)
        features.append(x)
        return features
