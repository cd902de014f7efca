"""SE-Net encoders with pretrainedmodels topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/senet.py``: the six
senet names of smp's ``Unet`` (``SENET_SPECS``, JAX's table), Cadene's
pretrainedmodels ``SENet`` staged as smp's ``SENetEncoder``:

    stage 0: the raw input
    stage 1: layer0 without its trailing max-pool              @ 1/2
    stage 2: that max-pool + layer1                            @ 1/4
    stage 3: layer2                                            @ 1/8
    stage 4: layer3                                            @ 1/16
    stage 5: layer4                                            @ 1/32

* the SE module: global mean -> 1x1 ``fc1`` (C -> C/16, with bias) ->
  ReLU -> 1x1 ``fc2`` (with bias) -> sigmoid, multiplied into the
  bottleneck's output before the residual add;
* ``SEResNetBottleneck`` strides its 1x1 ``conv1`` (a Caffe-port quirk);
  ``SEResNeXtBottleneck`` its grouped 3x3 (width floor(planes * 4 / 64) *
  32); senet154's ``SEBottleneck`` is 1x1 -> planes * 2, grouped 3x3 (64
  groups) -> planes * 4, 1x1 -> planes * 4;
* the stem: conv7x7/2 + BN + ReLU, or senet154's three 3x3 convs (64, 64,
  128); then ``MaxPool2d(3, stride=2, ceil_mode=True)`` with no padding;
* layer1's downsample is 1x1; senet154's layers 2-4 downsample with a
  3x3/pad 1 conv;
* init (``models/unet.py``): torch's defaults, kaiming-uniform(a=sqrt(5))
  weights and uniform(+-1/sqrt(fan_in)) SE biases.

On a spatial rank's rows (``parallel/halo.py``) the SE mean is summed
over the data row (``halo.spatial_mean``), the stem's ceil-mode pool
reads one row below (``-inf`` past the global bottom), and the encoder
gathers its rows before the pool and ``layer2..4`` where they stop
dividing.

The classifier (``avg_pool``, ``dropout``, ``last_linear``) is left out, as
smp leaves it; module names are pretrainedmodels', so the state_dict has
smp's keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    max_pool2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo


class SENetSpec(NamedTuple):
    """One pretrainedmodels SENet variant (smp's senet catalog)."""

    block: str                  # "se_resnet" | "se_resnext" | "se_bottleneck"
    layers: tuple               # blocks per stage
    groups: int = 1
    reduction: int = 16
    inplanes: int = 64
    input_3x3: bool = False     # senet154's 3-conv stem
    downsample_3x3: bool = False  # senet154: 3x3 downsamples in layers 2-4
    base_width: int = 4         # se_resnext bottleneck width basis


SENET_SPECS = {
    "se_resnet50": SENetSpec("se_resnet", (3, 4, 6, 3)),
    "se_resnet101": SENetSpec("se_resnet", (3, 4, 23, 3)),
    "se_resnet152": SENetSpec("se_resnet", (3, 8, 36, 3)),
    "se_resnext50_32x4d": SENetSpec("se_resnext", (3, 4, 6, 3), groups=32),
    "se_resnext101_32x4d": SENetSpec("se_resnext", (3, 4, 23, 3), groups=32),
    "senet154": SENetSpec("se_bottleneck", (3, 8, 36, 3), groups=64,
                          inplanes=128, input_3x3=True, downsample_3x3=True),
}


class SEModule(nn.Module):
    """Squeeze and excitation through two biased 1x1 convs."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1)
        self.fc2 = Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = halo.spatial_mean(x)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class SEBottleneck(nn.Module):
    """pretrainedmodels' three bottlenecks, ``kind`` picking the wiring."""

    def __init__(self, cin: int, planes: int, kind: str, stride: int = 1,
                 groups: int = 1, reduction: int = 16, base_width: int = 4,
                 downsample_3x3: bool = False):
        super().__init__()
        out = planes * 4
        if kind == "se_resnet":
            widths, strides, groups = (planes, planes), (stride, 1), 1
        elif kind == "se_resnext":
            w = math.floor(planes * (base_width / 64)) * groups
            widths, strides = (w, w), (1, stride)
        else:
            widths, strides = (planes * 2, planes * 4), (1, stride)
        self.conv1 = Conv2d(cin, widths[0], 1, strides[0], bias=False)
        self.bn1 = BatchNorm2d(widths[0])
        self.conv2 = Conv2d(widths[0], widths[1], 3, strides[1], 1,
                            groups=groups, bias=False)
        self.bn2 = BatchNorm2d(widths[1])
        self.conv3 = Conv2d(widths[1], out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.se_module = SEModule(out, reduction)
        self.downsample = None
        if stride != 1 or cin != out:
            k = 3 if downsample_3x3 else 1
            self.downsample = nn.Sequential(
                Conv2d(cin, out, k, stride, (k - 1) // 2, bias=False),
                BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se_module(self.bn3(self.conv3(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class SENetEncoder(nn.Module):
    """Feature-pyramid SE-Net encoder (smp ``SENetEncoder`` stages)."""

    conv_init = "torch"

    def __init__(self, encoder_name: str = "se_resnet50",
                 in_channels: int = 3):
        super().__init__()
        self.spec = spec = SENET_SPECS[encoder_name]
        self.in_channels = in_channels
        layer0 = nn.Module()
        if spec.input_3x3:
            for i, (cin, cout, s) in enumerate(
                    ((in_channels, 64, 2), (64, 64, 1), (64, 128, 1)),
                    start=1):
                layer0.add_module(f"conv{i}",
                                  Conv2d(cin, cout, 3, s, 1, bias=False))
                layer0.add_module(f"bn{i}", BatchNorm2d(cout))
        else:
            layer0.conv1 = Conv2d(in_channels, spec.inplanes, 7, 2, 3,
                                  bias=False)
            layer0.bn1 = BatchNorm2d(spec.inplanes)
        self.layer0 = layer0
        cin = spec.inplanes
        for li, (n, planes) in enumerate(zip(spec.layers,
                                             (64, 128, 256, 512)), start=1):
            blocks = []
            for bi in range(n):
                blocks.append(SEBottleneck(
                    cin, planes, spec.block, 2 if li > 1 and bi == 0 else 1,
                    spec.groups, spec.reduction, spec.base_width,
                    downsample_3x3=spec.downsample_3x3 and li > 1))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, self.spec.inplanes, 256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        l0 = self.layer0
        y = F.relu(l0.bn1(l0.conv1(x)))
        if self.spec.input_3x3:
            y = F.relu(l0.bn2(l0.conv2(y)))
            y = F.relu(l0.bn3(l0.conv3(y)))
        features.append(y)
        y = max_pool2d(halo.gather_before_stride(y, 2), 3, 2, 0,
                       ceil_mode=True)
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3,
                                   self.layer4)):
            y = layer(halo.gather_before_stride(y, 2) if i else y)
            features.append(y)
        return features
