"""The MobileNetV2 encoder with torchvision topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/mobilenet.py``: smp's
``mobilenet_v2`` wraps torchvision's ``MobileNetV2.features`` and slices
it into stages ``[Identity, :2, 2:4, 4:7, 7:14, 14:]``, six levels with
channels (3, 16, 24, 32, 96, 1280) at strides (1, 2, 4, 8, 16, 32).

* stem ConvBNReLU6(3 -> 32, stride 2); 17 InvertedResidual blocks of the
  (t, c, n, s) table below; head ConvBNReLU6(320 -> 1280, 1x1);
* InvertedResidual: [1x1 expand ConvBNReLU6 when t > 1] -> depthwise 3x3
  ConvBNReLU6 (``groups=hidden``) -> 1x1 projection conv + BN, no
  activation; the residual add when the stride is 1 and the channels
  match;
* ReLU6; every conv without bias. Init (``models/unet.py``):
  kaiming-normal fan-out.

On a spatial rank's rows (``parallel/halo.py``) the encoder gathers its
rows before each stride-2 ``InvertedResidual`` where they stop dividing.

Module names are torchvision's (``features.{i}.conv.{k}[.{j}]``), so the
state_dict has smp's keys.
"""

from __future__ import annotations

import torch
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo

# (expand ratio t, out channels c, repeats n, first stride s)
_INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
# The features indices after which smp's stages end (the last is the head).
_STAGE_ENDS = (1, 3, 6, 13, 18)


class ConvBNReLU6(nn.Sequential):
    """torchvision ConvBNReLU: conv (no bias) -> BN -> ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1):
        super().__init__(
            Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                   groups=groups, bias=False),
            BatchNorm2d(cout),
            nn.ReLU6(inplace=True))


class InvertedResidual(nn.Module):
    """torchvision InvertedResidual (the MobileNetV2 block)."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.stride = stride
        self.use_residual = stride == 1 and cin == cout
        layers = ([] if expand_ratio == 1
                  else [ConvBNReLU6(cin, hidden, kernel=1)])
        layers += [ConvBNReLU6(hidden, hidden, stride=stride, groups=hidden),
                   Conv2d(hidden, cout, 1, bias=False),
                   BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_residual else y


class MobileNetV2Encoder(nn.Module):
    """Feature-pyramid MobileNetV2 encoder (smp stage slices)."""

    conv_init = "fan_out"

    def __init__(self, encoder_name: str = "mobilenet_v2",
                 in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        layers, cin = [ConvBNReLU6(in_channels, 32, stride=2)], 32
        for t, c, n, s in _INVERTED_RESIDUAL_SETTING:
            for i in range(n):
                layers.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        layers.append(ConvBNReLU6(cin, 1280, kernel=1))
        self.features = nn.Sequential(*layers)

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, 16, 24, 32, 96, 1280)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        for i, module in enumerate(self.features):
            if getattr(module, "stride", 1) == 2:
                x = halo.gather_before_stride(x, 2)
            x = module(x)
            if i in _STAGE_ENDS:
                features.append(x)
        return features
