"""DenseNet encoders with torchvision topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/densenet.py``: the four
densenet names of smp's ``Unet`` (``DENSENET_SPECS``, JAX's table). smp's
``DenseNetEncoder`` wraps torchvision's ``DenseNet.features``; its
``TransitionWithSkip`` takes each transition's post-ReLU, pre-1x1
activation as the skip while the main path goes on through the
transition's halving conv and 2x2 average pool:

    stage 0: the raw input
    stage 1: relu(norm0(conv0 7x7/2))                          @ 1/2
    stage 2: maxpool0 + denseblock1 + transition1's skip       @ 1/4
    stage 3: denseblock2 + transition2's skip                  @ 1/8
    stage 4: denseblock3 + transition3's skip                  @ 1/16
    stage 5: denseblock4 + norm5 (BN, no ReLU)                 @ 1/32

A dense layer is BN -> ReLU -> 1x1 conv (4 x growth) -> BN -> ReLU -> 3x3
conv (growth), its output concatenated onto its input. Every conv without
bias. Init (``models/unet.py``): kaiming-normal fan-in, torchvision
densenet's default mode.

On a spatial rank's rows (``parallel/halo.py``) the stem's max pool and
the transitions' 2x2 average pools go through ``halo``, and the encoder
gathers its rows before each of them where they stop dividing.

Module names are torchvision's (``features.denseblock{i}.denselayer{j}
.norm1`` ...), so the state_dict has smp's keys.
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

# name -> (block_config, growth_rate, num_init_features), torchvision's
# densenet121/161/169/201 arguments.
DENSENET_SPECS = {
    "densenet121": ((6, 12, 24, 16), 32, 64),
    "densenet161": ((6, 12, 36, 24), 48, 96),
    "densenet169": ((6, 12, 32, 32), 32, 64),
    "densenet201": ((6, 12, 48, 32), 32, 64),
}


class DenseLayer(nn.Module):
    """torchvision _DenseLayer: BN-ReLU-conv1x1(4g)-BN-ReLU-conv3x3(g),
    concatenated onto its input."""

    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = Conv2d(cin, 4 * growth, 1, bias=False)
        self.norm2 = BatchNorm2d(4 * growth)
        self.conv2 = Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    """torchvision _Transition's modules (BN, 1x1 halving conv); the ReLU
    and the pool are applied by the encoder around the skip."""

    def __init__(self, cin: int):
        super().__init__()
        self.norm = BatchNorm2d(cin)
        self.conv = Conv2d(cin, cin // 2, 1, bias=False)


class DenseNetEncoder(nn.Module):
    """Feature-pyramid DenseNet encoder (smp ``TransitionWithSkip``)."""

    conv_init = "fan_in"

    def __init__(self, encoder_name: str = "densenet121",
                 in_channels: int = 3):
        super().__init__()
        self.block_config, growth, ch = DENSENET_SPECS[encoder_name]
        self.in_channels = in_channels
        features = nn.Module()
        features.conv0 = Conv2d(in_channels, ch, 7, 2, 3, bias=False)
        features.norm0 = BatchNorm2d(ch)
        out = [in_channels, ch]
        for i, layers in enumerate(self.block_config, start=1):
            block = nn.Module()
            for j in range(1, layers + 1):
                block.add_module(f"denselayer{j}", DenseLayer(ch, growth))
                ch += growth
            features.add_module(f"denseblock{i}", block)
            out.append(ch)
            if i != len(self.block_config):
                features.add_module(f"transition{i}", Transition(ch))
                ch //= 2
        features.norm5 = BatchNorm2d(ch)
        self.features = features
        self.out_channels = tuple(out)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        f = self.features
        features = [x]
        y = F.relu(f.norm0(f.conv0(x)))
        features.append(y)
        y = max_pool2d(halo.gather_before_stride(y, 2), 3, 2, 1)
        for i in range(1, len(self.block_config) + 1):
            for layer in getattr(f, f"denseblock{i}").children():
                y = layer(y)
            if i != len(self.block_config):
                transition = getattr(f, f"transition{i}")
                y = F.relu(transition.norm(y))
                features.append(y)
                y = avg_pool2d(halo.gather_before_stride(
                    transition.conv(y), 2), 2, 2)
            else:
                features.append(f.norm5(y))
        return features
