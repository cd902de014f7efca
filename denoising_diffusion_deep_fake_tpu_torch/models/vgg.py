"""VGG encoders with torchvision topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/vgg.py``: the eight vgg
names of smp's ``Unet`` (``VGG_SPECS``, JAX's table), torchvision's
``make_layers`` conv stacks split at each max-pool. smp puts the pool at
the head of the next stage, so the six pyramid levels are the activations
before each of the five pools plus the last pooled map, channels (64, 128,
256, 512, 512, 512) at strides (1, 2, 4, 8, 16, 32). There is no raw-input
level: the decoder drops the full-resolution 64-channel level.

Every 3x3 conv has a bias, in the ``_bn`` forms too; ReLU after each conv
(and its BN); ``MaxPool2d(2, 2)`` (the port's, which goes through
``parallel/halo.py`` on a spatial rank's rows; the encoder gathers the
rows before a pool where they stop dividing). The modules sit in one ``features``
Sequential at torchvision's indices, so the state_dict has smp's keys
(``encoder.features.{i}.*``). Init (``models/unet.py``): kaiming-normal
fan-out weights, zero biases.
"""

from __future__ import annotations

import torch
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    MaxPool2d,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo

# torchvision cfgs A/B/D/E (torchvision.models.vgg.cfgs).
_VGG_LAYOUTS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

# name -> (layout, batch_norm): every vgg name smp's Unet accepts.
VGG_SPECS = {}
for _name, _layout in _VGG_LAYOUTS.items():
    VGG_SPECS[_name] = (_layout, False)
    VGG_SPECS[_name + "_bn"] = (_layout, True)


class VGGEncoder(nn.Module):
    """Feature-pyramid VGG encoder (smp ``VGGEncoder.get_stages``)."""

    conv_init = "fan_out"
    out_channels = (64, 128, 256, 512, 512, 512)

    def __init__(self, encoder_name: str = "vgg16", in_channels: int = 3):
        super().__init__()
        layout, batch_norm = VGG_SPECS[encoder_name]
        layers, cin = [], in_channels
        for entry in layout:
            if entry == "M":
                layers.append(MaxPool2d(2, 2))
                continue
            layers.append(Conv2d(cin, entry, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2d(entry))
            layers.append(nn.ReLU(inplace=True))
            cin = entry
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = []
        for module in self.features:
            if isinstance(module, MaxPool2d):
                features.append(x)
                x = halo.gather_before_stride(x, 2)
            x = module(x)
        features.append(x)
        return features
