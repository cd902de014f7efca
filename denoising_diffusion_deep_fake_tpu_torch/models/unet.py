"""U-Net with smp topology: ResNet encoder + (256, 128, 64, 32, 16) decoder.

The encoder is any of the resnet family's nine names
(``models/resnet.py``, ``RESNET_SPECS``); the decoder is wired from its
``out_channels``, so a Bottleneck encoder's 2048-channel head feeds the
first decoder block as smp wires it.

Port of ``denoising_diffusion_deep_fake_tpu/models/unet.py:122-202,
254-266`` (``segmentation_models_pytorch.Unet(encoder_name=...,
in_channels=3, classes=3, activation=None)``, the reference's only model).
It has no noise-level conditioning: a blind x0-predictor.

Layout: ``Unet.forward`` takes and returns NHWC, like the flax model. It
casts the input to the compute dtype and returns fp32 (unet.py:181, 202).
Inside, it works on the NCHW view of the NHWC batch, which is
``channels_last`` in memory; with the weights in the same format (the
trainer's ``init_state`` on the GPU) cuDNN runs NHWC convolutions and no
transpose is made.

Init parity with smp's ``initialize()`` and torchvision: encoder convs
He-normal fan-out, decoder convs He-uniform fan-in, head xavier-uniform,
biases zero, BN ones/zeros, drawn from an explicit ``torch.Generator``.
A grouped 3x3 (ResNeXt) takes the fan-out of its whole weight, out
channels x 9, as torchvision's ``kaiming_normal_`` and flax's
``variance_scaling`` both count it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    Conv2d,
    ResNetEncoder,
)


DECODER_CHANNELS = (256, 128, 64, 32, 16)


class Conv2dReLU(nn.Sequential):
    """Conv3x3 (no bias) -> BN -> ReLU, smp's decoder building block."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    """Upsample 2x (nearest), concat the skip, two Conv2dReLU."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int):
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels + skip_channels, out_channels)
        self.conv2 = Conv2dReLU(out_channels, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None
                ) -> torch.Tensor:
        y = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip.to(y.dtype)], dim=1)
        return self.conv2(self.conv1(y))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels, decoder_channels):
        super().__init__()
        channels = tuple(encoder_channels[1:])[::-1]     # deepest first
        in_channels = (channels[0],) + tuple(decoder_channels[:-1])
        skip_channels = channels[1:] + (0,)
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in
            zip(in_channels, skip_channels, decoder_channels))

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        head, skips = features[-1], features[1:-1][::-1]
        y = head
        for i, block in enumerate(self.blocks):
            y = block(y, skips[i] if i < len(skips) else None)
        return y


class Unet(nn.Module):
    """smp-parity U-Net; NHWC in, NHWC fp32 out."""

    def __init__(self, encoder_name: str = "resnet34",
                 in_channels: int = 3, classes: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(encoder_name, in_channels)
        self.decoder = UnetDecoder(self.encoder.out_channels,
                                   DECODER_CHANNELS)
        self.segmentation_head = nn.Sequential(
            Conv2d(DECODER_CHANNELS[-1], classes, 3, padding=1, bias=True))

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        y = self.segmentation_head(self.decoder(self.encoder(x)))
        return y.permute(0, 2, 3, 1).to(torch.float32)


@torch.no_grad()
def init_unet_(model: Unet, generator: torch.Generator) -> Unet:
    """smp/torchvision initialisation, drawn from ``generator``."""
    for name, module in model.named_modules():
        if isinstance(module, Conv2d):
            if name.startswith("encoder"):
                nn.init.kaiming_normal_(module.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif name.startswith("decoder"):
                nn.init.kaiming_uniform_(module.weight, mode="fan_in",
                                         nonlinearity="relu",
                                         generator=generator)
            else:
                nn.init.xavier_uniform_(module.weight, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, BatchNorm2d):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model


def create_unet(encoder_name: str = "resnet34", *, in_channels: int = 3,
                classes: int = 3, dtype: torch.dtype = torch.float32) -> Unet:
    """Factory mirroring the JAX package's ``create_unet`` (the opt-in
    ``PatchifiedUnet`` is not ported; the trainer refuses ``patchify_stem``).
    """
    return Unet(encoder_name=encoder_name, in_channels=in_channels,
                classes=classes, dtype=dtype)
