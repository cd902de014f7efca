"""U-Net with smp topology: any of ten encoder families + the (256, 128,
64, 32, 16) decoder, and the opt-in patchified U-Net.

``make_encoder`` mirrors the JAX package's (``models/unet.py:66-119``):
the resnet family (``models/resnet.py``), vgg, densenet, senet,
EfficientNet, mobilenet_v2, xception, inceptionv4, inceptionresnetv2 and
dpn, every name the JAX package builds. The decoder is wired from the
encoder's ``out_channels``; for the vgg names smp's ``CenterBlock`` (two
Conv2dReLU at the head's width) runs before it (JAX ``unet.py:186-193``).
EfficientNet's stochastic depth takes its masks as an argument of
``Unet.forward`` (``models/efficientnet.py``); the model draws nothing.

``PatchifiedUnet`` (JAX ``unet.py:205-266``, ``patchify_stem: p``) runs
the whole U-Net at H/p x W/p on the p x p pixel-unshuffled input and
shuffles the head back; its channel order is JAX's NHWC one,
``(py * p + px) * C + c``.

Port of ``denoising_diffusion_deep_fake_tpu/models/unet.py:122-202,
254-266`` (``segmentation_models_pytorch.Unet(encoder_name=...,
in_channels=3, classes=3, activation=None)``, the reference's only model).
It has no noise-level conditioning: a blind x0-predictor.

Spatial parallelism (``spatial_parallel > 1``, ``parallel/halo.py``): in
a step's ``halo.row_sharded`` scope ``Unet.forward`` runs on the rank's H
rows; its convolutions exchange halos (the decoder's ``Conv2dReLU`` and
the head are the encoder's ``Conv2d``), the x2 nearest upsample and the
skip concatenation stay local to the rank, and at the level where the
encoder gathered its rows the decoder takes the rank's rows back
(``DecoderBlock``). Every family's encoder routes its ops through
``parallel/halo.py`` and gathers its rows where they stop dividing (its
module docstring). ``PatchifiedUnet`` pixel-unshuffles the rank's rows,
aligned to the patch since ``(H / S) % p == 0``, and runs the inner U-Net
sharded at H / (S p) rows a rank (``config.py`` refuses an odd count).

Layout: ``Unet.forward`` takes and returns NHWC, like the flax model. It
casts the input to the compute dtype and returns fp32 (unet.py:181, 202).
Inside, it works on the NCHW view of the NHWC batch, which is
``channels_last`` in memory; with the weights in the same format (the
trainer's ``init_state`` on the GPU) cuDNN runs NHWC convolutions and no
transpose is made.

Init parity with smp's ``initialize()`` and each encoder's own
(``init_unet_``): the encoder's convs by its family's ``conv_init`` —
He-normal fan-out (resnet, vgg, mobilenet_v2, xception: a grouped or
depthwise conv takes the fan-out of its whole weight, out channels x k x
k, as torchvision's ``kaiming_normal_`` and flax's ``variance_scaling``
both count it), He-normal fan-in (densenet), or torch's defaults (senet,
inceptionv4, inceptionresnetv2, dpn: kaiming-uniform(a=sqrt(5)) weights,
uniform(+-1/sqrt(fan_in)) biases); decoder convs He-uniform fan-in, head
xavier-uniform, other biases zero, BN ones/zeros, drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.densenet import (
    DENSENET_SPECS,
    DenseNetEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.dpn import (
    DPN_SPECS,
    DPNEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.efficientnet import (
    EFFICIENTNET_SPECS,
    EfficientNetEncoder,
    drop_blocks,
)
from denoising_diffusion_deep_fake_tpu_torch.models.inceptionresnetv2 import (
    InceptionResNetV2Encoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.inceptionv4 import (
    InceptionV4Encoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.mobilenet import (
    MobileNetV2Encoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    RESNET_SPECS,
    BatchNorm2d,
    Conv2d,
    ResNetEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.senet import (
    SENET_SPECS,
    SENetEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.vgg import (
    VGG_SPECS,
    VGGEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.models.xception import (
    XceptionEncoder,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo


DECODER_CHANNELS = (256, 128, 64, 32, 16)
# The EfficientNet names (models/efficientnet.py), the one family whose
# forward drops blocks at random.
EFFICIENTNET_NAMES = tuple(EFFICIENTNET_SPECS)
# Each family's names (its spec table where it has one) and encoder, in
# the JAX package's dispatch order.
ENCODER_FAMILIES = (
    (RESNET_SPECS, ResNetEncoder),
    (VGG_SPECS, VGGEncoder),
    (DENSENET_SPECS, DenseNetEncoder),
    (SENET_SPECS, SENetEncoder),
    (EFFICIENTNET_SPECS, EfficientNetEncoder),
    (("mobilenet_v2",), MobileNetV2Encoder),
    (("xception",), XceptionEncoder),
    (("inceptionv4",), InceptionV4Encoder),
    (("inceptionresnetv2",), InceptionResNetV2Encoder),
    (DPN_SPECS, DPNEncoder),
)


def encoder_names() -> list[str]:
    """Every encoder name the port builds."""
    return [n for names, _ in ENCODER_FAMILIES for n in names]


def make_encoder(encoder_name: str, in_channels: int = 3) -> nn.Module:
    """The encoder of ``encoder_name``: a module whose forward returns the
    six-level pyramid at strides (1, 2, 4, 8, 16, 32), channels
    ``out_channels``, and whose ``conv_init`` names its family's
    initializer. Unknown names raise ``ValueError``."""
    for names, encoder in ENCODER_FAMILIES:
        if encoder_name in names:
            return encoder(encoder_name, in_channels)
    raise ValueError(f"unsupported encoder_name {encoder_name!r}; "
                     f"available: {encoder_names()}")


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
        y = halo.take_back(F.interpolate(x, scale_factor=2, mode="nearest"))
        if skip is not None:
            y = torch.cat([y, skip.to(y.dtype)], dim=1)
        return self.conv2(self.conv1(y))


class UnetDecoder(nn.Module):
    """smp's UnetDecoder; ``center`` adds its CenterBlock, two Conv2dReLU
    at the head's width (smp's Unet sets it for the vgg encoders)."""

    def __init__(self, encoder_channels, decoder_channels,
                 center: bool = False):
        super().__init__()
        channels = tuple(encoder_channels[1:])[::-1]     # deepest first
        in_channels = (channels[0],) + tuple(decoder_channels[:-1])
        skip_channels = channels[1:] + (0,)
        self.center = (nn.Sequential(Conv2dReLU(channels[0], channels[0]),
                                     Conv2dReLU(channels[0], channels[0]))
                       if center else None)
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o) for i, s, o in
            zip(in_channels, skip_channels, decoder_channels))

    def forward(self, features: list[torch.Tensor]) -> torch.Tensor:
        head, skips = features[-1], features[1:-1][::-1]
        y = head if self.center is None else self.center(head)
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
        self.encoder_name = encoder_name
        self.encoder = make_encoder(encoder_name, in_channels)
        self.decoder = UnetDecoder(self.encoder.out_channels,
                                   DECODER_CHANNELS,
                                   center=encoder_name.startswith("vgg"))
        self.segmentation_head = nn.Sequential(
            Conv2d(DECODER_CHANNELS[-1], classes, 3, padding=1, bias=True))

    def forward(self, x_nhwc: torch.Tensor,
                drop_masks: torch.Tensor | None = None) -> torch.Tensor:
        """``drop_masks``: the stochastic-depth masks, ``(n, B)`` for the
        ``n = len(drop_keep_probs())`` blocks that drop, or None."""
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        with halo.unet_forward(x.shape[2]):
            if drop_masks is None:
                features = self.encoder(x)
            elif not self.drop_keep_probs():
                raise ValueError(f"the {self.encoder_name} encoder has no "
                                 "block that drops; drop_masks must be None")
            else:
                features = self.encoder(x, drop_masks)
            y = self.segmentation_head(self.decoder(features))
        return y.permute(0, 2, 3, 1).to(torch.float32)

    def drop_keep_probs(self) -> tuple[float, ...]:
        """The keep probability of each block that drops (empty for every
        family but EfficientNet), in ``drop_masks``' order."""
        return drop_keep_probs(self.encoder_name)


def drop_keep_probs(encoder_name: str) -> tuple[float, ...]:
    """The keep probabilities of ``encoder_name``'s stochastic-depth
    blocks, in block order; empty for a family without."""
    if encoder_name not in EFFICIENTNET_SPECS:
        return ()
    return tuple(keep for _, keep in drop_blocks(encoder_name))


def space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC ``(B, H, W, C)`` -> ``(B, H/p, W/p, p*p*C)``, channel ``(py * p
    + px) * C + c`` (JAX's order; ``F.pixel_unshuffle``'s is ``(c, py,
    px)``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, p * p * c)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """The inverse of ``space_to_depth``."""
    b, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, h, w, p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c)


class PatchifiedUnet(nn.Module):
    """The opt-in non-parity variant (``patchify_stem: p``): the inner
    ``unet`` runs on the pixel-unshuffled input at H/p x W/p, with
    ``in_channels * p^2`` inputs and ``classes * p^2`` outputs, and its
    head is pixel-shuffled back; NHWC in, NHWC fp32 out. The reference
    has no counterpart, so its checkpoints are not exported."""

    def __init__(self, encoder_name: str = "resnet34", patch: int = 2,
                 in_channels: int = 3, classes: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder_name = encoder_name
        self.patch = patch
        self.dtype = dtype
        self.unet = Unet(encoder_name, in_channels * patch * patch,
                         classes * patch * patch, dtype)

    def forward(self, x_nhwc: torch.Tensor,
                drop_masks: torch.Tensor | None = None) -> torch.Tensor:
        p = self.patch
        mesh = halo.sharding_mesh()
        height = x_nhwc.shape[1] * (1 if mesh is None else mesh.spatial)
        if height % (32 * p) or x_nhwc.shape[2] % (32 * p):
            raise ValueError(
                f"patchify_stem={p}: H/W must be divisible by {32 * p} "
                f"(got {height}x{x_nhwc.shape[2]}) so the patched "
                "encoder pyramid stays integral")
        if x_nhwc.shape[1] % p:
            raise ValueError(
                f"patchify_stem={p}: a spatial rank's {x_nhwc.shape[1]} "
                "rows do not divide into patches")
        y = self.unet(space_to_depth(x_nhwc.to(self.dtype), p), drop_masks)
        return depth_to_space(y, p)

    def drop_keep_probs(self) -> tuple[float, ...]:
        return self.unet.drop_keep_probs()


def _init_encoder_conv_(conv: Conv2d, kind: str,
                        generator: torch.Generator) -> None:
    """One encoder conv by its family's ``conv_init``: "fan_out" or
    "fan_in" He-normal (biases zero), or "torch", torch's own
    ``reset_parameters`` (kaiming-uniform(a=sqrt(5)) weights,
    uniform(+-1/sqrt(fan_in)) biases)."""
    if kind == "torch":
        nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5),
                                 generator=generator)
        if conv.bias is not None:
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(conv.weight)
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(conv.bias, -bound, bound, generator=generator)
        return
    nn.init.kaiming_normal_(conv.weight, mode=kind, nonlinearity="relu",
                            generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()


@torch.no_grad()
def init_unet_(model: Unet | PatchifiedUnet, generator: torch.Generator
               ) -> Unet | PatchifiedUnet:
    """smp's and the encoder family's initialisation, drawn from
    ``generator`` in module order (a patchified model's inner U-Net's)."""
    if isinstance(model, PatchifiedUnet):
        init_unet_(model.unet, generator)
        return model
    kind = model.encoder.conv_init
    for name, module in model.named_modules():
        if isinstance(module, Conv2d):
            if name.startswith("encoder"):
                _init_encoder_conv_(module, kind, generator)
                continue
            if name.startswith("decoder"):
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
                classes: int = 3, dtype: torch.dtype = torch.float32,
                patchify: int = 1) -> Unet | PatchifiedUnet:
    """Factory mirroring the JAX package's ``create_unet``: ``patchify >
    1`` returns the opt-in ``PatchifiedUnet``."""
    if patchify > 1:
        return PatchifiedUnet(encoder_name, patchify, in_channels, classes,
                              dtype)
    return Unet(encoder_name=encoder_name, in_channels=in_channels,
                classes=classes, dtype=dtype)


def unet_shapes(encoder_name: str, patchify: int = 1
                ) -> dict[str, torch.Size]:
    """The U-Net's state_dict keys and shapes, built on the meta device (no
    memory, nothing drawn); a name the port lacks raises as
    ``make_encoder`` does."""
    with torch.device("meta"):
        model = create_unet(encoder_name, patchify=patchify)
    return {k: v.shape for k, v in model.state_dict().items()}
