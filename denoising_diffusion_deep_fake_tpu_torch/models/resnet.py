"""ResNet encoders with torchvision topology and flax numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/resnet.py``: the whole
resnet encoder family of smp's ``Unet`` (``RESNET_SPECS``, JAX's table):
resnet18/34 (BasicBlock), resnet50/101/152 (Bottleneck), resnext50_32x4d
and resnext101_32x8d (grouped Bottleneck), wide_resnet50_2 and
wide_resnet101_2, returning the six-level feature pyramid ``[x, c1, c2,
c3, c4, c5]`` at strides (1, 2, 4, 8, 16, 32). Module and parameter names
follow torchvision/smp, so the state_dict uses smp's keys.

Numerics follow the flax model, not ``torch.nn`` defaults:

* convolutions run in the model's compute dtype: the fp32 weight is cast to
  the input's dtype (flax ``dtype=bfloat16``), and the output keeps it;
* batch norm (``BatchNorm2d`` below) takes its statistics in fp32 and
  returns the compute dtype, and updates its running statistics as flax
  does: momentum 0.9 on the old value and the *biased* batch variance
  ``E[x^2] - E[x]^2`` (``torch.nn.BatchNorm2d`` would use momentum 0.1 on
  the new value and the unbiased variance).

Inside a process group (data parallelism, ``parallel/``) train-mode batch
norm takes its statistics over the GLOBAL batch, as flax's does when the
batch axis is sharded (``_GlobalBatchNorm``): each rank sums its rows'
fp32 ``x`` and ``x^2``, one all-reduce (``parallel/collectives.py``) adds
them over the ranks, and the rank normalises with the global mean and
biased variance ``E[x^2] - E[x]^2`` (flax's formula); the running
statistics take the global values. The backward is written out in the
stable form ``w / sigma * (dy - mean(dy) - xhat * mean(dy * xhat))`` (the
one ``F.batch_norm``'s backward uses) with the two means global, one
all-reduce: differentiating through the sums instead would cancel two
terms of size ``mean / sigma`` in fp32, a per-channel error large enough
to move a conv's gradient by several percent where a channel's mean is
far from 0. Outside a group nothing of this runs.

With ``spatial_parallel > 1`` (``parallel/halo.py``) a rank holds H rows
of its data row's images: ``Conv2d`` and the stem's ``MaxPool2d`` exchange
their halos with the neighbouring ranks and pad only at the global edges;
batch norm's sums run over the ranks that hold distinct rows, the world
at a sharded level (the same reduction as above: every rank holds its own
share of the global batch's pixels) and the data group at a level the
encoder gathered and runs replicated (``halo.batch_norm_group``); the
encoder gathers the rows before the first stride whose rows stop
dividing. With no spatial layout open every module is exactly as above.

An EMA shadow runs train-mode BN without writing its running statistics
(``freeze_running_stats_``): it normalises with the batch's statistics, and
its own statistics move only through the EMA blend, as the JAX package
discards the mutated ``batch_stats`` of its shadow forward
(``training/deep_fake.py:145-148``).

The nine other families are their own modules beside this one
(``models/unet.py``'s ``make_encoder``); they build on this module's
``Conv2d`` and ``BatchNorm2d``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    group_all_reduce_,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    training_mesh,
)


class ResNetSpec(NamedTuple):
    """One torchvision-family encoder variant (smp's resnet catalog)."""

    kind: str                   # "basic" | "bottleneck"
    blocks: tuple               # blocks per stage
    widths: tuple = (64, 128, 256, 512)   # stage planes
    expansion: int = 1
    groups: int = 1             # ResNeXt cardinality
    base_width: int = 64        # ResNeXt/wide bottleneck width basis


RESNET_SPECS = {
    "resnet18": ResNetSpec("basic", (2, 2, 2, 2)),
    "resnet34": ResNetSpec("basic", (3, 4, 6, 3)),
    "resnet50": ResNetSpec("bottleneck", (3, 4, 6, 3), expansion=4),
    "resnet101": ResNetSpec("bottleneck", (3, 4, 23, 3), expansion=4),
    "resnet152": ResNetSpec("bottleneck", (3, 8, 36, 3), expansion=4),
    "resnext50_32x4d": ResNetSpec("bottleneck", (3, 4, 6, 3), expansion=4,
                                  groups=32, base_width=4),
    "resnext101_32x8d": ResNetSpec("bottleneck", (3, 4, 23, 3), expansion=4,
                                   groups=32, base_width=8),
    "wide_resnet50_2": ResNetSpec("bottleneck", (3, 4, 6, 3), expansion=4,
                                  base_width=128),
    "wide_resnet101_2": ResNetSpec("bottleneck", (3, 4, 23, 3), expansion=4,
                                   base_width=128),
}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype with fp32 weights; on a
    rank's H rows (``parallel/halo.py``) with its halos."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        layout = halo.active()
        if layout is not None:
            return halo.conv2d(x, self.weight.to(x.dtype), bias,
                               self.stride, self.padding, self.dilation,
                               self.groups, layout)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d``; on a rank's H rows with its halos, ``-inf`` at
    the global edges."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layout = halo.active()
        if layout is None:
            return super().forward(x)
        return halo.max_pool2d(x, self.kernel_size, self.stride,
                               self.padding, layout)


class BatchNorm2d(nn.Module):
    """Batch norm with flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
    semantics (see the module docstring)."""

    # Train mode writes running_mean/running_var unless this is False.
    update_running_stats = True

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if torch.distributed.is_initialized():
            return self._global_forward(x)
        if self.update_running_stats:
            with torch.no_grad():
                xf = x.detach().to(torch.float32)
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf.square().mean(dim=(0, 2, 3))
                       - mean.square()).clamp_min(0.0)
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over the global batch of a process group (the
        module docstring); every rank has as many rows."""
        replicated = halo.batch_norm_group()
        if replicated is None:
            mesh = training_mesh()
            group, shares = mesh.group, mesh.world
        else:
            group, shares = replicated
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, group, shares)
        if self.update_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        return y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """``(y, mean, var)`` of train-mode batch norm over the rows of the
    ``shares`` ranks of ``group`` together, in fp32 (float64 for a float64
    ``x``); ``mean`` and ``var`` (the global statistics) carry no
    gradient. The weight's and bias's gradients are this rank's sums: the
    gradient reduction (``all_reduce_grads_``) makes them the global
    ones."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, shares):
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.numel() // c * shares
        sums = group_all_reduce_(torch.cat([xf.sum(dim=(0, 2, 3)),
                                            xf.square().sum(dim=(0, 2, 3))]),
                                 group)
        mean = sums[:c] / count
        var = (sums[c:] / count - mean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - _per_channel(mean)) * _per_channel(invstd)
        y = xhat * _per_channel(weight) + _per_channel(bias)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[1]
        dyf = dy.to(xhat.dtype)
        local = torch.cat([dyf.sum(dim=(0, 2, 3)),
                           (dyf * xhat).sum(dim=(0, 2, 3))])
        grad_bias, grad_weight = local[:c], local[c:]
        sums = group_all_reduce_(local.clone(), ctx.group) / ctx.count
        dx = _per_channel(weight * invstd) * (
            dyf - _per_channel(sums[:c]) - xhat * _per_channel(sums[c:]))
        return dx.to(dy.dtype), grad_weight, grad_bias, None, None, None


def freeze_running_stats_(model: nn.Module) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``model`` keep its running statistics
    in train mode (the EMA shadow's forward); returns ``model``."""
    for module in model.modules():
        if isinstance(module, BatchNorm2d):
            module.update_running_stats = False
    return model


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (torchvision BasicBlock)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> grouped 3x3 -> 1x1 residual block (torchvision Bottleneck):
    the inner width is ``int(planes * base_width / 64) * groups``, the
    output ``planes * expansion``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 expansion: int = 4, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * base_width / 64) * groups
        out = planes * expansion
        self.conv1 = Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride, bias=False),
                BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNetEncoder(nn.Module):
    """Feature-pyramid ResNet encoder (smp ``get_stages`` semantics)."""

    conv_init = "fan_out"

    def __init__(self, encoder_name: str = "resnet34", in_channels: int = 3):
        super().__init__()
        if encoder_name not in RESNET_SPECS:
            raise ValueError(f"{encoder_name!r} is not a resnet-family name "
                             f"{sorted(RESNET_SPECS)}")
        self.spec = spec = RESNET_SPECS[encoder_name]
        self.in_channels = in_channels
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)
        inplanes = 64
        for stage, (n_blocks, width) in enumerate(
                zip(spec.blocks, spec.widths)):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                if spec.kind == "basic":
                    blocks.append(BasicBlock(inplanes, width, stride))
                else:
                    blocks.append(Bottleneck(
                        inplanes, width, stride, expansion=spec.expansion,
                        groups=spec.groups, base_width=spec.base_width))
                inplanes = width * spec.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels, 64) + tuple(
            w * self.spec.expansion for w in self.spec.widths)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The pyramid; on a rank's H rows, each level's rows gathered
        before a stride they stop dividing (``halo.gather_before_stride``;
        the features keep the rows as they were)."""
        features = [x]
        y = self.relu(self.bn1(self.conv1(x)))
        features.append(y)
        y = self.maxpool(halo.gather_before_stride(y, 2))
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3,
                                   self.layer4)):
            y = layer(halo.gather_before_stride(y, 2) if i else y)
            features.append(y)
        return features
