"""Dual Path Network encoders with pretrainedmodels topology and flax
numerics.

Port of ``denoising_diffusion_deep_fake_tpu/models/dpn.py``: the six dpn
names of smp's ``Unet`` (``DPN_SPECS``, JAX's table). Every block carries
a residual path of fixed width ``bw`` and a dense path that grows by
``inc`` channels a block; smp's ``DPNEncoder`` stages:

    stage 0: the raw input
    stage 1: conv1_1's conv + BN + ReLU (without its max-pool)  @ 1/2
    stage 2: conv1_1's max-pool + conv2_*                        @ 1/4
    stage 3: conv3_*                                             @ 1/8
    stage 4: conv4_*                                             @ 1/16
    stage 5: conv5_* + conv5_bn_ac                               @ 1/32

where a stage that ends on a (residual, dense) pair gives
``relu(cat(res, dense))``.

* ``BnActConv2d``: BN (eps 1e-3) -> ReLU -> conv without bias, the
  pre-activation order;
* ``DualPathBlock``: a projection ``c1x1_w_s1`` / ``c1x1_w_s2`` (the name
  carries the stride) to ``bw + 2 * inc`` channels, split into the
  residual base and the dense seed; ``c1x1_a`` (r) -> grouped 3x3
  ``c3x3_b`` (r, the stride on a "down" block) -> ``c1x1_c`` (bw + inc,
  split); dpn68b's ``b=True`` has ``c1x1_c`` a ``CatBnAct`` (BN + ReLU)
  and two plain convs ``c1x1_c1`` / ``c1x1_c2``;
* the stem: a 7x7/2 conv (3x3/2 for the small nets) + BN + ReLU +
  MaxPool(3, 2, 1);
* init (``models/unet.py``): torch's defaults, kaiming-uniform(a=sqrt(5)).

On a spatial rank's rows (``parallel/halo.py``) the stem's max pool goes
through ``halo``, and the encoder gathers its rows before it and before
each stage's first block where they stop dividing (the pair concatenated,
as the block itself concatenates it).

The classifier ``last_linear`` is left out, as smp leaves it; module names
are pretrainedmodels' (``features.conv2_1.c1x1_a.conv``), so the state_dict
has smp's keys.
"""

from __future__ import annotations

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


class DPNSpec(NamedTuple):
    stage_idxs: tuple      # smp's slice boundaries into the features list
    out_channels: tuple
    small: bool            # 3x3 stem + bw_factor 1
    init_features: int
    k_r: int
    groups: int
    b: bool                # dpn68b's CatBnAct + split-conv variant
    k_sec: tuple           # blocks per stage
    inc_sec: tuple         # dense-path growth per stage


DPN_SPECS = {
    "dpn68": DPNSpec((4, 8, 20, 24), (3, 10, 144, 320, 704, 832), True, 10,
                     128, 32, False, (3, 4, 12, 3), (16, 32, 32, 64)),
    "dpn68b": DPNSpec((4, 8, 20, 24), (3, 10, 144, 320, 704, 832), True, 10,
                      128, 32, True, (3, 4, 12, 3), (16, 32, 32, 64)),
    "dpn92": DPNSpec((4, 8, 28, 32), (3, 64, 336, 704, 1552, 2688), False,
                     64, 96, 32, False, (3, 4, 20, 3), (16, 32, 24, 128)),
    "dpn98": DPNSpec((4, 10, 30, 34), (3, 96, 336, 768, 1728, 2688), False,
                     96, 160, 40, False, (3, 6, 20, 3), (16, 32, 32, 128)),
    "dpn107": DPNSpec((5, 13, 33, 37), (3, 128, 376, 1152, 2432, 2688),
                      False, 128, 200, 50, False, (4, 8, 20, 3),
                      (20, 64, 64, 128)),
    "dpn131": DPNSpec((5, 13, 41, 45), (3, 128, 352, 832, 1984, 2688),
                      False, 128, 160, 40, False, (4, 8, 28, 3),
                      (16, 32, 32, 128)),
}
_EPS = 1e-3


class CatBnAct(nn.Module):
    """pretrainedmodels CatBnAct's module: BN (eps 1e-3), then ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm2d(channels, eps=_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(x))


class BnActConv2d(nn.Module):
    """BN (eps 1e-3) -> ReLU -> conv without bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.bn = BatchNorm2d(cin, eps=_EPS)
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                           groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.relu(self.bn(x)))


class DualPathBlock(nn.Module):
    """One DPN block over a (residual, dense) pair of feature maps."""

    def __init__(self, cin: int, r: int, bw: int, inc: int, groups: int,
                 block_type: str, b: bool = False):
        super().__init__()
        self.bw, self.b = bw, b
        stride = 2 if block_type == "down" else 1
        self.proj = None
        if block_type in ("proj", "down"):
            self.proj = f"c1x1_w_s{stride}"
            self.add_module(self.proj,
                            BnActConv2d(cin, bw + 2 * inc, 1, stride))
        self.c1x1_a = BnActConv2d(cin, r, 1)
        self.c3x3_b = BnActConv2d(r, r, 3, stride, groups)
        if b:
            self.c1x1_c = CatBnAct(r)
            self.c1x1_c1 = Conv2d(r, bw, 1, bias=False)
            self.c1x1_c2 = Conv2d(r, inc, 1, bias=False)
        else:
            self.c1x1_c = BnActConv2d(r, bw + inc, 1)

    def forward(self, x) -> tuple[torch.Tensor, torch.Tensor]:
        x_in = torch.cat(x, dim=1) if isinstance(x, tuple) else x
        if self.proj is not None:
            x_s = getattr(self, self.proj)(x_in)
            x_s1, x_s2 = x_s[:, :self.bw], x_s[:, self.bw:]
        else:
            x_s1, x_s2 = x
        y = self.c1x1_c(self.c3x3_b(self.c1x1_a(x_in)))
        if self.b:
            out1, out2 = self.c1x1_c1(y), self.c1x1_c2(y)
        else:
            out1, out2 = y[:, :self.bw], y[:, self.bw:]
        return x_s1 + out1, torch.cat([x_s2, out2], dim=1)


def dpn_block_plan(spec: DPNSpec) -> list[tuple[str, dict]]:
    """(features key, ``DualPathBlock`` arguments but ``cin``) for conv2_1
    .. conv5_k (JAX ``_dpn_block_plan``)."""
    bw_factor = 1 if spec.small else 4
    plan = []
    for stage, base in enumerate((64, 128, 256, 512), start=2):
        bw = base * bw_factor
        inc = spec.inc_sec[stage - 2]
        r = (spec.k_r * bw) // (64 * bw_factor)
        first = "proj" if stage == 2 else "down"
        for i in range(1, spec.k_sec[stage - 2] + 1):
            plan.append((f"conv{stage}_{i}",
                         dict(r=r, bw=bw, inc=inc, groups=spec.groups,
                              block_type=first if i == 1 else "normal",
                              b=spec.b)))
    return plan


class DPNEncoder(nn.Module):
    """Feature-pyramid DPN encoder (smp ``DPNEncoder`` stages)."""

    conv_init = "torch"

    def __init__(self, encoder_name: str = "dpn68", in_channels: int = 3):
        super().__init__()
        self.spec = spec = DPN_SPECS[encoder_name]
        self.in_channels = in_channels
        features = nn.ModuleDict()
        stem = nn.Module()
        k = 3 if spec.small else 7
        stem.conv = Conv2d(in_channels, spec.init_features, k, 2,
                           (k - 1) // 2, bias=False)
        stem.bn = BatchNorm2d(spec.init_features, eps=_EPS)
        features["conv1_1"] = stem
        cin = spec.init_features
        for key, kwargs in dpn_block_plan(spec):
            features[key] = DualPathBlock(cin, **kwargs)
            cin = (kwargs["bw"] + 3 * kwargs["inc"]
                   if kwargs["block_type"] != "normal"
                   else cin + kwargs["inc"])
        features["conv5_bn_ac"] = CatBnAct(cin)
        self.features = features

    @property
    def out_channels(self) -> tuple[int, ...]:
        return (self.in_channels,) + self.spec.out_channels[1:]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        stem = self.features["conv1_1"]
        y = F.relu(stem.bn(stem.conv(x)))
        features.append(y)
        y = max_pool2d(halo.gather_before_stride(y, 2), 3, 2, 1)
        for key, block in self.features.items():
            if key in ("conv1_1", "conv5_bn_ac"):
                continue
            if key in ("conv3_1", "conv4_1", "conv5_1"):
                y = torch.cat(y, dim=1)
                features.append(F.relu(y))
                y = halo.gather_before_stride(y, 2)
            y = block(y)
        features.append(self.features["conv5_bn_ac"](torch.cat(y, dim=1)))
        return features
