"""The control's precision: fp8 for a configuration that states bfloat16.

``fp8_quant(x)`` rounds a tensor to float8 e4m3 under a per-tensor scale
(its absolute maximum onto e4m3's 448), as fp8 training and inference
scale their operands, and its gradient to float8 e5m2 the same way (onto
57344). The reference applies it to every convolution's input and weight
(``reference/unet.py``'s ``quant``), which is what running those
convolutions in fp8 does to their operands.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32).clamp_min(1e-30)
    scale = top / amax
    return (x.to(torch.float32) * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX).to(grad.dtype)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
