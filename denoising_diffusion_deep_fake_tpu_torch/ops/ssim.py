"""Structural similarity (SSIM) on NHWC batches, always in fp32.

Port of ``denoising_diffusion_deep_fake_tpu/ops/ssim.py:26-139`` (parity
target ``piqa.SSIM()``): 11-tap Gaussian window (sigma 1.5), per-channel
filtering with valid padding, ``k1=0.01, k2=0.03``, mean over channels and
pixels per image, mean over the batch.

The five filtered maps (mu_x, mu_y, E[x^2], E[y^2], E[xy]) go through one
separable depthwise blur as 5C channels; the JAX package's choice between
layouts of that blur is TPU tuning and bit-identical (ssim.py:95-113).

The blur must run in full fp32: ``sigma = E[x^2] - mu^2`` cancels, and the
JAX package pins the blur to ``Precision.HIGHEST`` because bf16-rounded maps
diverge training (ssim.py:57-63). On the GPU, cuDNN runs fp32 convolutions
in TF32 while ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's
default), so the trainer turns it off (training/denoiser.py).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_tuple(window_size: int, sigma: float
                           ) -> tuple[float, ...]:
    half = (window_size - 1) / 2.0
    g = [math.exp(-((i - half) ** 2) / (2.0 * sigma * sigma))
         for i in range(window_size)]
    s = sum(g)
    return tuple(v / s for v in g)


def gaussian_kernel(window_size: int = 11, sigma: float = 1.5,
                    device=None) -> torch.Tensor:
    """Normalised 1-D Gaussian window, as piqa builds it; made once per
    device (a step captured in a CUDA graph may copy nothing from the
    host), so never write to it."""
    return _gaussian_kernel_on(window_size, sigma, torch.device(
        device if device is not None else "cpu"))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_on(window_size: int, sigma: float,
                        device: torch.device) -> torch.Tensor:
    return torch.tensor(_gaussian_kernel_tuple(window_size, sigma),
                        dtype=torch.float32, device=device)


def _blur(x_nchw: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-padding depthwise blur, H then W."""
    c = x_nchw.shape[1]
    k = kernel.shape[0]
    x = F.conv2d(x_nchw, kernel.reshape(1, 1, k, 1).repeat(c, 1, 1, 1),
                 groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, k).repeat(c, 1, 1, 1),
                    groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, *, value_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, reduce_batch: bool = True) -> torch.Tensor:
    """SSIM between NHWC batches in ``[0, value_range]``: a scalar (mean
    over the batch) or, with ``reduce_batch=False``, per image ``(B,)``."""
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    c = x.shape[-1]
    kernel = gaussian_kernel(window_size, sigma, device=x.device)
    c1 = (k1 * value_range) ** 2
    c2 = (k2 * value_range) ** 2

    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=-1)  # (B,H,W,5C)
    f = _blur(stacked.permute(0, 3, 1, 2), kernel)
    mu_x, mu_y, exx, eyy, exy = torch.split(f, c, dim=1)

    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = exx - mu_xx
    sigma_y = eyy - mu_yy
    sigma_xy = exy - mu_xy
    ss = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    per_image = ss.mean(dim=(1, 2, 3))
    return per_image.mean() if reduce_batch else per_image
