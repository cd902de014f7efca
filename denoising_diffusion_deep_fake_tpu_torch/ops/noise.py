"""Continuous variance-preserving noise injection.

Port of ``denoising_diffusion_deep_fake_tpu/ops/noise.py:25-78``: a
per-sample noise ratio ``r`` from an exponential truncated to ``[0, 1]``
(inverse-CDF sampling) and the blend ``sqrt(1 - r) * x + sqrt(r) * eps``.

Random draws come from an explicit ``torch.Generator``; the uniforms and the
noise are optional arguments so tests can hand both frameworks the same
numbers (JAX's and PyTorch's generators differ by design).
"""

from __future__ import annotations

import functools

import torch


def sample_truncated_exponential(shape, lam: float, *,
                                 generator: torch.Generator | None = None,
                                 device=None,
                                 uniform: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Samples in ``[0, 1)``: ``r = log(1 / (y (1 - c) + c)) / lam``,
    ``c = exp(-lam)``, ``y ~ U[0, 1)`` (or the given ``uniform``)."""
    if uniform is None:
        uniform = torch.rand(shape, generator=generator, device=device)
    y = uniform.to(torch.float32)
    c = _exp_neg(lam, y.device)
    return (1.0 / lam) * torch.log(1.0 / (y * (1.0 - c) + c))


@functools.lru_cache(maxsize=None)
def _exp_neg(lam: float, device: torch.device) -> torch.Tensor:
    """``exp(-lam)`` in fp32 on ``device``, made once per device: a step
    captured in a CUDA graph may copy nothing from the host."""
    return torch.exp(torch.tensor(-lam, dtype=torch.float32, device=device))


def blend_noise(batch: torch.Tensor, noise: torch.Tensor,
                ratio: torch.Tensor) -> torch.Tensor:
    """``sqrt(1 - r) * x + sqrt(r) * noise``; ``ratio`` broadcasts."""
    ratio = ratio.to(batch.dtype)
    return torch.sqrt(1.0 - ratio) * batch + torch.sqrt(ratio) * noise


def blend_random_amount_of_noise(batch: torch.Tensor, lam: float, *,
                                 generator: torch.Generator | None = None,
                                 uniform: torch.Tensor | None = None,
                                 noise: torch.Tensor | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise each sample at its own truncated-exponential ratio.

    Returns ``(noisy_batch, ratios)`` with ratios of shape ``(B, 1, 1, 1)``.
    """
    shape = (batch.shape[0],) + (1,) * (batch.dim() - 1)
    r = sample_truncated_exponential(
        shape, lam, generator=generator, device=batch.device,
        uniform=None if uniform is None else uniform.reshape(shape))
    if noise is None:
        noise = torch.randn(batch.shape, generator=generator,
                            device=batch.device, dtype=batch.dtype)
    return blend_noise(batch, noise, r), r


def blend_fixed_amount_of_noise(batch: torch.Tensor, ratio: float, *,
                                generator: torch.Generator | None = None,
                                noise: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Noise every sample at one fixed ratio (the balancer's schedule)."""
    if noise is None:
        noise = torch.randn(batch.shape, generator=generator,
                            device=batch.device, dtype=batch.dtype)
    r = torch.full((batch.shape[0],) + (1,) * (batch.dim() - 1), ratio,
                   dtype=torch.float32, device=batch.device)
    return blend_noise(batch, noise, r)
