"""DDIM refinement for the blind x0-predicting U-Net.

Port of ``denoising_diffusion_deep_fake_tpu/ops/sampler.py:33-94``. The
reference swaps with one U-Net forward; ``swap_refine`` is the JAX
package's multi-step extension. With an x0-predictor that takes no noise
level, the DDIM (eta = 0) update from ratio ``r`` to ``r'`` is

    x0_hat  = clip(f(x_r))
    eps_hat = (x_r - sqrt(1 - r) * x0_hat) * rsqrt(max(r, 1e-8))
    x_r'    = sqrt(1 - r') * x0_hat + sqrt(r') * eps_hat

and one last prediction follows the final knot (r = 0).

JAX scans the steps in one compiled program; here they are a Python loop
over the ``steps`` pairs. The per-step factors come from the fp32 schedule
on the host, so no value is read back from the device. The initial
re-noise at ``r_start`` draws its noise in the CUDA fp32 noise kernel
(``ops/cuda/noise_kernel.py`` ``fused_noise_blend``), keyed by ``seed`` and
``offset``: the function JAX computes with ``jax.random.normal`` and
``blend_noise``, from another random stream.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.noise_kernel import (
    fused_noise_blend,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.noise import blend_noise

_F32 = np.float32


def ddim_ratio_schedule(steps: int, r_start: float = 0.999,
                        r_end: float = 0.0) -> torch.Tensor:
    """``steps + 1`` fp32 knots from ``r_start`` down to ``r_end``, with
    ``jnp.linspace``'s arithmetic as XLA compiles it: ``start * (1 - t) +
    end * t`` with ``t = i * (1 / steps)`` in fp32, and the end appended
    (``torch.linspace`` puts some knots an ulp away)."""
    t = np.arange(steps, dtype=_F32) * (_F32(1) / _F32(steps))
    head = _F32(r_start) * (_F32(1) - t) + _F32(r_end) * t
    return torch.from_numpy(np.append(head, _F32(r_end)).astype(_F32))


def ddim_sample(predict_x0: Callable[[torch.Tensor], torch.Tensor],
                x_init: torch.Tensor, ratios: torch.Tensor,
                clip: tuple[float, float] | None = (-1.0, 1.0)
                ) -> torch.Tensor:
    """Refine ``x_init`` (noised at ``ratios[0]``) along ``ratios``; returns
    the final x0 prediction. ``clip`` bounds each intermediate prediction
    before it is re-noised (None: raw DDIM)."""
    r_all = ratios.detach().cpu().numpy().astype(_F32)
    x = x_init
    for r, r_next in zip(r_all[:-1], r_all[1:]):
        x0_hat = predict_x0(x)
        if clip is not None:
            x0_hat = x0_hat.clamp(clip[0], clip[1])
        inv_sqrt_r = _F32(1) / np.sqrt(max(r, _F32(1e-8)))
        eps_hat = (x - float(np.sqrt(_F32(1) - r)) * x0_hat) * float(
            inv_sqrt_r)
        x_next = (float(np.sqrt(_F32(1) - r_next)) * x0_hat
                  + float(np.sqrt(r_next)) * eps_hat)
        x = x_next.to(x_init.dtype)
    return predict_x0(x)


def swap_refine(predict_x0: Callable[[torch.Tensor], torch.Tensor],
                real: torch.Tensor, *, steps: int, r_start: float = 0.7,
                clip: tuple[float, float] | None = (-1.0, 1.0), seed: int,
                offset: int, noise: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Noise the fp32 batch ``real`` to ``r_start``, then DDIM-refine it in
    ``steps`` steps. The noise comes from the noise kernel's stream of
    ``(seed, offset)``; a given ``noise`` (tests) is blended with
    ``blend_noise`` instead."""
    b = real.shape[0]
    if noise is None:
        ratios = torch.full((b,), r_start, dtype=torch.float32,
                            device=real.device)
        x = fused_noise_blend(real, ratios, seed=seed, offset=offset)
    else:
        r0 = torch.full((b, 1, 1, 1), r_start, dtype=real.dtype,
                        device=real.device)
        x = blend_noise(real, noise.to(real.device), r0)
    return ddim_sample(predict_x0, x, ddim_ratio_schedule(
        steps, r_start=r_start), clip=clip)
