"""Exponential moving average of a model's tensors, in place.

Port of ``denoising_diffusion_deep_fake_tpu/training/ema.py:30-60``, the
``ema_pytorch.EMA`` semantics of the swap workload's shadows:

* ``step`` counts ``update()`` calls made before this one;
* for ``step <= update_after_step`` the shadow copies the online tensors
  (decay 0); afterwards ``decay = clamp(1 - (1 + epoch / inv_gamma) **
  -power, 0, beta)`` with ``epoch = step - update_after_step - 1``;
* the blend ``ema = decay * ema + (1 - decay) * online`` runs only on every
  ``update_every``-th call.

The decay is computed in fp32 on the host, operation by operation as the
JAX formula computes it, so both frameworks blend with the same fp32 value;
the step is a host integer, so nothing is read back from the device. The
blend runs over tensor lists with ``torch._foreach_*`` (a few launches for
all of a U-Net's tensors), rounded as JAX rounds it: both products, then
their sum. (A multiply-add would round the sum of the second product once
less, which is many ulps off where the two products nearly cancel.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    beta: float = 0.9999
    update_every: int = 1
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_decay(step: int, cfg: EmaConfig) -> np.float32:
    """The fp32 decay of the ``update()`` call made after ``step`` calls."""
    epoch = _F32(step) - _F32(cfg.update_after_step) - _F32(1.0)
    if epoch <= 0:
        return _F32(0.0)
    value = _F32(1.0) - (_F32(1.0) + epoch / _F32(cfg.inv_gamma)) ** _F32(
        -cfg.power)
    return np.clip(value, _F32(0.0), _F32(cfg.beta))


@torch.no_grad()
def ema_update(ema_tensors, online_tensors, step: int,
               cfg: EmaConfig) -> int:
    """One ``EMA.update()`` call over matching fp32 tensor lists, in place
    on ``ema_tensors``; returns the new step."""
    if step % cfg.update_every == 0:
        ema_tensors, online_tensors = list(ema_tensors), list(online_tensors)
        decay = ema_decay(step, cfg)
        scaled = torch._foreach_mul(online_tensors, float(_F32(1.0) - decay))
        torch._foreach_mul_(ema_tensors, float(decay))
        torch._foreach_add_(ema_tensors, scaled)
    return step + 1
