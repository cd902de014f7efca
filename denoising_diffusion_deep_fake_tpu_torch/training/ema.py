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

``ema_blend`` takes the decay and its complement ``1 - decay`` (the
weight, also fp32 from the host) as numbers or as fp32 device tensors: a
train step captured in a CUDA graph reads them from the group's table, so a
replay blends with that step's values. A call that ``update_every`` skips
passes a gate of 0: with numbers the blend is not run, with tensors the
blended value is computed and not selected (``torch.where``, as JAX's
``jnp.where``), so the shadow keeps its bits either way.
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


def ema_scalars(step: int, cfg: EmaConfig) -> dict:
    """The host numbers ``ema_blend`` takes for the ``update()`` call made
    after ``step`` calls: ``decay``, ``weight`` (``1 - decay`` in fp32) and,
    where ``update_every`` skips calls, ``gate`` (1 for a blend, 0 for a
    skip)."""
    decay = ema_decay(step, cfg)
    out = {"decay": decay, "weight": _F32(1.0) - decay}
    if cfg.update_every > 1:
        out["gate"] = int(step % cfg.update_every == 0)
    return out


@torch.no_grad()
def ema_blend(ema_tensors, online_tensors, decay, weight,
              gate=None) -> None:
    """``ema = decay * ema + weight * online`` in place over matching fp32
    tensor lists; ``decay``, ``weight`` and ``gate`` numbers or fp32 device
    tensors (see the module docstring)."""
    if gate is not None and not isinstance(gate, torch.Tensor) and not gate:
        return
    ema_tensors, online_tensors = list(ema_tensors), list(online_tensors)
    if not isinstance(decay, torch.Tensor):
        decay, weight = float(decay), float(weight)
    scaled = torch._foreach_mul(online_tensors, weight)
    if isinstance(gate, torch.Tensor):
        blended = torch._foreach_mul(ema_tensors, decay)
        torch._foreach_add_(blended, scaled)
        keep = gate == 0
        for e, b in zip(ema_tensors, blended):
            torch.where(keep, e, b, out=e)
        return
    torch._foreach_mul_(ema_tensors, decay)
    torch._foreach_add_(ema_tensors, scaled)


def ema_update(ema_tensors, online_tensors, step: int,
               cfg: EmaConfig) -> int:
    """One ``EMA.update()`` call over matching fp32 tensor lists, in place
    on ``ema_tensors``; returns the new step."""
    ema_blend(ema_tensors, online_tensors, **ema_scalars(step, cfg))
    return step + 1
