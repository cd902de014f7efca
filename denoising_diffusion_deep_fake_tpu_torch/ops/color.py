"""Batched color jitter on the device.

Port of ``denoising_diffusion_deep_fake_tpu/ops/color.py``: Kornia
``ColorJitter`` parameter semantics with torchvision's per-op math, on
[0, 1] RGB NHWC tensors, off by default (the reference has no photometric
augmentation; ``color_jitter`` in the trainers' configs turns it on).

* brightness ``b``: factor ~ U[max(0, 1-b), 1+b]; ``img * f``, clamp [0, 1]
* contrast ``c``: factor ~ U[max(0, 1-c), 1+c]; blend with the mean of the
  image's grayscale: ``img*f + mean(gray)*(1-f)``, clamp
* saturation ``s``: factor ~ U[max(0, 1-s), 1+s]; blend with the per-pixel
  grayscale: ``img*f + gray*(1-f)``, clamp
* hue ``h`` (<= 0.5): shift ~ U[-h, h]; HSV hue rotated mod 1

Grayscale uses the ITU-R BT.601 weights (0.299, 0.587, 0.114). The four
ops run in the JAX package's fixed order, brightness -> contrast ->
saturation -> hue (torchvision and Kornia pick a random order per call).
The hue math keeps JAX's floor-mod semantics (``torch.remainder``, not
``fmod``) and its ``jnp.select`` order of the six sectors.

Plain PyTorch elementwise ops: JAX runs the chain as XLA elementwise
fusion, not as a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R BT.601, torchvision's choice


@dataclasses.dataclass(frozen=True)
class ColorJitterConfig:
    """Kornia/torchvision ColorJitter strengths (0 disables each op)."""

    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0          # must be in [0, 0.5]
    probability: float = 1.0  # per-sample apply probability (kornia's p)

    def __post_init__(self):
        for name in ("brightness", "contrast", "saturation"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if not 0.0 <= self.hue <= 0.5:
            raise ValueError("hue must be in [0, 0.5]")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")

    @property
    def enabled(self) -> bool:
        return (self.brightness > 0 or self.contrast > 0
                or self.saturation > 0 or self.hue > 0)


def sample_color_jitter_params(generator: torch.Generator | None,
                               batch_size: int, cfg: ColorJitterConfig,
                               device=None) -> dict[str, torch.Tensor]:
    """Per-sample jitter factors (brightness, contrast, saturation, hue,
    apply), drawn on ``device`` from ``generator``.

    Disabled ops (strength 0) take the identity factor exactly and draw
    nothing, so the op chain is a no-op for them whatever ``apply``.
    """
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch_size, generator=generator,
                                           device=device)

    def factor(strength):
        if not strength:
            return torch.ones(batch_size, device=device)
        return uniform(max(0.0, 1.0 - strength), 1.0 + strength)

    out = {"brightness": factor(cfg.brightness),
           "contrast": factor(cfg.contrast),
           "saturation": factor(cfg.saturation),
           "hue": (uniform(-cfg.hue, cfg.hue) if cfg.hue
                   else torch.zeros(batch_size, device=device))}
    out["apply"] = torch.rand(batch_size, generator=generator,
                              device=device) < cfg.probability
    return out


def _per_sample(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(-1, 1, 1, 1)


def _gray(x01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] -> (B, H, W, 1) BT.601 luma. The weights are
    numbers, not a tensor: a step captured in a CUDA graph may copy
    nothing from the host."""
    wr, wg, wb = _GRAY_WEIGHTS
    return (x01[..., 0:1] * wr + x01[..., 1:2] * wg) + x01[..., 2:3] * wb


def adjust_brightness(x01: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return (x01 * _per_sample(f)).clamp(0.0, 1.0)


def adjust_contrast(x01: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    mean = _gray(x01).mean(dim=(1, 2, 3), keepdim=True)
    fb = _per_sample(f)
    return (x01 * fb + mean * (1.0 - fb)).clamp(0.0, 1.0)


def adjust_saturation(x01: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    fb = _per_sample(f)
    return (x01 * fb + _gray(x01) * (1.0 - fb)).clamp(0.0, 1.0)


def _rgb_to_hsv(x01: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = x01[..., 0], x01[..., 1], x01[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    positive = delta > 0
    safe = torch.where(positive, delta, torch.ones_like(delta))
    # Sector selection without branches: exactly one term is active.
    h_r = torch.remainder((g - b) / safe, 6.0)
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    h = torch.where(maxc == r, h_r, torch.where(maxc == g, h_g, h_b)) / 6.0
    h = torch.where(positive, h, torch.zeros_like(h))
    lit = maxc > 0
    s = torch.where(lit, delta / torch.where(lit, maxc,
                                             torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices, default):
        # jnp.select: the first true condition wins, in sector order.
        out = default
        for sector in range(4, -1, -1):
            out = torch.where(i == sector, choices[sector], out)
        return out

    r = select((v, q, p, p, t), v)
    g = select((t, v, v, q, p), p)
    b = select((p, p, t, v, v), q)
    return torch.stack([r, g, b], dim=-1)


def adjust_hue(x01: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate HSV hue by ``shift`` (per-sample, in [-0.5, 0.5]): range- and
    luma-order-preserving, so no clamp is needed."""
    h, s, v = _rgb_to_hsv(x01)
    return _hsv_to_rgb(h + shift.reshape(-1, 1, 1), s, v)


def color_jitter(x01: torch.Tensor, params: dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """The jitter chain on [0, 1] RGB NHWC with per-sample factors, in the
    fixed order brightness -> contrast -> saturation -> hue; samples with
    ``apply`` False pass through untouched."""
    y = adjust_brightness(x01, params["brightness"])
    y = adjust_contrast(y, params["contrast"])
    y = adjust_saturation(y, params["saturation"])
    y = adjust_hue(y, params["hue"])
    return torch.where(_per_sample(params["apply"]), y, x01)


def color_jitter_normalised(x: torch.Tensor, params: dict[str, torch.Tensor],
                            mean, std) -> torch.Tensor:
    """Jitter a normalised batch: denormalise to [0, 1] and clamp, jitter,
    renormalise, all in fp32, then cast back to ``x``'s dtype.

    The trainers normalise before they warp (the reference's Compose
    order), so the jitter runs after the warp on normalised values; the
    warp's zero border (normalised zero, i.e. ``mean``) is jittered like
    any pixel.
    """
    mean, std = _stats(tuple(mean), tuple(std), x.device)
    x01 = (x.to(torch.float32) * std + mean).clamp(0.0, 1.0)
    return ((color_jitter(x01, params) - mean) / std).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _stats(mean, std, device: torch.device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mean`` and ``std`` in fp32 on ``device``, shaped to broadcast over
    NHWC, made once per device (as ``ops/augment.py``'s
    ``_scaled_stats``)."""
    def stat(v):
        return torch.tensor(v, dtype=torch.float32,
                            device=device).reshape(1, 1, 1, -1)

    return stat(mean), stat(std)
