"""Batched augmentation on the device: random affine warps + normalisation.

Port of ``denoising_diffusion_deep_fake_tpu/ops/augment.py`` (``:38-118,
298-338, 341-408``). Kornia ``RandomAffine`` / albumentations
``ShiftScaleRotate`` semantics: per-sample inverse-affine bilinear
resampling with a constant-zero border, applied after normalisation, so the
border is normalised zero.

Angle convention: positive = counter-clockwise, like
cv2.getRotationMatrix2D; rotation centre (W/2, H/2) in pixel coordinates.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.warp_fused import (
    affine_warp_fused,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.warp_kernel import (
    affine_warp_twopass,
)


@dataclasses.dataclass(frozen=True)
class AffineAugmentConfig:
    """Parameter ranges for the random affine family."""

    degrees: float = 15.0          # rotation in [-degrees, +degrees]
    translate: float = 0.2         # shift fraction of H/W per axis
    scale_min: float = 0.9
    scale_max: float = 1.1
    probability: float = 1.0       # per-sample apply probability

    @classmethod
    def shift_scale_rotate(cls, shift_limit=0.2, scale_limit=0.1,
                           rotate_limit=15.0, p=0.7):
        """albumentations ShiftScaleRotate ranges (deep-fake workload)."""
        return cls(degrees=rotate_limit, translate=shift_limit,
                   scale_min=1.0 - scale_limit, scale_max=1.0 + scale_limit,
                   probability=p)

    @classmethod
    def random_affine(cls, degrees=15.0, translate=0.2, scale_min=0.8,
                      scale_max=1.2, p=1.0):
        """Kornia RandomAffine ranges (denoiser workload)."""
        return cls(degrees=degrees, translate=translate, scale_min=scale_min,
                   scale_max=scale_max, probability=p)


def sample_affine_params(batch_size: int, cfg: AffineAugmentConfig, *,
                         generator: torch.Generator | None = None,
                         device=None) -> dict[str, torch.Tensor]:
    """Per-sample (angle in degrees, scale, shift_x_frac, shift_y_frac,
    apply) draws."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch_size, generator=generator,
                                           device=device)

    angle = u(-cfg.degrees, cfg.degrees)
    scale = u(cfg.scale_min, cfg.scale_max)
    tx = u(-cfg.translate, cfg.translate)
    ty = u(-cfg.translate, cfg.translate)
    apply = torch.rand(batch_size, generator=generator,
                       device=device) < cfg.probability
    return {"angle": angle, "scale": scale, "tx": tx, "ty": ty,
            "apply": apply}


def _inverse_affine_coeffs(params: dict[str, torch.Tensor], height: int,
                           width: int) -> tuple[torch.Tensor, ...]:
    """dst->src affine coefficients per sample (6 fp32 scalars each).

    Forward map (cv2 convention): rotate by ``angle`` CCW + scale about the
    image centre, then shift by (tx*W, ty*H). Identity where ``apply`` is
    False.
    """
    theta = torch.deg2rad(params["angle"].to(torch.float32))
    s = params["scale"].to(torch.float32)
    a, b = s * torch.cos(theta), s * torch.sin(theta)
    cx, cy = width / 2.0, height / 2.0
    fx = params["tx"].to(torch.float32) * width
    fy = params["ty"].to(torch.float32) * height
    # Forward: dst = M src + t, M = [[a, b], [-b, a]].
    tx_full = (1.0 - a) * cx - b * cy + fx
    ty_full = b * cx + (1.0 - a) * cy + fy
    # Inverse: det(M) = a^2 + b^2 and M^-1 = [[a, -b], [b, a]] / det.
    det = a * a + b * b
    inv00 = a / det
    inv01 = -b / det
    inv10 = b / det
    inv11 = a / det
    itx = -(inv00 * tx_full + inv01 * ty_full)
    ity = -(inv10 * tx_full + inv11 * ty_full)

    apply = params["apply"].to(torch.bool)
    zero = torch.zeros_like(inv00)
    one = torch.ones_like(inv00)
    return (torch.where(apply, inv00, one), torch.where(apply, inv01, zero),
            torch.where(apply, inv10, zero), torch.where(apply, inv11, one),
            torch.where(apply, itx, zero), torch.where(apply, ity, zero))


def affine_warp(images: torch.Tensor, params: dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """Per-sample affine warp of an NHWC batch, direct 4-tap bilinear
    gather, zero border (the reference semantics)."""
    b, h, w, c = images.shape
    coeffs = _inverse_affine_coeffs(params, h, w)
    i00, i01, i10, i11, itx, ity = (v[:, None, None] for v in coeffs)
    dev = images.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    sx = i00 * xx + i01 * yy + itx
    sy = i10 * xx + i11 * yy + ity
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = images.reshape(b, h * w, c)

    def tap(yi, xi, weight):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c))
        return vals.reshape(b, h, w, c) * (weight * valid)[..., None]

    out = (tap(y0i, x0i, (1 - wx) * (1 - wy))
           + tap(y0i, x0i + 1, wx * (1 - wy))
           + tap(y0i + 1, x0i, (1 - wx) * wy)
           + tap(y0i + 1, x0i + 1, wx * wy))
    return out.to(images.dtype)


def normalise_batch(batch_uint8: torch.Tensor, mean, std,
                    dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised float: ``(x - mean*255) / (std*255)``."""
    mean, std = _scaled_stats(_hashable(mean), _hashable(std),
                              batch_uint8.device)
    return ((batch_uint8.to(torch.float32) - mean) / std).to(dtype)


def _hashable(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@functools.lru_cache(maxsize=None)
def _scaled_stats(mean, std, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mean*255`` and ``std*255`` in fp32 on ``device``, shaped to
    broadcast over NHWC, made once per device: a step captured in a CUDA
    graph may copy nothing from the host."""
    def scaled(v):
        return torch.tensor(v, dtype=torch.float32, device=device).reshape(
            1, 1, 1, -1) * 255.0

    return scaled(mean), scaled(std)


def select_warp_method(h: int, w: int) -> str:
    """Resolve ``method="auto"`` for an HxW batch (augment.py:341-366 with
    "tpu" read as "cuda").

    * 32-aligned, 384^2 <= size <= 512^2: ``pallas_fused``, the fused warp
      kernel with the uint8 normalise folded in (the 448^2 main path).
    * every other 32-aligned size: ``pallas``, the two-pass warp kernel.
      Above 512^2 that is the JAX routing; below 384^2 it stands in for the
      JAX ``hybrid`` route, an XLA layout of the same LDU-shear math that
      differs from the kernels only in not rounding to bf16.
    * not 32-aligned: ``gather``, the direct bilinear warp. JAX takes its
      XLA ``shear`` layout there when the tap window is at most 64 (100^2,
      say); the port has no XLA layouts.

    The route does not depend on the device: on a CPU tensor each kernel
    wrapper runs its plain version, which computes the same function.
    """
    if h % 32 == 0 and w % 32 == 0:
        if min(h, w) >= 384 and max(h, w) <= 512:
            return "pallas_fused"
        return "pallas"
    return "gather"


def augment_batch(batch_uint8: torch.Tensor, mean, std,
                  cfg: AffineAugmentConfig, *,
                  generator: torch.Generator | None = None,
                  params: dict | None = None, dtype=torch.float32,
                  method: str = "auto") -> torch.Tensor:
    """Normalise -> random affine warp (the on-device data path), in the
    reference's Compose order so the zero border is normalised zero.

    ``params`` (from ``sample_affine_params``) may be given; else they are
    drawn from ``generator``.
    """
    b, h, w, _ = batch_uint8.shape
    if params is None:
        params = sample_affine_params(b, cfg, generator=generator,
                                      device=batch_uint8.device)
    if method == "auto":
        method = select_warp_method(h, w)
    if method == "pallas_fused":
        return affine_warp_fused(batch_uint8, params, mean=mean,
                                 std=std).to(dtype)
    if method in ("shear", "hybrid"):
        raise NotImplementedError(
            f"warp_method={method!r} is an XLA layout of the LDU-shear warp; "
            "the port computes that math in its 'pallas' and 'pallas_fused' "
            "kernels")
    x = normalise_batch(batch_uint8, mean, std)
    if method == "pallas":
        return affine_warp_twopass(x, params).to(dtype)
    if method == "gather":
        return affine_warp(x, params).to(dtype)
    raise ValueError(f"unknown warp method {method!r}")
