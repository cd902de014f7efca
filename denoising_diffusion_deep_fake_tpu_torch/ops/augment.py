"""Batched augmentation on the device: random affine warps + normalisation.

Port of ``denoising_diffusion_deep_fake_tpu/ops/augment.py`` (``:38-408``).
Kornia ``RandomAffine`` / albumentations ``ShiftScaleRotate`` semantics:
per-sample inverse-affine bilinear resampling with a constant-zero border,
applied after normalisation, so the border is normalised zero.

The warp methods: ``pallas_fused`` and ``pallas``, the CUDA kernels of the
LDU-shear warp (``ops/cuda/``); ``gather``, the direct 4-tap bilinear
warp; ``shear`` and ``hybrid``, the JAX package's XLA layouts of the same
LDU-shear factorisation (``affine_warp_shear``, ``affine_warp_hybrid``),
in plain PyTorch here: windowed multiply-accumulates over shifted slices,
no gathers (``shear``), or a per-sample scale matmul, a block-quantised
shift and a small residual window (``hybrid``).

Angle convention: positive = counter-clockwise, like
cv2.getRotationMatrix2D; rotation centre (W/2, H/2) in pixel coordinates.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

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


def _resample_axis(img: torch.Tensor, alpha: torch.Tensor,
                   shift: torch.Tensor, taps_lo: int, taps_hi: int,
                   axis: int) -> torch.Tensor:
    """1-D linear resample along ``axis`` (2 = x, 1 = y) of NHWC images:
    ``out[..., t, ...] = img[..., alpha * t + shift, ...]`` (per-sample
    ``alpha``; ``shift`` varies along the other spatial axis), as a
    windowed multiply-accumulate over static slices: for each integer tap
    offset k, the weight ``hat(src - (t + k))`` picks out the two bilinear
    taps. ``taps_lo``/``taps_hi`` bound ``src - t``; samples outside the
    image contribute zero (cv2 BORDER_CONSTANT)."""
    n = img.shape[axis]
    pad = [0, 0] * (img.dim() - axis)
    pad[-2:] = [taps_lo, taps_hi + 1]
    padded = F.pad(img, pad)
    ts = torch.arange(n, dtype=torch.float32, device=img.device)
    if axis == 2:
        # alpha: (B,), shift: (B, H); offset(b, y, x) = src - x.
        offset = (alpha[:, None, None] - 1.0) * ts + shift[:, :, None]
    else:
        # alpha: (B,), shift: (B, W); offset(b, y, x) = src - y.
        offset = ((alpha[:, None, None] - 1.0) * ts[:, None]
                  + shift[:, None, :])
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for k in range(-taps_lo, taps_hi + 1):
        w = (1.0 - (offset - k).abs()).clamp(0.0, 1.0)
        out = out + w[..., None] * padded.narrow(axis, taps_lo + k, n)
    return out


def _shear_tap_bounds(height: int, width: int,
                      cfg: AffineAugmentConfig) -> tuple[int, int]:
    """Static bound on |src - t| for both shear passes given the config's
    ranges."""
    inv_scale = 1.0 / cfg.scale_min          # worst-case magnification
    tan_t = math.tan(math.radians(cfg.degrees))
    half = max(height, width) / 2.0
    # scale term + rotation shear term + translation (+1 slack)
    bound = (abs(inv_scale - 1.0) * half
             + inv_scale * tan_t * half
             + cfg.translate * max(height, width) * inv_scale
             + 2.0)
    k = int(math.ceil(bound))
    return k, k


def _ldu_x_pass(coeffs, h: int, device) -> tuple[torch.Tensor, ...]:
    """The x-pass of the LDU factorisation ``Minv = [[1, 0], [l, 1]] @
    diag(d1, d2) @ [[1, u], [0, 1]]``: its per-sample scale and per-row
    shift (B, H)."""
    i00, i01, i10, i11, itx, ity = coeffs
    alpha_x = i00 - i01 * i10 / i11           # d1
    vs = torch.arange(h, dtype=torch.float32, device=device)
    shift_x = ((i01 / i11)[:, None] * vs[None, :]
               + (itx - i01 * ity / i11)[:, None])
    return alpha_x, shift_x


def _ldu_y_shift(coeffs, w: int, device) -> torch.Tensor:
    """The y-pass's per-column shift (B, W); its scale is ``i11``."""
    _, _, i10, _, _, ity = coeffs
    xs = torch.arange(w, dtype=torch.float32, device=device)
    return i10[:, None] * xs[None, :] + ity[:, None]


def affine_warp_shear(images: torch.Tensor, params: dict[str, torch.Tensor],
                      taps: tuple[int, int]) -> torch.Tensor:
    """The affine warp as two 1-D resamples (JAX ``:173-204``): the LDU
    shear factorisation of the inverse map, one per-row x-resample then
    one per-column y-resample, each a windowed-MAC ``_resample_axis``
    pass of ``taps`` (``_shear_tap_bounds``)."""
    b, h, w, c = images.shape
    coeffs = _inverse_affine_coeffs(params, h, w)
    alpha_x, shift_x = _ldu_x_pass(coeffs, h, images.device)
    t = _resample_axis(images.to(torch.float32), alpha_x, shift_x,
                       taps[0], taps[1], axis=2)
    out = _resample_axis(t, coeffs[3], _ldu_y_shift(coeffs, w, images.device),
                         taps[0], taps[1], axis=1)
    return out.to(images.dtype)


def _hybrid_axis_pass(img: torch.Tensor, alpha: torch.Tensor,
                      shift: torch.Tensor, *, block: int = 32, k: int = 12,
                      pad: int | None = None) -> torch.Tensor:
    """1-D resample along x, ``out[b, v, x] = img[b, v, alpha_b * x +
    shift(b, v)]`` (JAX ``:207-268``), in three steps whose cost does not
    grow with the displacement:

    1. the per-sample scale about the centre as an interpolation matmul
       with a banded hat matrix;
    2. the remaining per-row displacement, quantised to its value at the
       centre of each ``block``-row group, as one slice per (sample,
       group);
    3. the in-block residual (bounded by ``k``) as a windowed MAC.
    """
    b_, h, w, c = img.shape
    if h % block:
        raise ValueError(f"the hybrid warp needs sides divisible by "
                         f"{block}, got {h}")
    dev = img.device
    cx = w / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev)

    # 1) scale about the centre: g[x] = img[alpha (x - cx) + cx]
    src = alpha[:, None] * (xs[None, :] - cx) + cx          # (B, W_out)
    weights = (1.0 - (src[:, None, :] - xs[None, :, None]).abs()).clamp(
        0.0, 1.0)                                           # (B, W_in, W_out)
    g = torch.einsum("bhuc,buo->bhoc", img, weights)

    # Displacement in g's coordinates: g[x + d] = img[alpha x + shift].
    d = (shift - (1.0 - alpha[:, None]) * cx) / alpha[:, None]   # (B, H)

    # 2) the block-quantised integer part, one slice per (sample, group).
    if pad is None:
        pad = w // 2 + k
    nb = h // block
    d_blocks = d.reshape(b_, nb, block)
    base = torch.round(d_blocks[:, :, block // 2]).to(torch.int64)
    width = w + 2 * pad + 1
    blocks = F.pad(g, (0, 0, pad, pad + 1)).reshape(b_, nb, block, width, c)
    span = w + 2 * k + 1
    starts = (pad + base - k).clamp(0, width - span)          # (B, nb)
    index = starts[:, :, None] + torch.arange(span, device=dev)
    window = torch.gather(blocks, 3, index[:, :, None, :, None].expand(
        b_, nb, block, span, c))                        # (B, nb, block, span, C)
    applied = starts - pad + k                                # (B, nb)

    # 3) the residual windowed MAC: r = d - applied, |r| <= k.
    r = d_blocks - applied[:, :, None]                        # (B, nb, block)
    out = torch.zeros((b_, nb, block, w, c), dtype=torch.float32,
                      device=dev)
    for j in range(2 * k + 1):
        wgt = (1.0 - (r - (j - k)).abs()).clamp(0.0, 1.0)
        out = out + wgt[..., None, None] * window[:, :, :, j:j + w, :]
    return out.reshape(b_, h, w, c)


def affine_warp_hybrid(images: torch.Tensor,
                       params: dict[str, torch.Tensor]) -> torch.Tensor:
    """The LDU shear warp through ``_hybrid_axis_pass`` (JAX ``:271-295``):
    the x-pass, then the y-pass on the transposed image; both sides must
    be multiples of 32."""
    b, h, w, c = images.shape
    coeffs = _inverse_affine_coeffs(params, h, w)
    alpha_x, shift_x = _ldu_x_pass(coeffs, h, images.device)
    t = _hybrid_axis_pass(images.to(torch.float32), alpha_x, shift_x)
    out_t = _hybrid_axis_pass(t.transpose(1, 2), coeffs[3],
                              _ldu_y_shift(coeffs, w, images.device))
    return out_t.transpose(1, 2).to(images.dtype)


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


def select_warp_method(h: int, w: int, cfg: AffineAugmentConfig) -> str:
    """Resolve ``method="auto"`` for an HxW batch: the JAX package's table
    (augment.py:341-366 on one device, "tpu" read as "cuda").

    * 32-aligned, 384^2 <= size <= 512^2: ``pallas_fused``, the fused warp
      kernel with the uint8 normalise folded in (the 448^2 main path);
    * 32-aligned above 512^2: ``pallas``, the two-pass warp kernels;
    * other 32-aligned sizes: ``hybrid``, the scale matmul, block roll and
      residual MAC in plain PyTorch;
    * not 32-aligned with a tap window (``_shear_tap_bounds`` of ``cfg``)
      of at most 64: ``shear``, the windowed-MAC passes;
    * otherwise ``gather``, the direct bilinear warp.

    The route does not depend on the device: on a CPU tensor each kernel
    wrapper runs its plain version, which computes the same function.
    """
    if h % 32 == 0 and w % 32 == 0 and min(h, w) >= 384:
        return "pallas_fused" if max(h, w) <= 512 else "pallas"
    if h % 32 == 0 and w % 32 == 0:
        return "hybrid"
    if _shear_tap_bounds(h, w, cfg)[0] <= 64:
        return "shear"
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
        method = select_warp_method(h, w, cfg)
    if method == "pallas_fused":
        return affine_warp_fused(batch_uint8, params, mean=mean,
                                 std=std).to(dtype)
    x = normalise_batch(batch_uint8, mean, std)
    if method == "shear":
        return affine_warp_shear(x, params,
                                 _shear_tap_bounds(h, w, cfg)).to(dtype)
    if method == "hybrid":
        return affine_warp_hybrid(x, params).to(dtype)
    if method == "pallas":
        return affine_warp_twopass(x, params).to(dtype)
    if method == "gather":
        return affine_warp(x, params).to(dtype)
    raise ValueError(f"unknown warp method {method!r}")
