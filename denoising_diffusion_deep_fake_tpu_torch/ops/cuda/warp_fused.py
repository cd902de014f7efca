"""Fused affine warp with the uint8 normalise folded in.

Replaces the Pallas TPU kernel ``affine_warp_pallas_fused``
(``denoising_diffusion_deep_fake_tpu/ops/pallas/warp_fused.py:140``), the
JAX package's route at the 448^2 operating point. Its contract carries over:
the output is bit-equal to the two-pass warp of the normalised batch, and
the zero border lands in normalised space because the normalise runs before
the warp.

On the H100 it is one launch of ``warp_fused_kernel`` in ``csrc/warp.cu``
with no scratch in device memory: a block owns 32 output columns of one
sample over its full height, runs the x-pass of those columns from the
uint8 NHWC batch into a bf16 strip in shared memory, and the y-pass out of
it straight into fp32 NHWC (the source's notes say how). The U-Net takes
that output as an NCHW ``channels_last`` view, so no transpose is left (the
JAX wrapper needs three). Bound: memory, 1 byte in and 4 out per element:
48.2 MB, 14.4 us at 448^2 x 16 on 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import LAUNCHES
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.warp_kernel import (
    ROWS,
    SMEM_LIMIT,
    _warp_lib,
    affine_warp_twopass_plain,
    check_scalars,
    pass_scalars,
    shear_factors,
)

MAX_CHANNELS = 4  # csrc/warp.cu MAX_C
_STRIP = 32       # output columns a block owns (csrc/warp.cu S)


def strip_bytes(h: int, c: int, dtype: torch.dtype) -> int:
    """Shared memory a block of the fused kernel takes (csrc/warp.cu
    ``launch_fused``): the bf16 strip, rows padded to an odd number of
    32-bit words, and for uint8 input the per-channel table of 256 fp32."""
    pitch = 2 * (((_STRIP * c + 1) // 2) | 1)
    return h * pitch * 2 + (c * 256 * 4 if dtype == torch.uint8 else 0)


def check_fused_shape(h: int, w: int, c: int, dtype: torch.dtype) -> None:
    """Raise where the fused kernel cannot take an NHWC batch."""
    if h % ROWS or w % ROWS:
        raise ValueError(f"H={h}, W={w} must be multiples of {ROWS}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the fused warp takes 1 to {MAX_CHANNELS} "
                         f"channels, not {c}")
    if strip_bytes(h, c, dtype) > SMEM_LIMIT:
        raise ValueError(f"a strip of {h} rows x {c} channels needs "
                         f"{strip_bytes(h, c, dtype)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may use")


def norm_constants(mean, std, channels: int) -> list[float] | None:
    """``[mean*255 per channel] + [std*255 per channel]`` as the fused
    kernel uses them: products taken in float64, then rounded to float32
    (warp_fused.py:160-168)."""
    if mean is None:
        return None
    mean_l = np.asarray(mean, np.float64).reshape(-1).tolist()
    std_l = np.asarray(std, np.float64).reshape(-1).tolist()
    if len(mean_l) == 1:
        mean_l, std_l = mean_l * channels, std_l * channels
    m255 = [float(np.float32(m * 255.0)) for m in mean_l]
    s255 = [float(np.float32(s * 255.0)) for s in std_l]
    return m255 + s255


def affine_warp_fused_plain(images: torch.Tensor, coeffs,
                            norm: list[float] | None) -> torch.Tensor:
    """Plain version: normalise (a true division), then the plain two-pass
    warp, whose tile rounding is the fused kernel's bf16 strip."""
    c = images.shape[-1]
    x = images.to(torch.float32)
    if norm is not None:
        m255 = torch.tensor(norm[:c], dtype=torch.float32, device=x.device)
        s255 = torch.tensor(norm[c:], dtype=torch.float32, device=x.device)
        x = (x - m255) / s255
    out = affine_warp_twopass_plain(x, coeffs)
    return out if norm is not None else out.to(images.dtype)


def launch_fused(src: torch.Tensor, out: torch.Tensor, alpha_x, base_x,
                 resid_x, alpha_y, base_y, resid_y,
                 norm: list[float] | None) -> None:
    """Launch ``warp_fused_kernel`` of ``csrc/warp.cu`` on the current
    stream: the contiguous NHWC batch ``src`` (uint8 or fp32) into the
    contiguous fp32 NHWC ``out``, from each pass's ``pass_scalars`` (the x
    pass over the H rows, the y pass over the W columns)."""
    if src.dim() != 4 or out.shape != src.shape:
        raise ValueError(f"src {tuple(src.shape)} and out "
                         f"{tuple(out.shape)} must be one (B, H, W, C) shape")
    b, h, w, c = src.shape
    check_fused_shape(h, w, c, src.dtype)
    if src.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"the fused warp reads uint8 or fp32, not {src.dtype}")
    if out.dtype != torch.float32:
        raise TypeError(f"the fused warp writes fp32, not {out.dtype}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("src and out must be contiguous NHWC tensors")
    if h * w * c >= 2 ** 31:
        raise ValueError("a sample must have fewer than 2^31 elements")
    operands = (src, out, alpha_x, base_x, resid_x, alpha_y, base_y, resid_y)
    if any(t.device != src.device or t.device.type != "cuda"
           for t in operands):
        raise ValueError("every operand must be on the same CUDA device")
    check_scalars(b, h, alpha_x, base_x, resid_x)
    check_scalars(b, w, alpha_y, base_y, resid_y)
    if norm is not None and len(norm) != 2 * c:
        raise ValueError("norm needs a mean and a std per channel")

    fn = _warp_lib().d3f_warp_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 2,
                       *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 6,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    c_norm = None if norm is None else (ctypes.c_float * len(norm))(*norm)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(int(src.dtype == torch.uint8), src.data_ptr(), out.data_ptr(),
             b, h, w, c, *(t.data_ptr() for t in operands[2:]), c_norm,
             stream)
    if err != 0:
        raise RuntimeError(f"fused warp kernel launch failed: CUDA error "
                           f"{err}")


def affine_warp_fused_coeffs(images: torch.Tensor, coeffs, *, mean=None,
                             std=None) -> torch.Tensor:
    """NHWC in/out warp from inverse-map coefficients. With ``mean``/``std``
    (0-1 scale, per channel or one value) ``images`` may be raw uint8 and
    the output is the normalised, warped fp32 batch."""
    b, h, w, c = images.shape
    src = (images if images.dtype in (torch.uint8, torch.float32)
           else images.to(torch.float32))
    check_fused_shape(h, w, c, src.dtype)
    norm = norm_constants(mean, std, c)
    if images.device.type == "cpu":
        return affine_warp_fused_plain(images, coeffs, norm)
    alpha_x, shift_x, alpha_y, shift_y = shear_factors(coeffs, h, w)
    base_x, resid_x = pass_scalars(alpha_x, shift_x, w)
    base_y, resid_y = pass_scalars(alpha_y, shift_y, h)
    out = torch.empty((b, h, w, c), dtype=torch.float32,
                      device=images.device)
    launch_fused(src.contiguous(), out, alpha_x.contiguous(), base_x,
                 resid_x, alpha_y.contiguous(), base_y, resid_y, norm)
    LAUNCHES["affine_warp_fused"] += 1
    return out if norm is not None else out.to(images.dtype)


def affine_warp_fused(images: torch.Tensor, params: dict, *, mean=None,
                      std=None) -> torch.Tensor:
    """Fused affine warp of an NHWC batch (``affine_warp_pallas_fused``)."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)

    _, h, w, _ = images.shape
    return affine_warp_fused_coeffs(
        images, _inverse_affine_coeffs(params, h, w), mean=mean, std=std)
