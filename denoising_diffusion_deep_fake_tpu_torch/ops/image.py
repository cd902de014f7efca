"""Image normalisation, the TensorBoard panel grid, the centre crop and
the i420 wire format.

Port of ``denoising_diffusion_deep_fake_tpu/ops/image.py:22-233``. Tensors
are NHWC (or HWC) RGB, as in the JAX package.

* ``normalise_uint8_rgb`` / ``denormalise_to_uint8_rgb``: ``(x - mean*255)
  / (std*255)`` and back, with ``mean*255`` and ``std*255`` formed in fp32;
  the way back truncates toward zero, then clamps to [0, 255], like the
  reference's ``tensor.int()`` before its clamp. Product and sum round
  apart, as PyTorch computes them on either device (XLA on the CPU
  contracts them into one multiply-add, which can move a value that lies
  within an ulp of an integer to the other side of it).
* ``make_grid``, ``grid_to_display``, ``panel_grid_u8``: torchvision's
  ``make_grid`` geometry (2-pixel padding before every cell and after the
  last), ``x * 0.5 + 0.5`` clamped to [0, 1], and the uint8 quantisation
  ``(x * 255)`` truncated, as tensorboardX converts.
* ``center_crop_box`` / ``center_crop``: host-side numpy geometry.
* the i420 wire format, 4:2:0-packed uint8 ``(B, H*3/2, W)``, half the
  bytes of RGB: ``rgb_to_i420`` and ``i420_to_rgb`` (BT.601 studio swing,
  the top-left chroma sample of each 2x2 block, nearest 2x2 chroma
  upsample), in fp32 one operation at a time and rounded half to even
  before the uint8 cast, as the JAX package computes them; ``unpack_upload``
  at the top of a train step; ``pack_rgb_batch_to_i420_np`` and
  ``unpack_i420_batch_to_rgb_np`` on the host: cv2's converters
  (``COLOR_RGB2YUV_I420`` / ``COLOR_YUV2RGB_I420``) where cv2 imports, as
  the JAX package's host functions call them, bit for bit; the device
  functions on CPU tensors where it does not (within 1 LSB of cv2's pack
  and 2 of its unpack).
* ``resize_cubic``: ``cv2.resize(..., interpolation=cv2.INTER_CUBIC)`` of
  a uint8 frame, OpenCV's own fixed-point algorithm on CPU tensors, so a
  machine without cv2 resizes as one with it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _channel_constants(values, like: torch.Tensor) -> torch.Tensor:
    """``values * 255`` in fp32, shaped to broadcast over the last axis."""
    return torch.tensor(values, dtype=torch.float32,
                        device=like.device).reshape(-1) * 255.0


def normalise_uint8_rgb(image_rgb: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 (or float) RGB in [0, 255], HWC or NHWC -> normalised fp32."""
    m255 = _channel_constants(mean, image_rgb)
    s255 = _channel_constants(std, image_rgb)
    return (image_rgb.to(torch.float32) - m255) / s255


def denormalise_to_uint8_rgb(tensor: torch.Tensor, mean, std
                             ) -> torch.Tensor:
    """Normalised float -> uint8: ``x * std*255 + mean*255``, truncated
    toward zero, then clamped to [0, 255]."""
    m255 = _channel_constants(mean, tensor)
    s255 = _channel_constants(std, tensor)
    x = torch.trunc(tensor * s255 + m255).to(torch.int32)
    return x.clamp(0, 255).to(torch.uint8)


def make_grid(batch: torch.Tensor, nrow: int = 3, padding: int = 2,
              pad_value: float = 0.0) -> torch.Tensor:
    """Tile an NHWC batch into one HWC image, ``nrow`` images a row."""
    b, h, w, c = batch.shape
    rows = math.ceil(b / nrow)
    cell_h, cell_w = h + padding, w + padding
    grid = torch.full((rows * cell_h + padding, nrow * cell_w + padding, c),
                      pad_value, dtype=batch.dtype, device=batch.device)
    for idx in range(b):
        r, col = divmod(idx, nrow)
        y0, x0 = r * cell_h + padding, col * cell_w + padding
        grid[y0:y0 + h, x0:x0 + w] = batch[idx]
    return grid


def grid_to_display(batch: torch.Tensor, nrow: int = 3) -> torch.Tensor:
    """The first ``nrow**2`` images as a grid, ``x * 0.5 + 0.5`` clamped to
    [0, 1], as the reference logs them."""
    grid = make_grid(batch[:nrow * nrow], nrow=nrow)
    return torch.clamp(grid * 0.5 + 0.5, 0.0, 1.0)


def panel_grid_u8(batch: torch.Tensor, nrow: int = 3) -> torch.Tensor:
    """The display grid quantised to uint8 on the batch's device: a panel
    leaves the step as one small grid instead of the whole fp32 batch."""
    g = grid_to_display(batch.detach().to(torch.float32), nrow=nrow)
    return (g * 255.0).to(torch.uint8)


def center_crop_box(height: int, width: int, target_aspect_w: int,
                    target_aspect_h: int) -> tuple[int, int, int, int]:
    """``(y0, y1, x0, x1)`` of the centred crop with the target aspect
    ratio: the dimension that is too large for it shrinks."""
    target_ratio = target_aspect_w / target_aspect_h
    if width / height > target_ratio:
        new_w = int(round(height * target_ratio))
        x0 = (width - new_w) // 2
        return 0, height, x0, x0 + new_w
    new_h = int(round(width / target_ratio))
    y0 = (height - new_h) // 2
    return y0, y0 + new_h, 0, width


def center_crop(image: np.ndarray, target_aspect_w: int,
                target_aspect_h: int) -> np.ndarray:
    """Host-side centre crop of an HWC array to a target aspect ratio."""
    y0, y1, x0, x1 = center_crop_box(image.shape[0], image.shape[1],
                                     target_aspect_w, target_aspect_h)
    return image[y0:y1, x0:x1]


# ------------------------------------------------------------ i420 packing


def validate_i420_dims(height: int, width: int) -> None:
    """Raise for frame sizes the i420 packing cannot carry: the packed
    layout ravels each (H/2, W/2) chroma plane into quarter-height
    full-width rows, which needs H % 4 == 0 and W % 2 == 0."""
    if height % 4 != 0 or width % 2 != 0:
        raise ValueError(
            f"I420 transfer needs height % 4 == 0 and width % 2 == 0, got "
            f"{height}x{width} — round the frame size (e.g. --height/--width) "
            "to multiples of 4/2 or use transfer='rgb'")


def rgb_to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 255], uint8 or float -> (B, H*3/2, W) uint8
    i420: the Y plane, then U and V, each (H/2, W/2) raveled into H/4
    rows of W."""
    x = rgb.to(torch.float32)
    b, h, w, _ = x.shape
    validate_i420_dims(h, w)
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * bl
    rs, gs, bs = (c[:, ::2, ::2] for c in (r, g, bl))
    u = 128.0 - 0.148 * rs - 0.291 * gs + 0.439 * bs
    v = 128.0 + 0.439 * rs - 0.368 * gs - 0.071 * bs
    packed = torch.cat([y, u.reshape(b, h // 4, w), v.reshape(b, h // 4, w)],
                       dim=1)
    return torch.round(packed).clamp(0, 255).to(torch.uint8)


def i420_to_rgb(i420: torch.Tensor) -> torch.Tensor:
    """(B, H*3/2, W) uint8 i420 -> (B, H, W, 3) fp32 RGB in [0, 255]."""
    x = i420.to(torch.float32)
    b, h15, w = x.shape
    if h15 % 3 != 0:
        raise ValueError(f"I420 packed height must be H*3/2, got {h15}")
    h = h15 * 2 // 3
    validate_i420_dims(h, w)
    y = x[:, :h]
    u = x[:, h:h + h // 4].reshape(b, h // 2, w // 2)
    v = x[:, h + h // 4:].reshape(b, h // 2, w // 2)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yc = 1.164 * (y - 16.0)
    uc, vc = u - 128.0, v - 128.0
    r = yc + 1.596 * vc
    g = yc - 0.813 * vc - 0.391 * uc
    bl = yc + 2.018 * uc
    return torch.stack([r, g, bl], dim=-1).clamp(0.0, 255.0)


def unpack_upload(batch: torch.Tensor, upload_format: str) -> torch.Tensor:
    """The start of a train step: ``rgb`` batches pass through as uint8,
    ``i420`` batches become fp32 RGB in [0, 255]; the warp and the
    normalise take either."""
    if upload_format == "i420":
        return i420_to_rgb(batch)
    return batch


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``a`` (copied where ``a`` is read-only, as a request
    body's frames are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _cv2():
    from denoising_diffusion_deep_fake_tpu_torch.data.codec import (
        cv2_or_none)
    return cv2_or_none()


def pack_rgb_batch_to_i420_np(batch: np.ndarray) -> np.ndarray:
    """Host (B, H, W, 3) RGB uint8 -> (B, H*3/2, W) uint8 i420: cv2's
    ``COLOR_RGB2YUV_I420`` frame by frame where cv2 imports (the JAX
    package's function), else ``rgb_to_i420`` on CPU tensors."""
    cv2 = _cv2()
    if cv2 is None:
        return rgb_to_i420(_host_tensor(batch)).numpy()
    b, h, w, _ = batch.shape
    validate_i420_dims(h, w)
    out = np.empty((b, h * 3 // 2, w), dtype=np.uint8)
    for i in range(b):
        out[i] = cv2.cvtColor(np.ascontiguousarray(batch[i]),
                              cv2.COLOR_RGB2YUV_I420)
    return out


def unpack_i420_batch_to_rgb_np(packed: np.ndarray) -> np.ndarray:
    """Host (B, H*3/2, W) uint8 i420 -> (B, H, W, 3) RGB uint8: cv2's
    ``COLOR_YUV2RGB_I420`` frame by frame where cv2 imports (the JAX
    package's function), else ``i420_to_rgb`` on CPU tensors, rounded half
    to even."""
    cv2 = _cv2()
    if cv2 is None:
        return torch.round(i420_to_rgb(_host_tensor(packed))).to(
            torch.uint8).numpy()
    b, h15, w = packed.shape
    out = np.empty((b, h15 * 2 // 3, w, 3), dtype=np.uint8)
    for i in range(b):
        out[i] = cv2.cvtColor(np.ascontiguousarray(packed[i]),
                              cv2.COLOR_YUV2RGB_I420)
    return out


# cv2.resize's INTER_CUBIC on uint8 (imgproc/src/resize.cpp): Keys' kernel
# with A = -0.75, taps at the source position (d + 0.5) * scale - 0.5 with
# the borders clamped, coefficients rounded to 11 fractional bits
# (INTER_RESIZE_COEF_SCALE), a horizontal pass in integers, then a
# vertical pass whose elements up to the last multiple of 8 of a row run in
# fp32 (VResizeCubicVec_32s8u at the 128-bit width of OpenCV's baseline
# build: the taps over 2^22, multiply-adds rounded apart, rounded half to
# even) and the rest in integers (round half up, shift 22). Bit-equal to
# cv2 5.0's own resize on random frames of 8-96 pixels, 1 and 3 channels.
_CUBIC_A = np.float32(-0.75)
_COEF_SCALE = 2048
_VEC_ELEMENTS = 8


@functools.lru_cache(maxsize=64)
def _cubic_taps(dst: int, src: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst, 4) source indices and int coefficients, as cv2 forms them:
    numpy's float32 arrays round each operation as cv2's scalar code."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    one, a = np.float32(1.0), _CUBIC_A
    xp = x + one
    c0 = ((a * xp - np.float32(5) * a) * xp + np.float32(8) * a) * xp \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    xm = one - x
    c2 = ((a + np.float32(2)) * xm - (a + np.float32(3))) * xm * xm + one
    c3 = one - c0 - c1 - c2
    coef = np.rint(np.stack([c0, c1, c2, c3], 1) * np.float32(_COEF_SCALE))
    index = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                    src - 1)
    return torch.from_numpy(index), torch.from_numpy(coef.astype(np.int32))


def resize_cubic(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 HWC (1 or 3 channels) or HW frame -> ``size`` = (width,
    height), as ``cv2.resize(image, size, interpolation=cv2.INTER_CUBIC)``
    with OpenCV's own implementation (not IPP's)."""
    width, height = size
    src = _host_tensor(image)
    if src.dtype != torch.uint8 or src.ndim not in (2, 3):
        raise ValueError(f"resize_cubic takes uint8 HW or HWC, got "
                         f"{tuple(src.shape)} {src.dtype}")
    flat = src.ndim == 2
    if flat:
        src = src[..., None]
    h, w, c = src.shape
    if (w, h) == (width, height):
        return image.copy()
    x_index, x_coef = _cubic_taps(width, w)
    y_index, y_coef = _cubic_taps(height, h)
    # Horizontal: (h, width, c) integer sums of 4 taps, then the vertical
    # taps of those rows. int32 holds both passes: |rows| < 2^20 and a
    # vertical sum stays below 2^31.
    src = src.to(torch.int32)
    rows = src.index_select(1, x_index[:, 0]) * x_coef[:, 0].reshape(1, -1, 1)
    for k in (1, 2, 3):
        rows += src.index_select(1, x_index[:, k]) * x_coef[:, k].reshape(
            1, -1, 1)
    rows = rows.reshape(h, width * c)
    taps = [rows.index_select(0, y_index[:, k]) for k in range(4)]
    fixed = taps[0] * y_coef[:, 0, None]
    for k in (1, 2, 3):
        fixed += taps[k] * y_coef[:, k, None]
    fixed = (fixed + (1 << 21)) >> 22
    beta = y_coef.to(torch.float32) * (1.0 / (_COEF_SCALE * _COEF_SCALE))
    acc = taps[3].to(torch.float32) * beta[:, 3, None]
    for k in (2, 1, 0):
        acc = taps[k].to(torch.float32) * beta[:, k, None] + acc
    n_vec = (width * c) // _VEC_ELEMENTS * _VEC_ELEMENTS
    out = fixed.clamp_(0, 255)
    out[:, :n_vec] = torch.round(acc[:, :n_vec]).clamp(0, 255).to(
        torch.int32)
    out = out.to(torch.uint8).reshape(height, width, c).numpy()
    return out[..., 0] if flat else out
