"""Image normalisation, the TensorBoard panel grid and the centre crop.

Port of ``denoising_diffusion_deep_fake_tpu/ops/image.py:22-122``. Tensors
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

The i420 wire format (JAX ``:135-233``) is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

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
