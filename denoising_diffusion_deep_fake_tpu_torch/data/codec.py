"""The port's JPEG/PNG codec where cv2 does not import.

* ``decode_files``: files -> RGB uint8 HWC at their own size. JPEG through
  nvJPEG on the CUDA device (one batched decode, copied back,
  ``data/nvjpeg.py``), PNG through ``data/png.py``.
* ``decode_bytes``: one encoded image in memory -> RGB (the server's
  ``cv2.imdecode``): the native library's ``decode_buffer`` where it
  builds, else nvJPEG (JPEG) or ``data/png.py`` (PNG).
* ``encode_jpeg``: RGB -> JPEG bytes at a quality, 4:2:0 (the server's
  ``cv2.imencode``): the native library where it builds, else nvJPEG.
* ``cubic_resizer``: cv2's ``INTER_CUBIC`` resize where cv2 imports (as the
  JAX package resizes), else ``ops.image.resize_cubic``, OpenCV's own
  algorithm without cv2.

Where none can serve a format, the error names what is missing; nothing
falls back quietly.
"""

from __future__ import annotations

from pathlib import Path

from typing import Callable

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.data import (
    native_loader,
    nvjpeg,
    png,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import resize_cubic

JPEG_MAGIC = b"\xff\xd8\xff"


def cv2_or_none():
    """cv2, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


Resize = Callable[[np.ndarray, tuple[int, int]], np.ndarray]


def cubic_resizer() -> Resize:
    """``resize(frame, (width, height))``: cv2's ``INTER_CUBIC`` where cv2
    imports, else ``resize_cubic`` (bit-equal to OpenCV's own code; cv2's
    default IPP resize is within 1 LSB of it)."""
    cv2 = cv2_or_none()
    if cv2 is None:
        return resize_cubic
    return lambda frame, size: cv2.resize(frame, size,
                                          interpolation=cv2.INTER_CUBIC)


def cv2_read_rgb(cv2, path: str) -> np.ndarray:
    """A JPEG/PNG file -> RGB uint8 HWC through ``cv2.imread`` (BGR)."""
    image = cv2.imread(path)
    if image is None:
        raise IOError(f"failed to decode image: {path}")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def missing(what: str) -> str:
    reason = native_loader.unavailable_reason()
    native = (f"there is no native loader ({reason})" if reason
              else "the native loader is off (use_native=False)")
    return (f"no codec for {what} here: {native}, cv2 does not import, "
            f"and nvJPEG needs a CUDA device, which this machine lacks")


def _nvjpeg_or_raise(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(missing(what))
    return nvjpeg.codec()


def decode_files(paths: list[str]) -> list[np.ndarray]:
    """JPEG files through nvJPEG (one batched decode), PNG files through
    ``data/png.py``; RGB uint8 HWC at each file's own size."""
    blobs = [Path(p).read_bytes() for p in paths]
    frames: list = [None] * len(paths)
    jpegs = []
    for i, blob in enumerate(blobs):
        if png.is_png(blob):
            frames[i] = png.decode_png(blob)
        elif blob[:3] == JPEG_MAGIC:
            jpegs.append(i)
        else:
            raise IOError(f"failed to decode image (neither JPEG nor PNG): "
                          f"{paths[i]}")
    if jpegs:
        _nvjpeg_or_raise(f"the JPEG {paths[jpegs[0]]}")
        decoded = nvjpeg.decode_to_host([blobs[i] for i in jpegs])
        for i, frame in zip(jpegs, decoded):
            frames[i] = frame
    return frames


def decode_bytes(blob: bytes) -> np.ndarray:
    """One JPEG or PNG in memory -> RGB uint8 HWC at its own size."""
    if native_loader.available():
        return native_loader.decode_buffer(blob)
    if png.is_png(blob):
        return png.decode_png(blob)
    if blob[:3] != JPEG_MAGIC:
        raise ValueError("not a JPEG or PNG image")
    _nvjpeg_or_raise("a JPEG")
    return nvjpeg.decode_to_host([blob])[0]


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 HWC -> JPEG bytes at ``quality``, 4:2:0."""
    if native_loader.available():
        return native_loader.encode_jpeg(rgb, quality)
    return _nvjpeg_or_raise("JPEG encoding").encode(rgb, quality)
