"""What the port decodes, encodes and resizes images with, by the JAX
package's rule: the native library (libjpeg and libpng,
``data/native_loader.py``) where it builds, else cv2.

* ``decode_bytes``: one encoded image in memory -> RGB (the server's
  ``cv2.imdecode`` without cv2): the native library's ``decode_buffer``.
* ``encode_jpeg``: RGB -> JPEG bytes at a quality, 4:2:0 (the server's
  ``cv2.imencode`` without cv2): the native library's ``encode_jpeg``.
* ``cubic_resizer``: cv2's ``INTER_CUBIC`` resize where cv2 imports (as the
  JAX package resizes), else ``ops.image.resize_cubic``, OpenCV's own
  algorithm without cv2.

Where neither the native library nor cv2 can serve, the error names what
is missing; nothing falls back quietly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from denoising_diffusion_deep_fake_tpu_torch.data import native_loader
from denoising_diffusion_deep_fake_tpu_torch.ops.image import resize_cubic


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
    return f"no codec for {what} here: {native}, and cv2 does not import"


def _native_or_raise(what: str) -> None:
    if not native_loader.available():
        raise RuntimeError(missing(what))


def decode_bytes(blob: bytes) -> np.ndarray:
    """One JPEG or PNG in memory -> RGB uint8 HWC at its own size."""
    _native_or_raise("an image in memory")
    return native_loader.decode_buffer(blob)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 HWC -> JPEG bytes at ``quality``, 4:2:0."""
    _native_or_raise("JPEG encoding")
    return native_loader.encode_jpeg(rgb, quality)
