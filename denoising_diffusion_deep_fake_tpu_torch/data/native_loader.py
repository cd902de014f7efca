"""ctypes bindings for the port's native (C++) decode and batch loader.

Own copy of ``denoising_diffusion_deep_fake_tpu/data/native_loader.py``
over its own ``csrc/dataloader.cpp`` (a copy of the JAX package's
``native/dataloader.cpp`` with the same C ABI): JPEG/PNG decode, centre
crop and bilinear resize, and batch assembly on a thread pool fill one
preallocated uint8 batch, so Python never touches pixels.

The library is built with g++ against libjpeg and libpng at first use
(``ops/cuda/_build.build_host``, into the git-ignored ``_build/``), never
at import. ``available()`` says whether this machine can have it: g++ and
libjpeg's and libpng's headers, checked by g++'s preprocessor before
anything is built or loaded. A machine without them (the H100 machine has
neither header) decodes through cv2 instead (``data/loader.py``). Where the headers are there, a build or a load that
fails raises: a library built elsewhere that does not load here is a
fault, not a reason to decode another way.

``decode_buffer`` and ``encode_jpeg`` are the server's encoded route
without cv2: ``cv2.imdecode``'s frame (in RGB) and ``cv2.imencode(".jpg")``
at a quality, 4:2:0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "dataloader.cpp", _CSRC / "crop_resize.cpp")
LINK = ("-ljpeg", "-lpng", "-lpthread")
HEADERS = ("jpeglib.h", "png.h")

_lock = threading.Lock()
_lib = None
_error: str | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_int_p = ctypes.POINTER(ctypes.c_int)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.d3f_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int, _u8p]
    lib.d3f_decode_image.restype = ctypes.c_int
    lib.d3f_image_dims.argtypes = [ctypes.c_char_p, _c_int_p, _c_int_p]
    lib.d3f_image_dims.restype = ctypes.c_int
    lib.d3f_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _u8p, _c_int_p]
    lib.d3f_load_batch.restype = ctypes.c_int
    lib.d3f_decode_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, _c_int_p, _c_int_p,
        ctypes.POINTER(_u8p)]
    lib.d3f_decode_buffer.restype = ctypes.c_int
    lib.d3f_encode_jpeg.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.d3f_encode_jpeg.restype = ctypes.c_int
    lib.d3f_free.argtypes = [ctypes.c_void_p]
    lib.d3f_free.restype = None
    return lib


def _load():
    """The library, built on first use; None (and ``_error`` set) where
    this machine lacks g++ or the codecs' headers. A build or load failure
    raises."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            gone = _build.missing_headers(HEADERS)
            if gone:
                _error = f"g++ cannot include {', '.join(gone)} here"
            else:
                _lib = _bind(_build.load_host("d3f_dataloader",
                                              list(SOURCES), LINK))
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why this machine has no library (None when it has one)."""
    _load()
    return _error


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def decode_image(path: str, target_size: int) -> np.ndarray:
    """Decode, centre-crop and resize one image to (target, target, 3) RGB."""
    lib = _lib_or_raise()
    out = np.empty((target_size, target_size, 3), np.uint8)
    if lib.d3f_decode_image(str(path).encode(), target_size,
                            out.ctypes.data_as(_u8p)) != 0:
        raise IOError(f"native decode failed: {path}")
    return out


def image_dims(path: str) -> tuple[int, int]:
    """(width, height) of an image file."""
    lib = _lib_or_raise()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.d3f_image_dims(str(path).encode(), ctypes.byref(w),
                          ctypes.byref(h)) != 0:
        raise IOError(f"native probe failed: {path}")
    return w.value, h.value


def load_batch(paths: list[str], target_size: int, *, n_threads: int = 4,
               out: np.ndarray | None = None) -> np.ndarray:
    """Decode a whole batch into one (N, target, target, 3) uint8 array."""
    lib = _lib_or_raise()
    n = len(paths)
    if out is None:
        out = np.empty((n, target_size, target_size, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    err = ctypes.c_int(-1)
    if lib.d3f_load_batch(arr, n, target_size, n_threads,
                          out.ctypes.data_as(_u8p), ctypes.byref(err)) != 0:
        raise IOError(f"native decode failed: {paths[err.value]}")
    return out


def _take(lib: ctypes.CDLL, ptr, n: int) -> bytes:
    try:
        return ctypes.string_at(ptr, n)
    finally:
        lib.d3f_free(ptr)


def decode_buffer(data: bytes) -> np.ndarray:
    """A JPEG or PNG in memory -> RGB uint8 HWC at its own size."""
    lib = _lib_or_raise()
    w, h, ptr = ctypes.c_int(), ctypes.c_int(), _u8p()
    if lib.d3f_decode_buffer(data, len(data), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(ptr)) != 0:
        raise IOError("native decode of an in-memory image failed")
    pixels = _take(lib, ptr, w.value * h.value * 3)
    return np.frombuffer(pixels, np.uint8).reshape(h.value, w.value, 3)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 HWC -> baseline JPEG bytes at ``quality``, 4:2:0."""
    lib = _lib_or_raise()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes RGB HWC, got {rgb.shape}")
    ptr, n = _u8p(), ctypes.c_size_t()
    if lib.d3f_encode_jpeg(rgb.ctypes.data_as(_u8p), rgb.shape[1],
                           rgb.shape[0], quality, ctypes.byref(ptr),
                           ctypes.byref(n)) != 0:
        raise IOError("native JPEG encode failed")
    return _take(lib, ptr, n.value)


class NativeBatchSource:
    """Batch-granular decode hook for ImageLoader (``load_batch_fn``)."""

    def __init__(self, image_size: int, n_threads: int = 4):
        _lib_or_raise()
        self.image_size = image_size
        self.n_threads = n_threads

    def __call__(self, paths: list[str]) -> np.ndarray:
        return load_batch(paths, self.image_size, n_threads=self.n_threads)
