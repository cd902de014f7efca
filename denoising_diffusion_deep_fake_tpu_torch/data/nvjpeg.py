"""JPEG decode and encode on the card, through the CUDA toolkit's nvJPEG.

The port's JPEG codec for a machine with a CUDA device and neither
libjpeg's headers nor cv2 (the H100 machine has no libjpeg). A C ABI over
``libnvjpeg`` (``csrc/nvjpeg_codec.cpp``) is built with nvcc at first use
(``ops/cuda/_build.build``, ``-lnvjpeg``), never at import, and bound with
ctypes as the port's kernels are:

* ``decode_batch``: ``nvjpegDecodeBatched`` into interleaved RGB uint8
  HWC tensors that torch allocated on the card, on torch's current stream;
  frames of one size share one (N, H, W, 3) tensor;
* ``encode``: ``nvjpegEncodeImage`` of an RGB HWC frame at a quality,
  4:2:0, for the server and for datasets written on the card.

nvJPEG's default backend decodes; the hardware JPEG engines
(``NVJPEG_BACKEND_HARDWARE``) are later work. nvJPEG's IDCT and chroma
upsampling are not libjpeg's, so its frames differ from cv2's by a few
LSB (``PERF.md``). A CPU tensor raises: there is no host nvJPEG.
``DECODED`` counts the frames decoded on the card.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "nvjpeg_codec.cpp"
LINK = ("-lnvjpeg",)
DECODED: collections.Counter = collections.Counter()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_lock = threading.Lock()
_codecs: dict[int, "NvJpegCodec"] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load("d3f_nvjpeg", SOURCE, LINK)
    lib.d3f_nvjpeg_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.d3f_nvjpeg_destroy.argtypes = [ctypes.c_void_p]
    lib.d3f_nvjpeg_destroy.restype = None
    lib.d3f_nvjpeg_info.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, _c_int_p,
        _c_int_p, _c_int_p, _c_int_p]
    lib.d3f_nvjpeg_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), _c_int_p, ctypes.c_void_p]
    lib.d3f_nvjpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_u8p),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.d3f_nvjpeg_free.argtypes = [ctypes.c_void_p]
    lib.d3f_nvjpeg_free.restype = None
    return lib


def _check(rc: int, what: str) -> None:
    if rc >= 1000:
        raise RuntimeError(f"nvJPEG {what}: CUDA error {rc - 1000}")
    if rc != 0:
        raise RuntimeError(f"nvJPEG {what} failed: nvjpegStatus_t {rc}")


class NvJpegCodec:
    """One nvJPEG handle, decoder and encoder state on one device; a lock
    makes it safe to share between threads."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lib = _library()
        self._ctx = ctypes.c_void_p()
        self._lock = threading.Lock()
        # The host helpers' stream: a loader thread's decode does not
        # queue behind the training step's kernels.
        self.stream = torch.cuda.Stream(device)
        with torch.cuda.device(device):
            _check(self._lib.d3f_nvjpeg_create(ctypes.byref(self._ctx)),
                   "create")

    def info(self, blob: bytes) -> tuple[int, int]:
        """(width, height) of a JPEG bitstream."""
        w, h, comps, css = (ctypes.c_int() for _ in range(4))
        _check(self._lib.d3f_nvjpeg_info(
            self._ctx, blob, len(blob), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(comps), ctypes.byref(css)), "image info")
        return w.value, h.value

    def decode_batch(self, blobs: list[bytes]
                     ) -> torch.Tensor | list[torch.Tensor]:
        """JPEG bitstreams -> RGB uint8 on the card: one (N, H, W, 3)
        tensor when the frames share a size, else a list of HWC tensors."""
        n = len(blobs)
        dims = [self.info(b) for b in blobs]
        batch = None
        if len(set(dims)) == 1:
            w, h = dims[0]
            batch = torch.empty((n, h, w, 3), dtype=torch.uint8,
                                device=self.device)
            outs = list(batch.unbind(0))
        else:
            outs = [torch.empty((h, w, 3), dtype=torch.uint8,
                                device=self.device) for w, h in dims]
        stream = torch.cuda.current_stream(self.device)
        with self._lock, torch.cuda.device(self.device):
            _check(self._lib.d3f_nvjpeg_decode_batch(
                self._ctx, (ctypes.c_char_p * n)(*blobs),
                (ctypes.c_size_t * n)(*[len(b) for b in blobs]), n,
                (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
                (ctypes.c_int * n)(*[w for w, _ in dims]),
                ctypes.c_void_p(stream.cuda_stream)), "batched decode")
        DECODED["frames"] += n
        return outs if batch is None else batch

    def encode(self, rgb, quality: int = 95) -> bytes:
        """RGB uint8 HWC (a CUDA tensor, on the current stream, or a host
        array, uploaded on the codec's stream) -> JPEG bytes at ``quality``,
        4:2:0."""
        if isinstance(rgb, np.ndarray):
            with torch.cuda.stream(self.stream):
                return self.encode(torch.from_numpy(
                    np.ascontiguousarray(rgb)).to(self.device), quality)
        if rgb.device.type != "cuda":
            raise ValueError("nvJPEG encodes CUDA tensors; a CPU tensor "
                             "goes through native_loader.encode_jpeg")
        if rgb.dtype != torch.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"encode takes uint8 RGB HWC, got "
                             f"{tuple(rgb.shape)} {rgb.dtype}")
        rgb = rgb.contiguous()
        ptr, n = _u8p(), ctypes.c_size_t()
        stream = torch.cuda.current_stream(rgb.device)
        with self._lock, torch.cuda.device(rgb.device):
            _check(self._lib.d3f_nvjpeg_encode(
                self._ctx, ctypes.c_void_p(rgb.data_ptr()), rgb.shape[1],
                rgb.shape[0], quality, ctypes.c_void_p(stream.cuda_stream),
                ctypes.byref(ptr), ctypes.byref(n)), "encode")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.d3f_nvjpeg_free(ptr)


def codec(device=None) -> NvJpegCodec:
    """This process's codec on ``device`` (the current CUDA device)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG runs on a CUDA device, not {device}")
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    with _lock:
        if index not in _codecs:
            _codecs[index] = NvJpegCodec(torch.device("cuda", index))
        return _codecs[index]


def decode_to_host(blobs: list[bytes]) -> list[np.ndarray]:
    """Decode on the card, on the codec's stream, and copy the frames back
    as RGB uint8 HWC."""
    c = codec()
    with torch.cuda.stream(c.stream):
        frames = c.decode_batch(blobs)
        if isinstance(frames, torch.Tensor):  # one copy of the shared batch
            return list(frames.cpu().numpy())
        return [f.cpu().numpy() for f in frames]
