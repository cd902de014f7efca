"""PNG decoding without libpng: the standard library's ``zlib`` and the five
row filters.

The port's PNG reader for a machine that has neither libpng's headers nor
cv2 (the H100 machine has no libpng). It returns what the native loader's
``decode_png`` (``native/dataloader.cpp:109-153`` in the JAX package)
returns: RGB uint8 HWC, 16-bit samples cut to their high byte, gray
replicated, palettes looked up, alpha (and tRNS) dropped. The row filters
run in a small host C++ unit (``csrc/png_unfilter.cpp``, built with g++
at first use): Average and Paeth read the byte just reconstructed.
Interlaced (Adam7) files raise.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SOURCE = Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
# Samples a pixel carries, by colour type: gray, RGB, palette index,
# gray + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


@functools.cache
def _unfilter():
    fn = _build.load_host("d3f_png_unfilter", [_SOURCE]).d3f_png_unfilter
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fn.argtypes = [u8p, ctypes.c_int, ctypes.c_size_t, ctypes.c_int, u8p]
    fn.restype = ctypes.c_int
    return fn


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise IOError("PNG chunk runs past the end of the file")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise IOError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise IOError("PNG has no IEND chunk")


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(H, rowbytes) packed samples of ``depth`` < 8 bits -> (H, W) uint8."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :width]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 HWC."""
    if not is_png(data):
        raise IOError("not a PNG file")
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise IOError("PNG lacks IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise IOError(f"PNG colour type {color} at {depth} bits is invalid")
    if interlace:
        raise IOError("interlaced (Adam7) PNG files are not supported by "
                      "the port's PNG reader; re-save without interlacing")
    if color == 3 and palette is None:
        raise IOError("palette PNG without a PLTE chunk")
    channels = _CHANNELS[color]
    rowbytes = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (rowbytes + 1):
        raise IOError("PNG image data is shorter than its rows")
    raw = np.frombuffer(raw, np.uint8)
    rows = np.empty((height, rowbytes), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if _unfilter()(
            raw.ctypes.data_as(u8p), height, rowbytes, bpp,
            rows.ctypes.data_as(u8p)) != 0:
        raise IOError("PNG row has an unknown filter type")

    if depth == 16:  # the high byte of each big-endian sample
        samples = rows.reshape(height, width * channels, 2)[:, :, 0]
    elif depth < 8:
        samples = _unpack_bits(rows, depth, width)
        if color == 0:  # gray scaled to 8 bits, as libpng expands it
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    else:
        samples = rows
    samples = samples.reshape(height, width, channels)
    if color == 3:
        index = samples[..., 0]
        if index.max(initial=0) >= len(palette):
            raise IOError("PNG palette index out of range")
        return palette[index]
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])
