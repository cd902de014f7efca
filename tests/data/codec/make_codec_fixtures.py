"""Write the codec test fixtures of this directory (run from the repo root):

    python tests/data/codec/make_codec_fixtures.py

From one smooth seeded image (``source.npy``, 48x48 RGB: low-resolution
noise upsampled with cv2's cubic resize), cv2 writes JPEG at quality 95
(baseline 4:2:0, 4:4:4, progressive, grayscale, a non-square 40x24) and PNG
(RGBA, gray, 16-bit RGB). A small writer here adds the PNG cases cv2
cannot write or writes with one row filter only: RGB and a palette with
tRNS whose rows cycle through all five filters, and 4-bit gray. Beside
each file, ``<name>.npy`` holds cv2's decode (``cv2.imread``, BGR turned
to RGB): the reference the tests and ``chip_smoke.py`` hold decoders to.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 14


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """PNG rows, row y filtered with type y % 5."""
    out = bytearray()
    prev = np.zeros_like(rows[0], dtype=np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        kind = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def write_png(path: Path, rows: np.ndarray, width: int, depth: int,
              color: int, bpp: int, extra: bytes = b"") -> None:
    """``rows``: (H, rowbytes) packed samples."""
    header = struct.pack(">IIBBBBB", width, rows.shape[0], depth, color, 0,
                         0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + extra
                     + _chunk(b"IDAT", zlib.compress(_filter_rows(rows, bpp)))
                     + _chunk(b"IEND", b""))


def main() -> None:
    rng = np.random.default_rng(SEED)
    low = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
    source = cv2.resize(low, (48, 48), interpolation=cv2.INTER_CUBIC)
    np.save(HERE / "source.npy", source)
    bgr = np.ascontiguousarray(source[..., ::-1])
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    q95 = [cv2.IMWRITE_JPEG_QUALITY, 95]
    files = {
        "baseline_420.jpg": (bgr, q95),
        "yuv444.jpg": (bgr, q95 + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
        "progressive.jpg": (bgr, q95 + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "gray.jpg": (gray, q95),
        "nonsquare_40x24.jpg": (np.ascontiguousarray(bgr[12:36, 4:44]), q95),
        "rgba.png": (np.dstack([bgr, rng.integers(0, 256, (48, 48),
                                                  dtype=np.uint8)]), []),
        "gray.png": (gray, []),
        "rgb16.png": ((bgr.astype(np.uint16) * 257
                       + rng.integers(0, 256, bgr.shape)).astype(np.uint16),
                      []),
    }
    for name, (image, params) in files.items():
        assert cv2.imwrite(str(HERE / name), image, params)
    # RGB, every row filter.
    write_png(HERE / "rgb_filters.png", source.reshape(48, -1), 48, 8, 2, 3)
    # An 8-bit palette with tRNS (alpha dropped on decode), every filter.
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    index = (source[..., 0] // 16).astype(np.uint8)
    write_png(HERE / "palette.png", index, 48, 8, 3, 1,
              _chunk(b"PLTE", palette.tobytes())
              + _chunk(b"tRNS", bytes(range(0, 256, 16))))
    # 4-bit gray: two samples a byte.
    nibbles = gray[:, :48] >> 4
    write_png(HERE / "gray4.png", (nibbles[:, 0::2] << 4) | nibbles[:, 1::2],
              48, 4, 0, 1)
    for path in sorted(HERE.glob("*.jpg")) + sorted(HERE.glob("*.png")):
        image = cv2.imread(str(path), cv2.IMREAD_COLOR)
        assert image is not None, path
        np.save(path.with_suffix(".npy"),
                cv2.cvtColor(image, cv2.COLOR_BGR2RGB))


if __name__ == "__main__":
    main()
