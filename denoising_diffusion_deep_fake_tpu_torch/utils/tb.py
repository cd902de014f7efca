"""TensorBoard event files written with the standard library alone.

The port's counterpart of ``denoising_diffusion_deep_fake_tpu/utils/tb.py``,
which writes through ``tensorboardX``; the GPU machine may have neither
``tensorboardX`` nor ``PIL`` nor ``matplotlib``. The file is what
TensorBoard reads:

* TFRecord framing: each record is its length (uint64, little-endian), the
  masked CRC-32C of those 8 bytes, the payload, and the masked CRC-32C of
  the payload. CRC-32C (Castagnoli) runs from a 256-entry table in Python,
  as ``tensorboardX`` does without its optional native module: a Python
  loop over every byte, paid on the thread that writes (the loop's metric
  worker), which makes a large image panel cost far more than a scalar;
* the payloads are ``Event`` protobufs encoded by hand: the first carries
  ``file_version``, the others a ``Summary`` of ``simple_value`` scalars or
  one ``Summary.Image`` (an RGB PNG made with ``zlib`` and ``struct``);
* the file is named ``events.out.tfevents.<time>.<host>``, as
  ``tensorboardX`` names it.

The public surface is JAX's ``TensorBoardLogger``: ``log_scalars``,
``log_batch_as_image_grid`` (a uint8 HWC grid as it is; a float NHWC batch
gridded by ``ops/image.py`` ``grid_to_display``, then ``x * 255``
truncated, as ``tensorboardX`` quantises), ``log_figure`` (here an RGB
uint8 HWC rendering, since the port draws without matplotlib), ``flush``
and ``close``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.image import grid_to_display


def _crc32c_table() -> tuple[int, ...]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``."""
    table, crc = _CRC32C, 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# ------------------------------------------------------ protobuf encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field_bytes(number: int, data: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _event(wall_time: float, *, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    """``Event``: wall_time = 1 (double), step = 2, file_version = 3,
    summary = 5."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += _field_varint(2, step)
    if file_version:
        out += _field_bytes(3, file_version.encode())
    if summary:
        out += _field_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """``Summary`` (value = 1) of one ``Summary.Value``: tag = 1,
    simple_value = 2 (float)."""
    return _field_bytes(1, _field_bytes(1, tag.encode()) + b"\x15"
                        + struct.pack("<f", value))


def _image_summary(tag: str, image: np.ndarray) -> bytes:
    """``Summary`` of one ``Summary.Value``: tag = 1, image = 4
    (``Summary.Image``: height = 1, width = 2, colorspace = 3,
    encoded_image_string = 4)."""
    h, w, c = image.shape
    encoded = (_field_varint(1, h) + _field_varint(2, w)
               + _field_varint(3, c) + _field_bytes(4, encode_png(image)))
    return _field_bytes(1, _field_bytes(1, tag.encode())
                        + _field_bytes(4, encoded))


def encode_png(image: np.ndarray) -> bytes:
    """An RGB uint8 HWC array as an 8-bit PNG (no filtering)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"an RGB image has 3 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


class TensorBoardLogger:
    """Scalars, image grids and rendered figures into one event file."""

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = log_dir / (f"events.out.tfevents.{str(now)[:10]}."
                               f"{socket.gethostname()}")
        self._file = open(self.path, "ab")
        # The loop's metric worker and the main thread (the balancer's
        # histogram) both write.
        self._lock = threading.Lock()
        self._write(_event(now, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        record = tfrecord(event)
        with self._lock:
            self._file.write(record)

    def log_scalars(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            self._write(_event(time.time(), step=step,
                               summary=_scalar_summary(tag, float(value))))

    def _add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._write(_event(time.time(), step=step,
                           summary=_image_summary(tag, image)))

    def log_batch_as_image_grid(self, tag: str, batch, step: int,
                                nrow: int = 3) -> None:
        """3x3 grid, ``x * 0.5 + 0.5`` clamped, of a normalised NHWC float
        batch; or a display-ready HWC uint8 grid (``panel_grid_u8``),
        written as it is."""
        if isinstance(batch, torch.Tensor):
            batch = batch.detach().cpu()
        arr = np.asarray(batch)
        if arr.ndim == 3 and arr.dtype == np.uint8:
            self._add_image(tag, arr, step)
            return
        grid = grid_to_display(torch.as_tensor(arr, dtype=torch.float32),
                               nrow=nrow).numpy()
        self._add_image(tag, (grid * 255.0).astype(np.uint8), step)

    def log_figure(self, tag: str, image: np.ndarray, step: int) -> None:
        """A rendered figure: an RGB uint8 HWC array."""
        self._add_image(tag, np.asarray(image, dtype=np.uint8), step)

    def flush(self) -> None:
        with self._lock:
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            self._file.close()


class NullLogger:
    """``TensorBoardLogger``'s surface writing nothing: the logger of a
    data-parallel rank other than the primary, which owns the event
    files."""

    def log_scalars(self, metrics: dict, step: int) -> None:
        pass

    def log_batch_as_image_grid(self, tag: str, batch, step: int,
                                **kwargs) -> None:
        pass

    def log_figure(self, tag: str, image, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
