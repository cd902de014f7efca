"""Host-side image loading with background prefetch, and the upload ahead.

Own copy of ``denoising_diffusion_deep_fake_tpu/data/loader.py:32-237``:

* the host decodes, resizes a mismatched image to the static size and
  assembles **uint8** NHWC batches; normalisation and augmentation run on
  the device inside the train step;
* a worker thread keeps a small queue of ready batches, so decoding
  overlaps the device's work, and hands a decode error to the consumer;
* the epoch order is seeded by ``seed * 100_003 + epoch`` (shuffled, or
  uniform over difficulty classes with ``class_balanced``);
* a RAM cache (``cache="auto"`` when the decoded dataset fits
  ``cache_limit_bytes``) decodes each image at most once.

The decoder, JAX's selection rule (``loader.decoder`` names the one
chosen):

1. ``decode_fn`` when the caller passes one (``"decode_fn"``);
2. with ``use_native`` (the default), the port's native batch loader
   (``data/native_loader.py``: libjpeg/libpng decode, centre crop and
   bilinear resize, ``native_threads`` threads) where g++ finds
   libjpeg's and libpng's headers (``"native"``);
3. ``cv2`` where it imports (``"cv2"``);
4. otherwise the loader raises, naming what is missing
   (``data/codec.py`` ``missing``).

Off route 2 a mismatched frame is resized by cv2's cubic resize where cv2
imports, else by ``ops.image.resize_cubic``, OpenCV's own algorithm. The
decoder and the resize are chosen once, when the loader is built. A file
no decoder can read raises; none is skipped. ``shard=(i, n)`` keeps
process ``i``'s strided, equal-length slice of the manifest (data
parallelism, JAX ``:72-85``).

``device_prefetch`` is the counterpart of JAX ``parallel/mesh.py:115``:
a worker thread uploads each batch's uint8 arrays ahead of the step that
consumes them, to the rank's own device under data parallelism (a rank's
batch is its slice of the global one).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.data import native_loader
from denoising_diffusion_deep_fake_tpu_torch.data.codec import (
    cubic_resizer,
    cv2_or_none,
    cv2_read_rgb,
    missing,
)
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    read_image_manifest_with_classes,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    pack_rgb_batch_to_i420_np,
)
from denoising_diffusion_deep_fake_tpu_torch.utils import stragglers


def default_decode(path: str) -> np.ndarray:
    """JPEG/PNG -> RGB uint8 HWC through cv2 (it reads BGR, like the
    reference)."""
    cv2 = cv2_or_none()
    if cv2 is None:
        raise ImportError("default_decode reads images with cv2, which does "
                          "not import here")
    return cv2_read_rgb(cv2, path)


def _threaded(produce, depth: int):
    """Yield what ``produce(put)`` puts, from a worker thread, ``depth``
    items ahead; an exception in the worker is raised here. Leaving the
    generator early stops the worker at its next put."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            produce(put)
            put(None)
        except Exception as e:  # surfaced to the consumer
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)
        if thread.is_alive():
            # Mid decode or upload: one more bounded join at exit.
            stragglers.adopt(thread)


class ImageLoader:
    """Iterates epochs of (uint8 NHWC batch, index vector) with prefetch."""

    def __init__(self, manifest_path, batch_size: int, *,
                 image_size: int | None = None, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True,
                 prefetch_batches: int = 2,
                 decode_fn: Callable[[str], np.ndarray] | None = None,
                 use_native: bool = True, native_threads: int = 4,
                 class_balanced: bool = False,
                 shard: tuple[int, int] | None = None,
                 cache: bool | str = "auto",
                 cache_limit_bytes: int = 2 << 30):
        self.manifest_path = Path(manifest_path)
        paths, classes = read_image_manifest_with_classes(manifest_path)
        self.paths = [str(p) for p in paths]
        self.classes = classes
        if shard is not None:
            # Data parallelism: each process keeps a strided slice of the
            # manifest (parallel/distributed.py's data_shard()), cut to the
            # same length on every process: unequal shards would give
            # processes different batches_per_epoch, and the one with more
            # would issue a step's collectives that its peers never join.
            # Drops at most shard_num - 1 images an epoch.
            shard_idx, shard_num = shard
            per_shard = len(self.paths) // shard_num
            if per_shard == 0:
                raise ValueError(
                    f"manifest {manifest_path} has {len(self.paths)} images "
                    f"for {shard_num} processes — every process needs one")
            self.paths = self.paths[shard_idx::shard_num][:per_shard]
            if self.classes is not None:
                self.classes = list(
                    self.classes)[shard_idx::shard_num][:per_shard]
        self.class_balanced = class_balanced
        if class_balanced and classes is None:
            raise ValueError(
                "class_balanced=True needs a difficulty-classed manifest "
                "(run `balance` to produce one)")
        if not self.paths:
            raise ValueError(f"empty image manifest: {manifest_path}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch_batches = prefetch_batches
        # The decoder and the resize, chosen once (module docstring).
        cv2 = cv2_or_none()
        self._resize = cubic_resizer()
        if decode_fn is not None:
            self.decoder = "decode_fn"
            self._decode = lambda paths: [decode_fn(p) for p in paths]
        elif use_native and native_loader.available():
            self.decoder = "native"
            self._decode = None
        elif cv2 is not None:
            self.decoder = "cv2"
            self._decode = lambda paths: [cv2_read_rgb(cv2, p)
                                          for p in paths]
        else:
            raise RuntimeError(missing(f"the images of {manifest_path}"))
        if image_size is None:
            image_size = self._probe_size(self.paths[0])
        self.image_size = image_size
        # The native batch loader decodes, crops and resizes whole batches.
        self.load_batch_fn = (
            native_loader.NativeBatchSource(image_size,
                                            n_threads=native_threads)
            if self.decoder == "native" else None)

        # Each image is decoded at most once; later epochs are a
        # fancy-index copy.
        n_bytes = len(self.paths) * self.image_size * self.image_size * 3
        self._cache_enabled = (cache is True or
                               (cache == "auto"
                                and n_bytes <= cache_limit_bytes))
        if self._cache_enabled:
            self._cache_store = np.empty(
                (len(self.paths), self.image_size, self.image_size, 3),
                dtype=np.uint8)
            self._cache_valid = np.zeros(len(self.paths), dtype=bool)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def batches_per_epoch(self) -> int:
        n = len(self.paths) // self.batch_size
        if not self.drop_remainder and len(self.paths) % self.batch_size:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100_003 + epoch)
        if self.class_balanced and self.classes is not None:
            # Uniform over classes, with replacement inside small ones.
            classes = np.asarray(self.classes)
            unique = np.unique(classes)
            members = {c: np.flatnonzero(classes == c) for c in unique}
            draws_c = rng.choice(unique, size=len(self.paths))
            return np.asarray([rng.choice(members[c]) for c in draws_c])
        order = np.arange(len(self.paths))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _probe_size(self, path: str) -> int:
        """The square size of ``path``, read by the chosen decoder."""
        if self.decoder == "native":
            width, height = native_loader.image_dims(path)
        else:
            height, width = self._decode([path])[0].shape[:2]
        if height != width:
            raise ValueError(
                "image_size not set and first image is not square "
                f"({height}x{width}); set image_size in the config")
        return height

    def _decode_batch(self, indices: np.ndarray) -> np.ndarray:
        paths = [self.paths[i] for i in indices]
        if self.load_batch_fn is not None:
            return self.load_batch_fn(paths)
        size = self.image_size
        batch = np.empty((len(indices), size, size, 3), dtype=np.uint8)
        for row, image in enumerate(self._decode(paths)):
            if image.shape[:2] != (size, size):
                # Cubic, like the dataset-prep tool's resize.
                image = self._resize(image, (size, size))
            batch[row] = image
        return batch

    def _load_batch(self, indices: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        if not self._cache_enabled:
            return self._decode_batch(indices), indices.astype(np.int32)
        missing = indices[~self._cache_valid[indices]]
        if missing.size:
            missing = np.unique(missing)
            self._cache_store[missing] = self._decode_batch(missing)
            self._cache_valid[missing] = True
        return self._cache_store[indices], indices.astype(np.int32)

    def epoch(self, epoch: int):
        """Yield this epoch's batches, decoding ahead on a worker thread."""
        order = self._epoch_order(epoch)
        if self.drop_remainder:
            order = order[:len(order) - len(order) % self.batch_size]
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]

        def produce(put):
            for chunk in chunks:
                if not put(self._load_batch(chunk)):
                    return

        return _threaded(produce, self.prefetch_batches)


class PairedLoader:
    """Zips two identity loaders (the deep-fake trainer's ``{"a", "b"}``
    streams). An epoch is as long as the shorter loader's, as Lightning's
    dict of dataloaders."""

    def __init__(self, loader_a: ImageLoader, loader_b: ImageLoader):
        if loader_a.image_size != loader_b.image_size:
            raise ValueError("identity datasets must share image_size")
        self.a = loader_a
        self.b = loader_b
        self.image_size = loader_a.image_size

    @property
    def batches_per_epoch(self) -> int:
        return min(self.a.batches_per_epoch, self.b.batches_per_epoch)

    def epoch(self, epoch: int):
        yield from zip(self.a.epoch(epoch), self.b.epoch(epoch))


def device_prefetch(batches, device, depth: int = 2,
                    upload_format: str = "rgb"):
    """Upload ``batches`` (tuples whose uint8 arrays of ndim >= 3 go to
    ``device``; other items stay on the host) ``depth`` items ahead, on a
    worker thread.

    ``upload_format="i420"`` packs each uint8 NHWC array 4:2:0 on the
    worker thread before its upload (``pack_rgb_batch_to_i420_np``): half
    the bytes cross the host link, and the train step unpacks them
    (``ops.image.unpack_upload``).

    On the GPU each array is copied into pinned memory and sent with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    the upload's event before the batch is handed over, and the tensor is
    recorded on that stream so its memory is not reused while the step
    reads it."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        consumer = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)

    def upload(x):
        if not (isinstance(x, np.ndarray) and x.ndim >= 3):
            return x
        if (upload_format == "i420" and x.ndim == 4
                and x.dtype == np.uint8):
            x = pack_rgb_batch_to_i420_np(x)
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not cuda:
            return t.to(device)
        with torch.cuda.stream(side):
            return t.pin_memory().to(device, non_blocking=True)

    def produce(put):
        for item in batches:
            item = tuple(upload(x) for x in item)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(side)
            if not put((item, event)):
                return

    for item, event in _threaded(produce, depth):
        if event is not None:
            consumer.wait_event(event)
            for x in item:
                if isinstance(x, torch.Tensor):
                    x.record_stream(consumer)
        yield item
