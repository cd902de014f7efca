"""The decoded dataset on the device: batches gathered inside the step.

Port of ``denoising_diffusion_deep_fake_tpu/data/device_cache.py:44-95``,
``:138-166`` and ``:168-179``, the single-process layout. With
``data_cache: device`` the decoded uint8 dataset is uploaded once, as one
``(N, H, W, 3)`` tensor; each epoch uploads only its order (the loader's
own seeded permutation or class-balanced draws, trimmed to whole
batches), and a step gathers its batch on the device from the order at a
position its host counter gives. No image crosses the host link after the
upload, and no loader or upload thread runs. JAX sizes a face dataset at
about 6 GB for 10k 448^2 frames; ``device_cache_limit_bytes`` (8 GiB by
default) bounds it.

The order lives in one device buffer for the whole run: every epoch's is
copied into it (from pinned memory on the card, in stream order behind the
steps that read the previous one), so a CUDA graph captured on the buffer
(``training/multi_step.py``) reads each new epoch's order without being
captured again.

Under data parallelism (JAX ``:97-136``) each rank is given its loader of
its manifest shard (``shard=``, ``data/loader.py``) at the local batch
size, so the cache holds that shard on the rank's device, trimmed to whole
local batches; the shards are equally long, so every rank runs as many
steps an epoch. The epoch's order and the gather stay local.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.data.loader import ImageLoader
from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device


class DeviceDatasetCache:
    """An ``ImageLoader``'s whole dataset decoded once and kept on
    ``device`` (the GPU unless the caller asks for the CPU), with a
    per-epoch order buffer beside it.

    ``decode_s`` and ``upload_s`` say what the two stages of the
    constructor took."""

    def __init__(self, loader: ImageLoader, *, limit_bytes: int = 8 << 30,
                 device=None):
        n = len(loader.paths)
        nbytes = n * loader.image_size * loader.image_size * 3
        if nbytes > limit_bytes:
            raise ValueError(
                f"dataset is {nbytes / 1e9:.2f} GB decoded — over the "
                f"device_cache_limit_bytes ({limit_bytes / 1e9:.2f} GB); "
                "use data_cache='host' or raise the limit")
        if n < loader.batch_size:
            raise ValueError(f"dataset ({n} images) smaller than one batch "
                             f"({loader.batch_size})")
        self.loader = loader
        self.batch_size = loader.batch_size
        self.n_images = n
        self.nbytes = nbytes
        self.device = resolve_device(device)
        # Decoded without filling the loader's RAM store: the device copy
        # replaces it, and a full store would hold a second copy on the host
        # for the whole run. A store that is already full is reused.
        t0 = time.perf_counter()
        if loader._cache_enabled and bool(loader._cache_valid.all()):
            images = loader._cache_store
        else:
            images = loader._decode_batch(np.arange(n))
        self.decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.dataset = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t0
        self.order = torch.zeros(self.steps_per_epoch * self.batch_size,
                                 dtype=torch.int64, device=self.device)

    @property
    def steps_per_epoch(self) -> int:
        """Whole batches only, whatever the loader's ``drop_remainder``: a
        partial batch would train a clamped overlap again."""
        return self.n_images // self.batch_size

    def order_for_epoch(self, epoch: int) -> torch.Tensor:
        """The loader's order of ``epoch`` trimmed to whole batches, copied
        into the order buffer, which is returned (the same tensor every
        epoch)."""
        order = torch.from_numpy(
            self.loader._epoch_order(epoch)[:self.order.numel()]
            .astype(np.int64))
        if self.device.type == "cuda":
            # A fresh pinned buffer each epoch: the host allocator hands it
            # out again only after the copy that reads it has run.
            order = order.pin_memory()
        self.order.copy_(order, non_blocking=True)
        return self.order


def gather_batch(dataset: torch.Tensor, order: torch.Tensor, pos,
                 batch_size: int) -> torch.Tensor:
    """``dataset[order[pos:pos + batch_size]]`` by ``index_select``.

    ``pos`` is an int (an eager step) or a 0-dim int64 tensor on the
    dataset's device (a CUDA graph's scalar table), so nothing is read back
    to the host and a capture never synchronises."""
    rows = order.index_select(
        0, torch.arange(batch_size, device=order.device) + pos)
    return dataset.index_select(0, rows)
