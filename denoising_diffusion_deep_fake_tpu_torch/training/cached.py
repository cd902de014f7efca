"""The step calls of ``data_cache: device`` (``data/device_cache.py``).

Port of ``denoising_diffusion_deep_fake_tpu/training/cached.py:48-88``. A
cached step takes no batch: it gathers its own from the dataset on the
device at ``(counter % steps_per_epoch) * batch_size`` in the epoch's
order, the counter being the state's ``step`` (model a's for the identity
pair, whose two batches come from the same position, JAX ``:57, :71``),
then runs the trainer's step on it. The position comes from the state's
counter and not from the loop's ``global_step``, which ``modify`` does not
reset. ``training/runners.py`` builds these steps beside
``training/multi_step.py``'s ``make_cached_super_step`` (the K-step call,
one CUDA graph on the card gathering inside it), with the epoch as long
as the shorter identity's (JAX ``runners.py:124``).
"""

from __future__ import annotations

from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
    gather_batch,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    step_counter,
)


def cached_steps_for(trainer, caches: list[DeviceDatasetCache],
                     steps_per_epoch: int):
    """``(plain, with_images)``: ``trainer``'s step and its step with
    panels, each called with the states alone and gathering its batches,
    one a cache, at the states' position."""
    batch_size = caches[0].batch_size

    def batches(states) -> list:
        pos = step_counter(states) % steps_per_epoch * batch_size
        return [gather_batch(c.dataset, c.order, pos, batch_size)
                for c in caches]

    def plain(states):
        return trainer.train_step(states, *batches(states))

    def with_images(states):
        return trainer.train_step(states, *batches(states), with_images=True)

    return plain, with_images
