"""Step and function timing that waits for the card.

Port of ``denoising_diffusion_deep_fake_tpu/utils/timing.py``. CUDA
launches return before the card has run them, so a host clock around them
measures the enqueue. ``value_barrier`` fetches a scalar of the result (as
JAX's does, where ``block_until_ready`` did not wait on its TPU link), and
``timed_loop`` / ``timed_fn`` also synchronise the card around each phase
when the tensors they see are on CUDA.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves

from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device


def _first_tensor(out) -> torch.Tensor | None:
    return next((leaf for leaf in tree_leaves(out)
                 if isinstance(leaf, torch.Tensor)), None)


def value_barrier(out) -> float:
    """Wait for ``out`` by fetching a scalar of its first tensor leaf (one
    leaf suffices: it depends on the whole step); 0.0 when it holds
    none."""
    leaf = _first_tensor(out)
    if leaf is None:
        return 0.0
    return float(leaf.detach().reshape(-1)[0])


def _synchronise(out, device) -> None:
    leaf = _first_tensor(out)
    on = device if leaf is None else leaf.device
    if on is not None and on.type == "cuda":
        torch.cuda.synchronize(on)


def timed_loop(step_once: Callable[[object], object], state, *, steps: int,
               warmup: int = 3, device=None) -> tuple[float, object]:
    """Run ``state = step_once(state)`` warmup + steps times; wait for the
    card after each phase (a value fetch, and a synchronise on CUDA).
    ``device`` (``resolve_device``'s default: the card) is synchronised
    when ``state`` holds no tensor. Returns (seconds_per_step,
    final_state)."""
    device = resolve_device(device)
    for _ in range(warmup):
        state = step_once(state)
    value_barrier(state)
    _synchronise(state, device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step_once(state)
    value_barrier(state)
    _synchronise(state, device)
    return (time.perf_counter() - t0) / steps, state


def timed_fn(fn: Callable, *args, steps: int = 10, warmup: int = 3,
             device=None) -> float:
    """Seconds per call of a stateless ``fn(*args)``, waiting as
    ``timed_loop`` does."""
    device = resolve_device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    value_barrier(out)
    _synchronise(out, device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    value_barrier(out)
    _synchronise(out, device)
    return (time.perf_counter() - t0) / steps
