"""K train steps as one call: the ``steps_per_call`` knob.

Port of ``denoising_diffusion_deep_fake_tpu/training/multi_step.py:38-57``
(``make_super_step``). JAX scans K steps into one XLA program, so K steps
cost one dispatch and one stacked metric fetch. On the card the
counterpart is one ``torch.cuda.CUDAGraph`` whose replay runs K whole train
steps (the warp and noise kernels, the U-Net's forward and backward, Adam,
in swap mode both EMA blends) with no host work between them; on the CPU
(the tests) the same call runs the same step function eagerly K times,
which is its plain version. ``make_cached_super_step`` is the
counterpart of JAX's ``:67-102``: with ``data_cache: device``
(``data/device_cache.py``) a group takes no batches, and each step gathers
its own from the device dataset inside the graph.

The contract a step keeps, JAX's "the per-step randomness derives from the
step counter", carried to host counters:

* ``scalars(states, j)`` gives the host numbers of the ``j``-th step of a
  group from the host counters (``state.step``, ``ema_step``): the learning
  rate, each model's noise-stream offset, each shadow's EMA decay. Nothing
  is read back from the device;
* ``step_core(states, *batches, scalars, generator)`` updates the states'
  tensors in place and returns the step's metrics as device scalars,
  taking every number that changes from step to step from ``scalars``
  (numbers in an eager step, device tensors in a graph) and every draw
  from ``generator``;
* ``advance(states, k)`` moves the host counters on by ``k``.

So a group is K single steps, step for step: the same batches, the same
numbers, the same draws (``tests/test_torch_port_multi_step.py`` holds it
bit for bit on the CPU, ``chip_smoke.py`` phase 12 on the card). Metrics
come back as ``(K,)`` tensors, and the ``host_metrics`` (the learning
rate) as lists of K numbers; the loop fans them out to per-step rows.

With ``data_cache: device`` (``make_cached_super_step``) the step's
scalar row also carries ``pos``, the batch's position in the epoch's
order, ``((counter + j) % steps_per_epoch) * batch_size`` from the host
counter (``state.step``, or model a's), as an int64 column of the table;
the graph gathers from the dataset and the order buffer at it. Each
cache's dataset and order buffer, as the cache holds them at the call,
are part of the graph's identity: a new epoch's order is copied into the
same buffer and replays the same graph, while a buffer replaced instead
of filled is captured anew. A new cache comes with a new K-step call
(``training/runners.py`` builds one a run), captured on its tensors.

On CUDA, the capture (``_Graph``):

* K static batch slots, filled before each replay by ``copy_`` from the
  prefetched uploads on the current stream;
* a table of K rows of scalars (fp32 and int64 columns) that the graph's
  kernels read: the noise kernels their offset (their device-offset form),
  Adam its learning rate, the EMA blends their decays. It is written
  before each replay from pinned memory with ``non_blocking``; each write
  takes a fresh pinned buffer, which PyTorch's host allocator does not hand
  out again until the copy that reads it has run;
* the trainer's ``torch.Generator`` registered with the graph, so that a
  replay draws the affine params and noise ratios K eager steps would draw,
  and leaves the generator where they would;
* before the capture, Adam's state is created (``prepare``; a captured first
  update would zero the moments at every replay), and one step runs on a
  throwaway copy of the states and generator on the capture stream:
  cuDNN's plans and the kernel libraries' lazy module loads (each links its
  own static CUDA runtime) are made there, not during capture;
* the capture is thread-local (``capture_error_mode="thread_local"``): the
  loop's metric worker and ``device_prefetch``'s upload thread go on while a
  graph is captured. Their CUDA calls (a fetch's stream synchronise, a
  pinned allocation, an upload on a side stream) are made from other
  threads on other streams, which a thread-local capture allows, and the
  caching allocator puts only the capturing stream's allocations in the
  graph's pool;
* the launches the capture counts go to the graph (``_build.moved_launches``)
  and every replay adds them to ``LAUNCHES``; the warm-up's are dropped;
* after each replay the ``(K,)`` metrics are cloned: the metric worker
  reads them later, and the next replay overwrites the graph's own.

A graph trains the tensors it was captured on. ``identity(states)`` lists
every object it depends on (modules, params, buffers, Adam's state and
learning rates, shadows), the graph holds them, and before each replay the
super step checks that the states hold exactly those objects, at the same
addresses, with batches of the same shapes and the same ``key(states)``
(the mode); if not, it captures anew. A restore's
``optimizer.load_state_dict``, ``reset_for_modify``'s fresh optimizers,
the flip's shadows (``ensure_ema``) or a mode change therefore never
replay a stale graph. There is no fallback: on CUDA a capture or replay
that fails raises.

In a process group (data parallelism, ``parallel/``) the graph captures
the step's collectives too (batch norm's statistics, the gradient
average, the metrics' mean), which NCCL allows: each replay runs them
again on every rank. Gloo's collectives cannot be captured, so a K-step
call on CUDA tensors under gloo (several ranks on one card) raises; on
the CPU nothing changes. With ``spatial_parallel > 1`` the step also
issues the halo exchanges (NCCL's ``batch_isend_irecv``) and the row
gathers, which the capture takes as it takes NCCL's collectives (four
ranks on four cards: ``chip_smoke.py --spatial-cards 4``); under gloo it
raises as above.
"""

from __future__ import annotations

import collections
import copy
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
    gather_batch,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
    LAUNCHES,
    moved_launches,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    step_counter,
)


def make_super_step(step_core: Callable, k: int, *,
                    scalars: Callable, advance: Callable,
                    generator: torch.Generator | None, device,
                    n_batch_args: int = 1, host_metrics=(),
                    identity: Callable | None = None,
                    prepare: Callable | None = None,
                    key: Callable | None = None) -> "SuperStep":
    """``step(states, *k_batches_per_arg)`` running ``step_core`` K times
    (the module docstring says what each callable does). The batches are
    grouped per position, as JAX's: for the paired trainer
    (``n_batch_args=2``) the call is ``step(states, a0..a{k-1},
    b0..b{k-1})``. Returns the metrics with a leading ``(K,)`` axis."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    return SuperStep(step_core, k, scalars=scalars, advance=advance,
                     generator=generator, device=torch.device(device),
                     n_batch_args=n_batch_args, host_metrics=host_metrics,
                     identity=identity or (lambda states: []),
                     prepare=prepare, key=key or (lambda states: None))


def make_cached_super_step(step: "SuperStep", caches: list,
                           steps_per_epoch: int) -> "SuperStep":
    """``step(states)``: the K steps of ``step`` (a trainer's
    ``make_super_step(k)``) with no batch arguments, each gathering its
    batch, one from each of ``caches`` (two for the identity pair, at the
    same position), from the device dataset at its row's ``pos``."""
    batch_size = caches[0].batch_size

    def scalars(states, j):
        pos = (step_counter(states) + j) % steps_per_epoch * batch_size
        return {**step.scalars(states, j), "pos": pos}

    def core(states, row, generator):
        batches = [gather_batch(c.dataset, c.order, row["pos"], batch_size)
                   for c in caches]
        return step.step_core(states, *batches, row, generator)

    return SuperStep(core, step.k, scalars=scalars, advance=step.advance,
                     generator=step.generator, device=step.device,
                     n_batch_args=0, host_metrics=step.host_metrics,
                     identity=lambda states: step.identity(states) + [
                         t for c in caches for t in (c.dataset, c.order)],
                     prepare=step.prepare, key=step.key)


class SuperStep:
    """K steps a call: one graph replay on CUDA, K eager steps elsewhere."""

    def __init__(self, step_core, k, *, scalars, advance, generator, device,
                 n_batch_args, host_metrics, identity, prepare, key):
        self.step_core = step_core
        self.k = k
        self.scalars = scalars
        self.advance = advance
        self.generator = generator
        self.device = device
        self.n_batch_args = n_batch_args
        self.host_metrics = tuple(host_metrics)
        self.identity = identity
        self.prepare = prepare
        self.key = key
        self.graph: _Graph | None = None
        self.captures = 0  # how many graphs were captured (recaptures show)

    def step_batches(self, batches, j: int) -> list:
        """The batches of the ``j``-th step from the per-position grouping."""
        return [batches[i * self.k + j] for i in range(self.n_batch_args)]

    def __call__(self, states, *batches) -> dict:
        if len(batches) != self.n_batch_args * self.k:
            raise ValueError(f"expected {self.n_batch_args} x {self.k} "
                             f"batches, got {len(batches)}")
        rows = [self.scalars(states, j) for j in range(self.k)]
        if self.device.type == "cuda":
            metrics = self._replay(states, batches, rows)
        else:
            outs = [self.step_core(states, *self.step_batches(batches, j),
                                   rows[j], self.generator)
                    for j in range(self.k)]
            metrics = {name: torch.stack([o[name] for o in outs])
                       for name in outs[0]}
        self.advance(states, self.k)
        for name in self.host_metrics:
            metrics[name] = [row[name] for row in rows]
        return metrics

    def _replay(self, states, batches, rows) -> dict:
        if dist.is_initialized() and dist.get_backend() != "nccl":
            raise RuntimeError(
                f"steps_per_call={self.k} captures the step's collectives in "
                f"a CUDA graph, which the {dist.get_backend()} backend "
                "cannot be; use NCCL (one process a card) or steps_per_call "
                "1")
        if any(b.device.type != "cuda" for b in batches):
            raise ValueError(f"a K-step graph reads its batches on "
                             f"{self.device}; upload them first")
        if self.graph is None or not self.graph.matches(self, states,
                                                        batches):
            self.graph = None  # its pool goes before the next is made
            self.graph = _Graph(self, states, batches, rows)
            self.captures += 1
        graph = self.graph
        graph.table.write(rows)
        for slot, batch in zip(graph.slots, batches):
            slot.copy_(batch)
        graph.graph.replay()
        LAUNCHES.update(graph.launches)
        return {name: v.clone() for name, v in graph.outs.items()}


class _ScalarTable:
    """K rows of a step's scalars on the device: the ints (stream offsets)
    as int64, every other number as fp32. ``rows[j]`` maps each name to
    its 0-dim view."""

    def __init__(self, rows: list[dict], device: torch.device):
        first = rows[0]
        self.ints = [n for n, v in first.items()
                     if isinstance(v, (int, np.integer))
                     and not isinstance(v, bool)]
        self.floats = [n for n in first if n not in self.ints]
        k = len(rows)
        self.i64 = torch.zeros((k, max(len(self.ints), 1)),
                               dtype=torch.int64, device=device)
        self.f32 = torch.zeros((k, max(len(self.floats), 1)),
                               dtype=torch.float32, device=device)
        self.rows = [{**{n: self.i64[j, c] for c, n in enumerate(self.ints)},
                      **{n: self.f32[j, c]
                         for c, n in enumerate(self.floats)}}
                     for j in range(k)]

    def write(self, rows: list[dict]) -> None:
        for table, names, dtype in ((self.i64, self.ints, np.int64),
                                    (self.f32, self.floats, np.float32)):
            if not names:
                continue
            host = np.array([[row[n] for n in names] for row in rows],
                            dtype=dtype)
            table.copy_(torch.from_numpy(host).pin_memory(),
                        non_blocking=True)


def _pointer(obj):
    return obj.data_ptr() if isinstance(obj, torch.Tensor) else None


class _Graph:
    """One capture of K steps on the states it was given."""

    def __init__(self, step: SuperStep, states, batches, rows):
        dev = step.device
        current = torch.cuda.current_stream(dev)
        if step.prepare is not None:
            step.prepare(states)
        self.objects = list(step.identity(states))
        self.pointers = [_pointer(o) for o in self.objects]
        self.key = step.key(states)
        self.shapes = [(b.shape, b.dtype, b.device) for b in batches]
        self.slots = [torch.empty_like(b) for b in batches]
        for slot, batch in zip(self.slots, batches):
            slot.copy_(batch)
        self.table = _ScalarTable(rows, dev)
        self.table.write(rows)

        # Warm-up: one step on a throwaway copy, on the capture stream.
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side), moved_launches():
            scratch = copy.deepcopy(states)
            generator = None
            if step.generator is not None:
                generator = torch.Generator(device=dev)
                generator.set_state(step.generator.get_state())
            step.step_core(scratch, *step.step_batches(self.slots, 0),
                           self.table.rows[0], generator)
            del scratch
        current.wait_stream(side)

        self.graph = torch.cuda.CUDAGraph()
        if step.generator is not None:
            self.graph.register_generator_state(step.generator)
        self.launches: collections.Counter = collections.Counter()
        with moved_launches(self.launches), torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            outs = [step.step_core(states, *step.step_batches(self.slots, j),
                                   self.table.rows[j], step.generator)
                    for j in range(step.k)]
            self.outs = {name: torch.stack([o[name] for o in outs])
                         for name in outs[0]}

    def matches(self, step: SuperStep, states, batches) -> bool:
        """Do ``states`` still hold the objects this graph was captured on,
        and are ``batches`` and the key what it was captured for?"""
        objects = list(step.identity(states))
        return (len(objects) == len(self.objects)
                and all(a is b for a, b in zip(objects, self.objects))
                and [_pointer(o) for o in objects] == self.pointers
                and [(b.shape, b.dtype, b.device) for b in batches]
                == self.shapes
                and step.key(states) == self.key)
