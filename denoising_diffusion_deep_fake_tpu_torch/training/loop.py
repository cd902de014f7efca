"""The services every workload loop needs: logging, checkpoints, guards.

Port of ``denoising_diffusion_deep_fake_tpu/training/loop.py:29-422``, the
parts of ``pl.Trainer`` the reference leaned on:

* metrics are queued as device scalars, or for a K-step group
  (``log_step(..., n_steps=K)``, ``training/multi_step.py``) as ``(K,)``
  tensors and lists of K numbers; a worker thread fetches the whole
  backlog with one ``torch.cat(...).cpu()`` (which waits only for the
  steps that made them: it runs on the default stream behind them),
  NaN-guards every value, a group's at each of its steps, and writes one
  TensorBoard row a step on the ``log_every_n_steps`` cadence; image
  panels ride the same queue. The worker goes on while a K-step graph is
  captured: the capture is thread-local (see ``training/multi_step.py``);
* ``maybe_checkpoint`` saves on the ``checkpoint_every_hours`` cadence
  without blocking, at an epoch's end (``force``) at most once every
  ``last_checkpoint_min_interval_s``, and at the end (``final``), blocking;
* a non-finite metric raises ``TrainingDivergedError`` on the next
  ``log_step``, after an emergency checkpoint, or at ``close``;
* ``PreemptionGuard`` turns SIGTERM into a flag the runners check after
  every step: they save and stop.

In a process group (data parallelism, ``parallel/``) every rank runs the
loop in lockstep, as JAX's multi-process branches (``:124-190``) keep it:

* the metric check is synchronous: ``log_step`` fetches the step's
  metrics (the global batch's means, the same on every rank) and the
  ranks all-gather whether any found a non-finite one, so all raise at the
  same step instead of one leaving its peers blocked in a collective;
* ``preempted`` all-gathers the SIGTERM flags every 10 calls and every
  rank stops at the same boundary;
* ``want_images`` is rank 0's answer, broadcast: it picks the call (an
  image step or a K-step group), which must be the same on every rank;
* only the primary writes event files, panels and checkpoints.
"""

from __future__ import annotations

import math
import queue
import signal
import threading
import time
from typing import Any, Callable

import torch

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
    save_rng_state,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    allgather_flags,
    broadcast_one,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    training_mesh,
)
from denoising_diffusion_deep_fake_tpu_torch.utils import stragglers
from denoising_diffusion_deep_fake_tpu_torch.utils.logging_scheduler import (
    LoggingScheduler,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.tb import (
    NullLogger,
    TensorBoardLogger,
)

PREEMPTION_SYNC_EVERY = 10


class TrainingDivergedError(RuntimeError):
    """A train metric went NaN/Inf; an emergency checkpoint was saved."""


class PreemptionGuard:
    """SIGTERM -> a flag the loop checks after every step (save and exit).

    Installing is best-effort: signal handlers can only be set on the main
    thread; elsewhere the default behaviour stays."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._previous = {}
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not on the main thread
                pass

    def _on_signal(self, signum, frame):
        self._flag = True

    @property
    def triggered(self) -> bool:
        return self._flag

    def restore(self) -> None:
        for sig, previous in self._previous.items():
            try:
                signal.signal(sig, previous)
            except ValueError:
                pass
        self._previous = {}


class LoopContext:
    """Holds the cross-step services every workload loop needs. ``mesh``
    (``parallel/mesh.py``, the process group's when None) decides the
    lockstep and the primary rank."""

    def __init__(self, cfg, hparams: dict, *, workload: str,
                 clock: Callable[[], float] = time.time, mesh=None):
        self.cfg = cfg
        self.hparams = hparams
        self.workload = workload
        self.clock = clock
        self.mesh = training_mesh() if mesh is None else mesh
        self.primary = self.mesh.rank == 0
        self.tb = (TensorBoardLogger(f"{cfg.log_dir}/{workload}")
                   if self.primary else NullLogger())
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.image_scheduler = LoggingScheduler(clock)
        self._last_ckpt_time = clock()
        self.global_step = 0
        self.epoch = 0
        self.preemption = (PreemptionGuard() if cfg.handle_preemption
                           else None)
        self._preempt_calls = 0
        self._preempt_agreed = False
        # The worker fetches, NaN-guards and writes; divergence surfaces on
        # the next log_step (which has the states for the emergency save)
        # or at close(). A bounded queue holds the loop back if the worker
        # falls behind.
        self._metric_q: queue.Queue = queue.Queue(maxsize=64)
        self._diverged: list | None = None
        self._worker_error: BaseException | None = None
        self._stop_event = threading.Event()
        self._metric_thread = threading.Thread(
            target=self._metric_worker, name="metric-logger", daemon=True)
        self._metric_thread.start()

    def preempted(self) -> bool:
        """True once SIGTERM arrived: runners save and exit. In a process
        group the ranks' flags are all-gathered every
        ``PREEMPTION_SYNC_EVERY`` calls (the runners call this once a step,
        at the same point), and all stop once any was signalled."""
        if self.preemption is None:
            return False
        if not self.mesh.in_group:
            return self.preemption.triggered
        if self._preempt_agreed:
            return True
        self._preempt_calls += 1
        if self._preempt_calls % PREEMPTION_SYNC_EVERY:
            return False
        self._preempt_agreed = any(
            allgather_flags(self.preemption.triggered, self.mesh))
        return self._preempt_agreed

    # ------------------------------------------------------------- cadence

    def want_images(self) -> bool:
        """Is an image-panel step due (the wall-clock scheduler)? In a
        process group, rank 0's answer on every rank."""
        if not self.cfg.log_images:
            return False
        self.image_scheduler.update_with_step_number(self.global_step)
        want = self.image_scheduler.should_we_log_this_step()
        return bool(broadcast_one(want, self.mesh))

    def log_step(self, metrics: dict[str, Any],
                 images: dict[str, Any] | None = None,
                 states=None, generator=None, *, n_steps: int = 1) -> None:
        """Queue one step's metrics (device scalars or numbers) and panels,
        or a K-step group's (``n_steps=K``: ``(K,)`` tensors or lists, the
        rows of steps ``global_step .. global_step + K - 1``); first raise a
        divergence the worker found in an earlier step."""
        self._raise_if_diverged(states, generator)
        step = self.global_step
        every = self.cfg.log_every_n_steps
        due = any((step + j) % every == 0 for j in range(n_steps))
        if due or images:
            item = (step, float(self.epoch), metrics if due else None,
                    images if self.primary else None, n_steps)
            if self.mesh.in_group:
                # Lockstep: fetch and check here, and raise on every rank
                # at this step if any found a non-finite value.
                self._log_metric_items([item])
                flags = allgather_flags(self._diverged is not None,
                                        self.mesh)
                if any(flags) and self._diverged is None:
                    self._diverged = [step, [
                        f"a metric on rank {flags.index(True)}"]]
                self._raise_if_diverged(states, generator)
                return
            self._metric_q.put(item)

    # -------------------------------------------------- async scalar worker

    def _metric_worker(self) -> None:
        while True:
            try:
                first = self._metric_q.get(timeout=0.25)
            except queue.Empty:
                if self._stop_event.is_set():  # abort(): exit without drain
                    return
                continue
            items = [first]
            while len(items) < 64:
                try:
                    items.append(self._metric_q.get_nowait())
                except queue.Empty:
                    break
            stop = None in items
            items = [it for it in items if it is not None]
            try:
                if (items and self._diverged is None
                        and not self._stop_event.is_set()):
                    self._log_metric_items(items)
            except Exception as e:  # surfaced on the main thread
                self._worker_error = e
            finally:
                for _ in items:
                    self._metric_q.task_done()
            if stop:
                self._metric_q.task_done()  # the None sentinel
                return

    def _log_metric_items(self, items: list) -> None:
        scalar_items = [(s, e, m, n) for s, e, m, _, n in items
                        if m is not None]
        fetched_all = fetch_scalars([m for _, _, m, _ in scalar_items])
        every = self.cfg.log_every_n_steps
        for (step, epoch, _, n), fetched in zip(scalar_items, fetched_all):
            # Every value is NaN-guarded, a group's steps off the logging
            # cadence too, so a divergence is reported at its true step.
            for j in range(n):
                row = {k: v[j] if len(v) > 1 else v[0]
                       for k, v in fetched.items()}
                bad = [k for k, v in row.items() if not math.isfinite(v)]
                if bad:
                    self._diverged = [step + j, bad]
                    return  # skip logging this and later queued steps
                if (step + j) % every == 0:
                    self.tb.log_scalars(dict(row, epoch=epoch), step + j)
        for step, _, _, images, _ in items:
            for tag, grid in (images or {}).items():
                self.tb.log_batch_as_image_grid(tag, grid, step)

    def drain_metrics(self, states=None, generator=None) -> None:
        """Block until queued fetches finish; raise on divergence."""
        self._metric_q.join()
        self._raise_if_diverged(states, generator)

    def _raise_if_diverged(self, states=None, generator=None) -> None:
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err
        if self._diverged is None:
            return
        (step, bad), self._diverged = self._diverged, None  # report once
        if states is not None:
            self.maybe_checkpoint(states, generator, final=True)
        raise TrainingDivergedError(
            f"non-finite metric(s) {bad} at step {step}"
            + ("; emergency checkpoint saved" if states is not None else ""))

    def maybe_checkpoint(self, states, generator: torch.Generator | None,
                         *, force: bool = False, final: bool = False) -> None:
        """Save when the wall-clock cadence is due (without blocking); an
        epoch-end save (``force``) at most once every
        ``last_checkpoint_min_interval_s``; ``final`` always, blocking.
        ``generator``, the trainer's (None for the balancer, which has
        none), is saved with the states. Only the primary saves."""
        if not self.primary:
            return
        elapsed_s = self.clock() - self._last_ckpt_time
        due = elapsed_s / 3600.0 >= self.cfg.checkpoint_every_hours
        forced_ok = (force and elapsed_s
                     >= self.cfg.last_checkpoint_min_interval_s)
        if final or due or forced_ok:
            self._last_ckpt_time = self.clock()
            extra = {"epoch": self.epoch, "global_step": self.global_step,
                     "workload": self.workload}
            if generator is not None:
                extra = save_rng_state(extra, generator)
            self.ckpt.save(self.global_step, states, self.hparams, extra,
                           block=final)

    def abort(self) -> None:
        """Teardown on an error path: stop the worker and the checkpoint
        thread without draining or raising (the caller's exception is the
        one to see)."""
        try:
            if self.preemption is not None:
                self.preemption.restore()
            self._stop_event.set()
            self._metric_thread.join(timeout=10.0)
            if self._metric_thread.is_alive():
                # Mid fetch: one more bounded join at exit, before
                # finalization would end it inside native frames.
                stragglers.adopt(self._metric_thread)
            self.ckpt.wait_until_finished()
            self.tb.flush()
            self.tb.close()
        except Exception:
            pass

    def close(self) -> None:
        if self.preemption is not None:
            self.preemption.restore()
        self._metric_q.join()
        self._metric_q.put(None)  # stop the worker
        self._metric_thread.join()
        self.ckpt.wait_until_finished()
        self.tb.flush()
        self.tb.close()
        # A divergence found only in the final drain: the runner's final
        # checkpoint holds the state; raise so the run is not mistaken
        # for a clean finish.
        self._raise_if_diverged()


def fetch_scalars(metric_dicts: list[dict[str, Any]]
                  ) -> list[dict[str, list[float]]]:
    """Many dicts of metrics as lists of floats: a device scalar or number
    gives one, a ``(K,)`` tensor or a list of K numbers (a K-step group's)
    K; the tensors of each device are fetched with one
    ``torch.cat(...).cpu()``."""
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for m in metric_dicts:
        for v in m.values():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(
                    v.detach().reshape(-1).to(torch.float32))
    fetched = {dev: iter(torch.cat(ts).cpu().tolist())
               for dev, ts in by_device.items()}

    def values(v) -> list[float]:
        if isinstance(v, torch.Tensor):
            return [next(fetched[v.device]) for _ in range(v.numel())]
        if isinstance(v, (list, tuple)):
            return [float(x) for x in v]
        return [float(v)]

    return [{k: values(v) for k, v in m.items()} for m in metric_dicts]
