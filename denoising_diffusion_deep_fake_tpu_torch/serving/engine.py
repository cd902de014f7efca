"""SwapEngine: persistent, micro-batching face-swap inference engine.

Port of ``denoising_diffusion_deep_fake_tpu/serving/engine.py`` (no
reference counterpart). Admission control, deadlines, the holdover slot,
padding and the stats are the JAX engine's, unchanged:

* the checkpoint is partially restored once (one identity's weights only)
  and the uint8->uint8 pipeline is built once at startup
  (``inference.make_device_pipeline``); every device batch has the one
  static batch size, so cuDNN sees one shape,
* concurrent callers are **micro-batched**: a dispatcher thread packs queued
  requests into the static device batch (padding the remainder), so N
  clients share one forward instead of N serialized ones,
* transfers are uint8 both ways: the dispatcher stages each batch in one
  pinned host buffer, uploads it asynchronously and fetches the result
  with ``.cpu()``, the barrier before the buffer is refilled,
* per-request latency is bounded by ``max_wait_ms``: a lone request never
  waits longer than that for company.

The dispatcher thread sets its CUDA device and enters inference mode
itself: both are thread-local in PyTorch. The device wire format is
``rgb`` or ``i420`` (4:2:0-packed, half the bytes; ``swap()`` packs and
unpacks on the request thread).

``devices=n`` serves n replicas (JAX ``:161-164, :207-219``): one model
copy, pipeline and dispatcher thread a device, ``cuda:0 .. n-1``, all
pulling from the one request queue. With ``device="cpu"`` the replicas
share the CPU (and its one model copy), standing in for JAX's virtual CPU
devices. A single-pass swap gives the same frames whichever replica serves
them; DDIM noise is keyed by the replica index too
(``inference.make_device_pipeline``'s ``replica``).

The engine is transport-agnostic; ``serving/server.py`` puts HTTP in front.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device
from denoising_diffusion_deep_fake_tpu_torch.inference import (
    load_swap_model,
    make_device_pipeline,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    pack_rgb_batch_to_i420_np,
    unpack_i420_batch_to_rgb_np,
    validate_i420_dims,
)


class EngineOverloadedError(RuntimeError):
    """Request shed: admitting it would push the queue past its watermark.

    ``retry_after_s`` estimates when the backlog will have drained (from the
    rolling device-batch throughput) — HTTP front-ends surface it as a
    ``Retry-After`` header on the 503.
    """

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestExpiredError(RuntimeError):
    """The request's deadline passed before its result was delivered.

    Two paths raise it (admitted work must be cancellable, or overload
    burns scarce device batches on callers that already gave up): the
    DISPATCHER refuses to pack an expired request
    into a device batch (work skipped pre-dispatch, frames released), and
    the WAITER gives up at the deadline instead of blocking until engine
    close. HTTP front-ends surface it as 504."""


@dataclasses.dataclass
class EngineStats:
    """Cumulative serving counters (read via ``SwapEngine.stats()``)."""

    requests: int = 0
    frames: int = 0
    batches: int = 0
    padded_slots: int = 0          # device-batch slots wasted on padding
    total_device_ms: float = 0.0   # dispatch->fetch wall time, device batches
    errors: int = 0
    shed_requests: int = 0         # calls rejected by admission control
    early_shed_requests: int = 0   # subset shed BEFORE the body was read
    expired_requests: int = 0      # client calls that hit their deadline
    expired_dropped_frames: int = 0  # frames skipped at gather pre-dispatch
    queue_high_water: int = 0      # max queued frames ever observed
    # Rolling window of recent device-batch times for percentile reporting.
    recent_batch_ms: list = dataclasses.field(default_factory=list)
    RECENT_CAP = 512

    @property
    def occupancy(self) -> float:
        """Mean fraction of each device batch holding real frames."""
        total = self.frames + self.padded_slots
        return self.frames / total if total else 0.0


class _Request:
    """One queue entry (a batch-size-or-smaller frame slice) awaiting its
    swapped result.

    Deadline protocol: the waiter and the dispatcher race at the deadline,
    resolved under ``_lock`` by a 3-state machine — ``pending`` (queued)
    -> ``claimed`` (dispatcher packed it into a device batch; the result
    WILL arrive) or ``expired`` (whoever noticed the deadline first failed
    it; the dispatcher then skips it at gather time, saving the device
    work). A claimed request can no longer be expired — its batch is in
    flight — but the waiter still stops waiting at the deadline.
    """

    __slots__ = ("frames", "event", "result", "error", "deadline",
                 "_lock", "_state")

    def __init__(self, frames: np.ndarray, deadline: float | None = None):
        self.frames = frames
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.deadline = deadline  # time.monotonic() timestamp, or None
        self._lock = threading.Lock()
        self._state = "pending"

    def try_claim(self) -> bool:
        """Dispatcher side: claim for dispatch unless the deadline passed
        (in which case the request is failed here and False returned)."""
        with self._lock:
            if self._state == "expired":
                return False
            if (self.deadline is not None
                    and time.monotonic() >= self.deadline):
                self._state = "expired"
                self.error = RequestExpiredError(
                    "request deadline passed while queued; dropped before "
                    "dispatch")
                self.event.set()
                return False
            self._state = "claimed"
            return True

    def try_expire(self) -> str:
        """Waiter side at the deadline: expire if still pending; returns
        the resulting state ('expired' or 'claimed')."""
        with self._lock:
            if self._state == "pending":
                self._state = "expired"
                self.error = RequestExpiredError(
                    "request deadline passed while queued")
                self.event.set()
            return self._state


def replica_devices(device, devices: int) -> list[torch.device]:
    """The device of each of ``devices`` replicas: ``cuda:0 .. n-1`` on
    the GPU (raising past the cards there are), the given device for one,
    the CPU ``n`` times."""
    dev = resolve_device(device)
    if devices < 1:
        raise ValueError(f"devices={devices}: need at least one replica")
    if dev.type == "cuda":
        available = torch.cuda.device_count()
        if devices > available:
            raise ValueError(f"devices={devices} but {available} CUDA "
                             "device(s) are available")
        if devices > 1:
            return [torch.device("cuda", i) for i in range(devices)]
    return [dev] * devices


class SwapEngine:
    """Micro-batching inference engine over one loaded swap model.

    ``swap()`` accepts RGB uint8 arrays of shape (H, W, 3) or (N, H, W, 3)
    with N <= batch_size and blocks until the swapped frames return. Any
    number of threads may call it concurrently; their frames ride shared
    device batches. The engine runs on ``cuda`` unless given ``device``,
    with ``devices`` replicas (the module docstring).
    """

    def __init__(self, checkpoint_path, identity: str, *, height: int,
                 width: int, batch_size: int = 8, use_ema: bool = False,
                 sampler_steps: int = 0, max_wait_ms: float = 5.0,
                 seed: int = 0, transfer: str = "rgb", devices: int = 1,
                 max_queue_frames: int | None = None,
                 request_deadline_ms: float | None = None, device=None):
        if transfer not in ("rgb", "i420"):
            raise ValueError(f"transfer must be 'rgb' or 'i420', "
                             f"got {transfer!r}")
        if transfer == "i420":
            validate_i420_dims(height, width)
        replicas = replica_devices(device, devices)
        self.height, self.width = height, width
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.identity = identity
        # Host<->device wire format: "i420" carries half the bytes a frame.
        self.transfer = transfer
        self.model = load_swap_model(checkpoint_path, identity,
                                     use_ema=use_ema, image_size=height,
                                     device=replicas[0])
        self._queue: queue.Queue = queue.Queue()
        self._stats = EngineStats()
        self._stats_lock = threading.Lock()
        self._closed = False
        # Admission control: ``swap_wire`` rejects (EngineOverloadedError)
        # when admitting a call would push the number of QUEUED frames past
        # this watermark, so a client burst beyond device throughput degrades
        # into clean 503-style shedding with bounded queueing delay instead of
        # unbounded queue growth + unbounded latency for every caller. The
        # default (8 device batches a replica) bounds queueing delay to
        # ~8x the device batch time. Must be >= the largest frame stack a
        # single call may carry, or that call can never be admitted.
        if max_queue_frames is None:
            max_queue_frames = 8 * batch_size * devices
        if max_queue_frames < batch_size:
            raise ValueError(
                f"max_queue_frames={max_queue_frames} is below "
                f"batch_size={batch_size} — single full batches could "
                "never be admitted")
        self.max_queue_frames = max_queue_frames
        # Default per-request deadline. Admission control bounds QUEUE depth;
        # the deadline bounds how stale the work the device runs may be:
        # under overload a caller that timed out (or disconnected) would
        # otherwise still burn a device batch when its turn came — exactly
        # when batches are scarce. None/0 = no deadline (prior behavior);
        # per-call override via swap(..., deadline_ms=...).
        self.request_deadline_ms = request_deadline_ms or None
        self._queued_frames = 0  # guarded by _stats_lock
        # One dispatcher thread a replica over the shared request queue. The
        # DDIM noise is keyed by (seed, replica, batch index).
        self.devices = devices
        models = {replicas[0]: self.model}
        self._dispatchers = []
        for i, dev in enumerate(replicas):
            if dev not in models:
                models[dev] = load_swap_model(
                    checkpoint_path, identity, use_ema=use_ema,
                    image_size=height, device=dev)
            pipeline = make_device_pipeline(
                models[dev], sampler_steps=sampler_steps, transfer=transfer,
                seed=seed, replica=i)
            # The parameters' device carries the CUDA index the dispatcher
            # thread must select.
            self._dispatchers.append(_Dispatcher(
                self, pipeline, next(models[dev].model.parameters()).device))
        for d in self._dispatchers:
            d.thread.start()

    # ------------------------------------------------------------------ API

    @property
    def wire_frame_shape(self) -> tuple[int, ...]:
        """Per-frame shape in the engine's device wire format."""
        if self.transfer == "i420":
            return (self.height * 3 // 2, self.width)
        return (self.height, self.width, 3)

    def warmup(self) -> float:
        """Run one zero batch (cuDNN picks its algorithms, the kernels are
        built); returns the seconds taken.

        Deadline-exempt (``deadline_ms=0``): an engine-wide
        ``request_deadline_ms`` tuned for serving (hundreds of ms) would
        expire the first batch, which builds and plans."""
        t0 = time.perf_counter()
        zero = np.zeros((1,) + self.wire_frame_shape, np.uint8)
        self.swap_wire(zero, deadline_ms=0)
        return time.perf_counter() - t0

    def swap(self, rgb_u8: np.ndarray, *,
             deadline_ms: float | None = None) -> np.ndarray:
        """Swap RGB frame(s); blocks until done. Thread-safe.

        With ``transfer="i420"`` the frames are packed and unpacked on THIS
        (request) thread, so host work spreads over the clients while the
        device wire carries half the bytes. ``deadline_ms`` overrides the
        engine's ``request_deadline_ms`` for this call (see ``swap_wire``).
        """
        squeeze = rgb_u8.ndim == 3
        frames = rgb_u8[None] if squeeze else rgb_u8
        expected = (self.height, self.width, 3)
        if frames.ndim != 4 or frames.shape[1:] != expected:
            raise ValueError(
                f"expected frames of shape {expected}, got {rgb_u8.shape}")
        if self.transfer == "i420":
            packed = self.swap_wire(pack_rgb_batch_to_i420_np(frames),
                                    deadline_ms=deadline_ms)
            out = unpack_i420_batch_to_rgb_np(packed)
        else:
            out = self.swap_wire(frames, deadline_ms=deadline_ms)
        return out[0] if squeeze else out

    def check_admission(self, n_frames: int) -> None:
        """Advisory pre-payload admission probe (no reservation made).

        HTTP front-ends call this after parsing headers but BEFORE reading
        the request body: on a byte-bound raw-RGB wire the HTTP stream can
        saturate while the queue sits below the watermark, and every shed
        request would then have cost a full body read. Probing on the header
        alone sheds those requests for the price of the request line, so
        overload never pays the payload.

        The probe does NOT reserve capacity — ``swap_wire``'s all-or-nothing
        check remains the authoritative admission decision (a request that
        passes the probe can still be shed there if the queue filled while
        its body streamed in).
        """
        with self._stats_lock:
            if self._queued_frames + n_frames > self.max_queue_frames:
                self._stats.shed_requests += 1
                self._stats.early_shed_requests += 1
                depth = self._queued_frames
                retry = self._estimate_drain_s_locked(depth + n_frames)
                raise EngineOverloadedError(
                    f"engine overloaded: {depth} frames queued "
                    f"(watermark {self.max_queue_frames}), retry in "
                    f"~{retry:.1f}s", retry)

    def swap_wire(self, frames: np.ndarray, *,
                  deadline_ms: float | None = None) -> np.ndarray:
        """Swap a frame stack already in the engine's wire format (see
        ``wire_frame_shape``): the path without conversions for clients
        that speak that format (HTTP ``X-Format`` pass-through).

        ``deadline_ms`` (default: the engine's ``request_deadline_ms``)
        bounds the WHOLE call: if it elapses before the result is delivered,
        ``RequestExpiredError`` is raised — and any of the call's slices the
        dispatcher has not yet packed into a device batch are dropped at
        gather time instead of burning device work for a caller that gave
        up. 0/None disables the deadline for this call.
        """
        if self._closed:
            raise RuntimeError("engine closed")
        expected = self.wire_frame_shape
        if frames.ndim != len(expected) + 1 or frames.shape[1:] != expected:
            raise ValueError(
                f"expected {self.transfer} wire frames of shape {expected}, "
                f"got {frames.shape}")
        if frames.dtype != np.uint8:
            raise ValueError(f"expected uint8 frames, got {frames.dtype}")
        # Admission control (all-or-nothing over the whole call: partial
        # enqueues would return partial stacks). Raising BEFORE any slice is
        # queued keeps shedding O(1) — no device work, no queue churn.
        total = frames.shape[0]
        with self._stats_lock:
            if self._queued_frames + total > self.max_queue_frames:
                self._stats.shed_requests += 1
                depth = self._queued_frames
                retry = self._estimate_drain_s_locked(depth + total)
                raise EngineOverloadedError(
                    f"engine overloaded: {depth} frames queued "
                    f"(watermark {self.max_queue_frames}), retry in "
                    f"~{retry:.1f}s", retry)
            self._queued_frames += total
            self._stats.queue_high_water = max(
                self._stats.queue_high_water, self._queued_frames)
        if deadline_ms is None:
            deadline_ms = self.request_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms else None)
        # Oversize stacks: enqueue EVERY slice before waiting on any, so
        # slice k+1's upload overlaps slice k's compute/download instead of
        # running strictly sequential round-trips.
        requests = [self._submit(frames[i:i + self.batch_size], deadline)
                    for i in range(0, frames.shape[0], self.batch_size)]
        try:
            results = [self._wait(r) for r in requests]
        except RequestExpiredError:
            with self._stats_lock:
                self._stats.expired_requests += 1
            raise
        with self._stats_lock:
            self._stats.requests += 1  # one client call, however many slices
        return (results[0] if len(results) == 1
                else np.concatenate(results, axis=0))

    def _submit(self, frames: np.ndarray,
                deadline: float | None = None) -> _Request:
        req = _Request(np.ascontiguousarray(frames), deadline)
        self._queue.put(req)
        return req

    def _note_dequeued(self, n_frames: int) -> None:
        """Dispatcher took ``n_frames`` out of the queue (into a batch)."""
        with self._stats_lock:
            self._queued_frames -= n_frames

    def _note_expired(self, n_frames: int) -> None:
        """Dispatcher skipped an expired request pre-dispatch: device work
        saved (its frames were already released from the watermark when it
        was dequeued)."""
        with self._stats_lock:
            self._stats.expired_dropped_frames += n_frames

    def _estimate_drain_s_locked(self, backlog_frames: int) -> float:
        """Seconds until ``backlog_frames`` drain, from rolling throughput.

        Caller holds ``_stats_lock``. Before any batch has completed (cold
        start) a flat 1 s is returned.
        """
        s = self._stats
        if not s.batches or not s.total_device_ms:
            return 1.0
        frames_per_s = (self.batch_size * self.devices
                        / (s.total_device_ms / s.batches / 1000.0))
        return max(0.1, backlog_frames / frames_per_s)

    def _wait(self, req: _Request) -> np.ndarray:
        # Liveness-checked wait: a request that slipped into the queue while
        # close() was draining, or one queued behind a dispatcher that
        # stopped, would otherwise block its caller forever.
        # Deadline-checked wait: at the deadline, expire the request if it
        # is still queued (the dispatcher then skips it — device work saved)
        # and stop waiting EITHER WAY: a claimed request's batch is in
        # flight, but its caller already owes its client an answer, so it
        # raises now instead of riding out the batch (the delivered result
        # is discarded — the batch was unavoidable once packed).
        while True:
            timeout = 1.0
            if req.deadline is not None:
                timeout = min(timeout, req.deadline - time.monotonic())
            if req.event.wait(timeout=max(timeout, 0.0)):
                break
            if (req.deadline is not None
                    and time.monotonic() >= req.deadline):
                req.try_expire()  # pending -> expired (dispatcher will skip)
                raise RequestExpiredError(
                    "request deadline passed before the result was "
                    "delivered")
            if not any(d.thread.is_alive() for d in self._dispatchers):
                raise RuntimeError("engine closed" if self._closed else
                                   "engine dispatcher stopped")
        if req.error is not None:
            raise req.error
        return req.result

    def stats(self) -> dict:
        with self._stats_lock:
            s = self._stats
            return {
                "requests": s.requests,
                "frames": s.frames,
                "batches": s.batches,
                "batch_occupancy": round(s.occupancy, 4),
                "mean_device_batch_ms": round(
                    s.total_device_ms / s.batches, 3) if s.batches else 0.0,
                "p50_device_batch_ms": round(float(np.percentile(
                    s.recent_batch_ms, 50)), 3) if s.recent_batch_ms else 0.0,
                "p99_device_batch_ms": round(float(np.percentile(
                    s.recent_batch_ms, 99)), 3) if s.recent_batch_ms else 0.0,
                "errors": s.errors,
                "queue_depth": self._queued_frames,
                "queue_high_water": s.queue_high_water,
                "shed_requests": s.shed_requests,
                "early_shed_requests": s.early_shed_requests,
                "expired_requests": s.expired_requests,
                "expired_dropped_frames": s.expired_dropped_frames,
                "request_deadline_ms": self.request_deadline_ms,
                "max_queue_frames": self.max_queue_frames,
                "batch_size": self.batch_size,
                "identity": self.identity,
                "frame_shape": [self.height, self.width, 3],
                "transfer": self.transfer,
                "devices": self.devices,
            }

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)  # _gather re-signals: one sentinel stops all
        for d in self._dispatchers:
            d.thread.join(timeout=5.0)
        # Fail any requests that raced past the shutdown sentinel.
        for d in self._dispatchers:  # dispatchers joined; safe to read
            if d.pending is not None:
                d.pending.error = RuntimeError("engine closed")
                d.pending.event.set()
                d.pending = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.error = RuntimeError("engine closed")
                item.event.set()


class _Dispatcher:
    """One replica: the pipeline on its device + its batch-packing thread.

    The holdover slot (``pending``) keeps a request that didn't fit this
    replica's current batch at the HEAD of its next one instead of re-queuing it
    behind newer arrivals (which starves large requests under sustained
    load); it is touched only by this dispatcher's thread (and by
    ``close()`` after the join).
    """

    def __init__(self, engine: "SwapEngine", pipeline, device: torch.device):
        self.engine = engine
        self.pipeline = pipeline
        self.device = device
        self.batch_idx = 0
        self.pending: _Request | None = None
        self.thread = threading.Thread(target=self._dispatch_loop,
                                       daemon=True)

    def _gather(self) -> list[_Request] | None:
        """Collect requests for one device batch (None = shutdown).

        Every request is CLAIMED (``_Request.try_claim``) before it enters
        the batch: one that expired while queued is failed + skipped here —
        under overload, when device batches are scarce, expired work never
        reaches the device. The holdover slot stays unclaimed until it
        heads its own batch, so it too can expire while holding over.
        """
        eng = self.engine
        while True:
            if self.pending is not None:
                first, self.pending = self.pending, None
            else:
                first = eng._queue.get()
                if first is None:
                    eng._queue.put(None)  # wake the other replicas
                    return None
                eng._note_dequeued(first.frames.shape[0])
            if first.try_claim():
                break
            eng._note_expired(first.frames.shape[0])
        batch = [first]
        filled = first.frames.shape[0]
        deadline = time.monotonic() + eng.max_wait_s
        while filled < eng.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = eng._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                eng._queue.put(None)  # re-signal shutdown after this batch
                break
            eng._note_dequeued(nxt.frames.shape[0])
            if filled + nxt.frames.shape[0] > eng.batch_size:
                self.pending = nxt     # doesn't fit; heads the next batch
                break
            if not nxt.try_claim():
                eng._note_expired(nxt.frames.shape[0])
                continue
            batch.append(nxt)
            filled += nxt.frames.shape[0]
        return batch

    def _dispatch_loop(self) -> None:
        # The current device and inference mode are thread-local.
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._serve(cuda)

    def _serve(self, cuda: bool) -> None:
        eng = self.engine
        # One host staging buffer, pinned on the GPU so the upload is
        # asynchronous; each batch's ``.cpu()`` fetch waits for the device,
        # so the upload has ended before the buffer is refilled.
        staging = torch.empty((eng.batch_size,) + eng.wire_frame_shape,
                              dtype=torch.uint8, pin_memory=cuda)
        staging_np = staging.numpy()
        while True:
            batch = self._gather()
            if batch is None:
                return
            try:
                offset = 0
                for r in batch:
                    n = r.frames.shape[0]
                    staging_np[offset:offset + n] = r.frames
                    offset += n
                filled = offset
                pad = eng.batch_size - filled
                staging_np[filled:] = 0
                t0 = time.perf_counter()
                dev_arr = staging.to(self.device, non_blocking=True)
                fake = self.pipeline(dev_arr, self.batch_idx)
                fake_np = fake.cpu().numpy()  # the fetch = device barrier
                dt_ms = (time.perf_counter() - t0) * 1000.0
                self.batch_idx += 1
                offset = 0
                for r in batch:
                    n = r.frames.shape[0]
                    r.result = fake_np[offset:offset + n]
                    offset += n
                    r.event.set()
                with eng._stats_lock:
                    s = eng._stats
                    s.frames += filled
                    s.batches += 1
                    s.padded_slots += pad
                    s.total_device_ms += dt_ms
                    s.recent_batch_ms.append(dt_ms)
                    if len(s.recent_batch_ms) > EngineStats.RECENT_CAP:
                        del s.recent_batch_ms[:-EngineStats.RECENT_CAP]
            except BaseException as e:  # deliver, don't kill the dispatcher
                for r in batch:
                    r.error = e
                    r.event.set()
                with eng._stats_lock:
                    eng._stats.errors += 1
