"""Profiling and step-timing hooks: ``torch.profiler`` traces and their
report.

Port of ``denoising_diffusion_deep_fake_tpu/utils/profiling.py``, with
``torch.profiler`` (Kineto, CUPTI on the card) in place of
``jax.profiler``:

* ``trace(log_dir)`` writes a Chrome-trace JSON of the enclosed region
  (host ops with their input shapes; kernels, copies and memsets on the
  card), which Perfetto or ``chrome://tracing`` open;
* ``annotate(name)`` labels a region (``torch.profiler.record_function``);
* ``StepTimer``: wall-clock step timing with warm-up discard;
* ``analyze_trace`` / ``analyze_trace_dir`` read a trace file into a
  per-device report (device busy against the steps' wall, time by
  category and by kernel, the port's own kernels' launches), so the CLI's
  ``profile --report`` and ``chip_smoke.py`` read traces without a viewer;
  ``kernel_origins`` names the host op that launched each kernel, with its
  input shapes, through the trace's launch correlation ids (what JAX's
  ``hlo_definitions`` answers on the TPU).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import re
import time
import warnings
from pathlib import Path

import torch

from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device

TRACE_SUFFIX = ".pt.trace.json"

# The device functions of the port's CUDA kernels (ops/cuda/csrc).
PORT_KERNELS = ("warp_fused_kernel", "warp_rows_kernel", "warp_cols_kernel",
                "normalise_noise_blend_u8_kernel", "noise_blend_f32_kernel")

# Events on the card's timeline, by the trace's category.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The host-side launch of a device event (its correlation id).
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# A step window, when the trace annotates steps (``prof.step()``).
_STEP_PREFIX = "ProfilerStep#"


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (a ``*.pt.trace.json`` file): host ops with their shapes,
    and on a CUDA ``device`` (the default) the card's activity. Yields the
    profiler: each ``step()`` call ends a ``ProfilerStep#`` window (the
    schedule records throughout, so no event is dropped)."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*warmup")
        prof = torch.profiler.profile(
            activities=activities, record_shapes=True,
            schedule=torch.profiler.schedule(wait=0, warmup=0,
                                             active=1 << 30))
    with prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the region's kernels ran
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}"
                                       f"{TRACE_SUFFIX}"))


def annotate(name: str):
    """Named trace region (shows in the profiler timeline)."""
    return torch.profiler.record_function(name)


# --------------------------------------------------------- trace analysis

# CUDA kernel names (substrings, lowercase), checked in order: PyTorch's
# generic reduce and elementwise kernels before the library kernels, whose
# names their template arguments may echo.
_KERNEL_RULES = [
    (PORT_KERNELS, "port_kernel"),
    (("memcpy",), "memcpy"),
    (("memset",), "memset"),
    (("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford"), "batch_norm"),
    (("upsample",), "upsample"),
    (("multi_tensor_apply", "adam"), "optimizer"),
    (("direct_copy", "catarraybatchedcopy"), "copy"),
    (("reduce_kernel",), "reduce"),
    (("elementwise",), "elementwise"),
    (("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn"),
     "convolution"),
    (("gemm", "cublas"), "matmul"),
]
# aten op names, by the op's name less a trailing ``_`` (in place).
_ATEN_RULES = [
    (lambda op: "batch_norm" in op, "batch_norm"),
    (lambda op: "upsample" in op, "upsample"),
    (lambda op: "adam" in op, "optimizer"),
    (lambda op: "conv" in op, "convolution"),
    (lambda op: op in ("mm", "addmm", "bmm", "matmul", "linear"), "matmul"),
    (lambda op: op in ("sum", "mean", "norm", "amax", "amin", "max", "min"),
     "reduce"),
    (lambda op: op in ("copy", "_to_copy", "to", "contiguous", "cat"),
     "copy"),
    (lambda op: op in ("add", "sub", "mul", "div", "neg", "clamp", "where",
                       "relu", "threshold_backward", "sqrt", "rsqrt",
                       "square", "pow", "exp", "log", "abs", "fill",
                       "lerp", "addcmul", "addcdiv"), "elementwise"),
]

_CATEGORY_RULES = [
    ("convolution", "convolution"),
    ("conv", "convolution"),
    ("dot", "matmul"),
    ("all-reduce", "collective"),
    ("all-gather", "collective"),
    ("reduce-scatter", "collective"),
    ("collective", "collective"),
    ("copy", "copy"),
    ("transpose", "transpose"),
    ("reduce-window", "reduce-window"),
    ("select-and-scatter", "reduce-window"),
    ("reduce", "reduce"),
    ("scatter", "scatter"),
    ("gather", "gather"),
    ("dynamic", "dynamic-slice"),
    ("rng", "rng"),
    ("sort", "sort"),
    ("fusion", "fusion"),
    ("loop", "fusion"),
    ("input", "fusion"),
    ("output", "fusion"),
]


# cuDNN's kernels that convert a tensor between NCHW and NHWC: a
# convolution whose input or weight is not in the layout it runs in.
_LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")


def categorize(name: str) -> str:
    """Map a CUDA kernel, aten op or HLO op name to a coarse cost category:
    an aten op by its name; a kernel by substring (the port's own kernels
    as ``port_kernel``, copies, memsets, batch norm, upsampling, the
    optimizer, reductions, elementwise, convolutions, GEMMs); else JAX's
    prefix rules for HLO names."""
    lower = name.lower()
    if lower.startswith("aten::"):
        op = lower[len("aten::"):].rstrip("_")
        return next((cat for rule, cat in _ATEN_RULES if rule(op)), "other")
    for keys, cat in _KERNEL_RULES:
        if any(k in lower for k in keys):
            return cat
    base = re.sub(r"^%", "", lower.split("/")[-1])
    for prefix, cat in _CATEGORY_RULES:
        if base.startswith(prefix):
            return cat
    return "other"


def union_ps(intervals: list[tuple[int, int]]) -> int:
    """Total covered picoseconds of possibly-overlapping intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        total += cur_e - cur_s
    return total


def _events(path) -> list[dict]:
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def _span_ps(event: dict) -> tuple[int, int]:
    """A complete event's (start, end) in picoseconds. The trace's unit is
    microseconds with nanosecond decimals: rounded to whole nanoseconds
    first, within a double's precision at the epoch's ~1e15 ns."""
    start = round(event["ts"] * 1e3)
    return start * 1000, (start + round(event.get("dur", 0) * 1e3)) * 1000


def _correlation(event: dict):
    return event.get("args", {}).get("correlation")


def _plane(event: dict) -> str:
    return f"cuda:{event.get('args', {}).get('device', event.get('pid'))}"


def analyze_trace(path, nsteps: int, top_k: int = 15,
                  per_category_k: int = 6) -> dict:
    """Per-device report from one ``torch.profiler`` Chrome trace: its
    kernels, memcpys and memsets (the JAX report's "XLA Ops") by device.

    * ``ops_busy_ms_per_step``: the union of their intervals, so overlap
      (a copy on a side stream under a kernel) is counted once;
    * ``module_wall_ms_per_step``: from the first to the last device event
      of each step window (``ProfilerStep#`` annotations; an event belongs
      to the step whose window holds its launch), or of the whole trace
      when the steps are not annotated; ``in_module_gap_ms_per_step`` the
      difference: the card's idle time;
    * ``category_ms_per_step`` (``categorize``), ``top_ops_ms_per_step``,
      ``top_ops_per_category``, ``n_distinct_ops`` and
      ``lines_ms_per_step`` (by stream): sums of durations;
    * ``port_kernels``: each of the port's kernels' ms a step and launch
      count;
    * ``memcpy``: the copies by direction (``HtoD``, ``DtoH``, ...), their
      count, bytes (None where the trace gives none) and ms a step.

    ``nsteps`` divides every time. ``planes`` lists the devices and
    ``events_by_category`` counts all the trace's events (a trace whose
    profiler saw no device activity shows it there).
    """
    events = [e for e in _events(path) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    launched = {_correlation(e): _span_ps(e)[0] for e in events
                if e.get("cat") in _LAUNCH_CATS}
    windows = sorted(_span_ps(e) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(_STEP_PREFIX))
    by_plane = collections.defaultdict(list)
    for e in device:
        by_plane[_plane(e)].append(e)

    def per_step(ps):
        return round(ps * 1e-9 / nsteps, 4)

    report: dict = {"planes": sorted(by_plane), "events_by_category": dict(
        collections.Counter(e.get("cat") for e in events))}
    for plane, evs in sorted(by_plane.items()):
        by_op: collections.Counter = collections.Counter()
        by_cat: collections.Counter = collections.Counter()
        by_line: collections.Counter = collections.Counter()
        by_cat_ops = collections.defaultdict(collections.Counter)
        launches: collections.Counter = collections.Counter()
        layout = [0, 0]
        copies = collections.defaultdict(lambda: [0, 0, 0])
        intervals = []
        for e in evs:
            s, t = _span_ps(e)
            name = e.get("name", "")
            cat = categorize(name)
            if e.get("cat") == "gpu_memcpy":
                row = copies[name.split()[1] if " " in name else name]
                n_bytes = e.get("args", {}).get("bytes")
                row[0] += 1
                row[1] = None if n_bytes is None or row[1] is None \
                    else row[1] + n_bytes
                row[2] += t - s
            by_op[name] += t - s
            by_cat[cat] += t - s
            by_cat_ops[cat][name] += t - s
            by_line[f"stream {e.get('args', {}).get('stream', e.get('tid'))}"
                    ] += t - s
            if cat == "port_kernel":
                launches[name] += 1
            if any(k in name for k in _LAYOUT_KERNELS):
                layout[0] += 1
                layout[1] += t - s
            intervals.append((s, t))
        busy = union_ps(intervals)
        wall = _wall_ps(evs, windows, launched)
        report[plane] = {
            "lines_ms_per_step": {k: per_step(v)
                                  for k, v in by_line.most_common()},
            "ops_busy_ms_per_step": per_step(busy),
            "module_wall_ms_per_step": per_step(wall),
            "in_module_gap_ms_per_step": per_step(wall - busy),
            "category_ms_per_step": {k: per_step(v)
                                     for k, v in by_cat.most_common()},
            "top_ops_ms_per_step": {k: per_step(v)
                                    for k, v in by_op.most_common(top_k)},
            "top_ops_per_category": {
                cat: {k: per_step(v)
                      for k, v in ops.most_common(per_category_k)}
                for cat, ops in sorted(by_cat_ops.items(),
                                       key=lambda kv: -sum(kv[1].values()))},
            "n_distinct_ops": len(by_op),
            "port_kernels": {
                fn: {"ms_per_step": per_step(sum(
                         v for k, v in by_cat_ops["port_kernel"].items()
                         if fn in k)),
                     "launches": sum(n for k, n in launches.items()
                                     if fn in k)}
                for fn in PORT_KERNELS
                if any(fn in k for k in launches)},
            "memcpy": {d: {"count": n, "bytes": b, "ms_per_step": per_step(ps)}
                       for d, (n, b, ps) in sorted(copies.items())},
            "layout_conversions": {"per_step": layout[0] / nsteps,
                                   "ms_per_step": per_step(layout[1])},
        }
    return report


def _wall_ps(events: list[dict], windows: list, launched: dict) -> int:
    """The sum over step windows of the span of the device events
    launched in each (the whole span with no windows)."""
    spans = [_span_ps(e) for e in events]
    if not windows:
        return max(t for _, t in spans) - min(s for s, _ in spans)
    starts = [w[0] for w in windows]
    first, last = {}, {}
    for e, (s, t) in zip(events, spans):
        at = launched.get(_correlation(e))
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if i < 0 or at > windows[i][1]:
            continue
        first[i] = min(first.get(i, s), s)
        last[i] = max(last.get(i, t), t)
    return sum(last[i] - first[i] for i in first)


def kernel_origins(path, names) -> dict[str, list[dict]]:
    """For each of ``names`` (a kernel's name or a part of it), the host
    ops that launched the kernels of that name: the innermost ``cpu_op``
    or annotation around each launch on its thread, with its input shapes
    (``Input Dims``) and how many of the kernels it launched, most first.
    Kernels whose launch the trace does not hold are counted under
    ``None``."""
    events = [e for e in _events(path) if e.get("ph") == "X"]
    launches = {_correlation(e): e for e in events
                if e.get("cat") in _LAUNCH_CATS}
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation"):
            ops[(e.get("pid"), e.get("tid"))].append(e)
    for thread in ops.values():
        thread.sort(key=lambda e: e["ts"])
    starts = {k: [e["ts"] for e in v] for k, v in ops.items()}

    def origin(kernel):
        launch = launches.get(_correlation(kernel))
        if launch is None:
            return None
        key = (launch.get("pid"), launch.get("tid"))
        thread = ops.get(key, [])
        i = bisect.bisect_right(starts.get(key, []), launch["ts"]) - 1
        while i >= 0:  # the last-started op still open at the launch
            op = thread[i]
            if op["ts"] + op.get("dur", 0) >= launch["ts"]:
                return (op["name"], json.dumps(
                    op.get("args", {}).get("Input Dims")))
            i -= 1
        return None

    out = {}
    for name in names:
        found = collections.Counter(
            origin(e) for e in events
            if e.get("cat") in _DEVICE_CATS and name in e.get("name", ""))
        out[name] = [
            {"op": None if key is None else key[0],
             "input_dims": None if key is None else json.loads(key[1]),
             "count": n}
            for key, n in found.most_common()]
    return out


def analyze_trace_dir(trace_dir, nsteps: int = 1,
                      top_k: int = 15) -> dict | None:
    """Analyze the newest trace file under ``trace_dir`` (None if none)."""
    paths = sorted(Path(trace_dir).rglob(f"*{TRACE_SUFFIX}"),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        return None
    return analyze_trace(paths[-1], nsteps, top_k=top_k)


class StepTimer:
    """Rolling train-step timing: call ``tick()`` once per step."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._count = 0
        self._t_last: float | None = None
        self._total = 0.0
        self._timed_steps = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._total += now - self._t_last
                self._timed_steps += 1
        self._t_last = now

    @property
    def mean_step_seconds(self) -> float:
        return self._total / self._timed_steps if self._timed_steps else 0.0

    def throughput(self, items_per_step: int) -> float:
        s = self.mean_step_seconds
        return items_per_step / s if s else 0.0
