"""The device trace of a run's traced phase, and its reduction.

``traced(device)`` runs the enclosed code under ``torch.profiler`` (host
ops and the card's kernels, copies and memsets), writes the Chrome trace
to a temporary file under ``TMPDIR``, reads it and deletes it.
``windows(name)`` marks a region of the enclosed code by a host
annotation: ``bench.warmup`` regions settle the profiler and are dropped,
``bench.traced`` regions are what the report covers.

``analyze`` is a copy of the arithmetic of the port's
``utils/profiling.py`` ``analyze_trace`` (the union of device intervals,
the picosecond spans, a device event belonging to the window that holds
its launch), with its one fault mended: windows other than the traced
ones, the warm-up among them, are dropped rather than counted. A device
event whose launch the trace does not hold (the kernels of a CUDA graph
replay may carry none) belongs to the window that holds its start.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TRACED = "bench.traced"
WARMUP = "bench.warmup"
NAMED_GAPS = 400  # the longest gaps each named by the host; the rest pooled
LOOK_BACK_PS = 50 * 10 ** 9


def union_ps(intervals) -> int:
    """Total covered picoseconds of possibly overlapping intervals."""
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


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_ps(event: dict) -> tuple[int, int]:
    """A complete event's (start, end) in picoseconds, rounded to whole
    nanoseconds first (the trace's unit is microseconds)."""
    start = round(event["ts"] * 1e3)
    return start * 1000, (start + round(event.get("dur", 0) * 1e3)) * 1000


def _correlation(event: dict):
    return event.get("args", {}).get("correlation")


def analyze(events: list, *, top_k: int = 10) -> dict | None:
    """Reduce a Chrome trace's events to the traced windows' figures:
    ``window_s`` (the windows' host time), ``busy_s`` (the union of the
    device events launched in them), ``ops`` (name -> [seconds, count]),
    ``h2d_bytes`` (None where the trace gives no copy's size),
    ``idle_gaps`` (the longest gaps between device work inside the
    windows, each named by the innermost host event around its middle)
    and ``device_events`` (their count). None when the trace has no
    traced window or no device event in one."""
    events = [e for e in events if e.get("ph") == "X"]
    windows = sorted(span_ps(e) for e in events
                     if e.get("cat") == "user_annotation"
                     and e.get("name") == TRACED)
    if not windows:
        return None
    launched = {_correlation(e): span_ps(e)[0] for e in events
                if e.get("cat") in LAUNCH_CATS}
    starts = [w[0] for w in windows]

    def window_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= windows[i][1] else None

    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = span_ps(e)
        at = launched.get(_correlation(e), s)
        i = window_of(at)
        if i is None:
            continue
        device.append((e, max(s, windows[i][0]), min(t, windows[i][1])))
    if not device:
        return None
    ops = collections.defaultdict(lambda: [0, 0])
    h2d, h2d_known = 0, True
    for e, s, t in device:
        row = ops[e.get("name", "")]
        row[0] += max(t - s, 0)
        row[1] += 1
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            n = e.get("args", {}).get("bytes")
            if n is None:
                h2d_known = False
            else:
                h2d += int(n)
    busy = union_ps([(s, t) for _, s, t in device if t > s])
    gaps = []
    for w0, w1 in windows:
        inside = merged([(s, t) for _, s, t in device
                         if t > s and s >= w0 and t <= w1])
        edges = [w0] + [x for iv in inside for x in iv] + [w1]
        gaps += [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                 if edges[k + 1] > edges[k]]
    host = sorted((span_ps(e), e.get("name", "")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("name") != TRACED)
    host_starts = [s for (s, _), _ in host]
    by_host = collections.Counter()
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[NAMED_GAPS:]:
        by_host["(shorter gaps)"] += g1 - g0
    for g0, g1 in gaps[:NAMED_GAPS]:
        # The innermost host event around the gap's middle that began at
        # most LOOK_BACK_PS before it, else the last one begun before the
        # gap ended (what the device waited for).
        mid = (g0 + g1) // 2
        lo = bisect.bisect_left(host_starts, mid - LOOK_BACK_PS)
        hi = bisect.bisect_right(host_starts, mid)
        around = [(t - s, name) for (s, t), name in host[lo:hi]
                  if s <= mid <= t]
        if around:
            name = min(around)[1]
        else:
            last = bisect.bisect_right(host_starts, g1) - 1
            name = host[last][1] if last >= 0 else "(no host event)"
        by_host[name] += g1 - g0
    window_ps = sum(w1 - w0 for w0, w1 in windows)
    return {
        "window_s": window_ps * 1e-12,
        "busy_s": busy * 1e-12,
        "ops": {k: [v[0] * 1e-12, v[1]] for k, v in ops.items()},
        "top_ops": [[k, v[0] * 1e-12] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1][0])[:top_k]],
        "h2d_bytes": h2d if h2d_known else None,
        "idle_gaps": [[k, v * 1e-12] for k, v in by_host.most_common(top_k)],
        "device_events": len(device),
    }


def window(name: str = TRACED):
    """A host annotation the analysis keys on."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def traced(device: torch.device):
    """Yield a dict that holds the trace's events once the block has
    ended (empty on a device the profiler cannot trace)."""
    out: dict = {"events": []}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        data = json.loads(Path(path).read_text())
    finally:
        os.unlink(path)
    out["events"] = (data["traceEvents"] if isinstance(data, dict)
                     else data)
