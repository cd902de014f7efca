"""The trace reduction on a synthetic Chrome trace with a warm-up window."""

import pytest

from bench_port import trace


def _ev(cat, name, ts_us, dur_us, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "args": args}


def _synthetic():
    return [
        # The warm-up window: its kernel is dropped.
        _ev("user_annotation", trace.WARMUP, 0.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, correlation=1),
        _ev("kernel", "warm_kernel", 20.0, 50.0, correlation=1),
        # The traced window, 1000 us.
        _ev("user_annotation", trace.TRACED, 200.0, 1000.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 210.0, 5.0, correlation=2),
        _ev("kernel", "conv_kernel", 300.0, 200.0, correlation=2),
        # Overlaps the first: the union counts it once.
        _ev("kernel", "warp_fused_kernel<unsigned char, 3>", 400.0, 200.0,
            correlation=2),
        # A graph kernel without a launch: placed by its own start.
        _ev("kernel", "conv_kernel", 700.0, 100.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 850.0, 5.0, correlation=3),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 860.0, 10.0,
            correlation=3, bytes=320),
        _ev("cpu_op", "aten::_local_scalar_dense", 880.0, 300.0),
        # Launched after the window: dropped.
        _ev("cuda_runtime", "cudaLaunchKernel", 1300.0, 2.0, correlation=4),
        _ev("kernel", "late_kernel", 1310.0, 20.0, correlation=4),
    ]


def test_traced_window_only_with_overlap_counted_once():
    a = trace.analyze(_synthetic())
    assert a["window_s"] == pytest.approx(1000e-6)
    # 300-600 (two overlapping kernels), 700-800, 860-870.
    assert a["busy_s"] == pytest.approx(410e-6)
    assert "warm_kernel" not in a["ops"] and "late_kernel" not in a["ops"]
    assert a["ops"]["conv_kernel"] == pytest.approx([300e-6, 2])
    assert a["h2d_bytes"] == 320
    assert a["device_events"] == 4


def test_idle_gaps_named_by_the_host():
    a = trace.analyze(_synthetic())
    gaps = dict(a["idle_gaps"])
    # 200-300, 600-700, 800-860, 870-1200 inside the window.
    assert sum(gaps.values()) == pytest.approx(590e-6)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(330e-6)


def test_no_traced_window_reads_nothing():
    events = [e for e in _synthetic() if e["name"] != trace.TRACED]
    assert trace.analyze(events) is None


def test_union_of_intervals():
    assert trace.union_ps([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union_ps([]) == 0
