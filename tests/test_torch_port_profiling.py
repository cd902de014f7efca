"""The port's tooling on the CPU: ``utils/profiling.py``, ``utils/timing.py``,
``utils/stragglers.py`` and the CLI's ``profile``.

* ``union_ps`` and ``categorize`` on the cases of
  ``tests/test_step_profile.py`` (run through both packages) plus CUDA
  kernel and aten op names;
* ``analyze_trace`` on a hand-written Chrome trace of two devices' kernels,
  copies and memsets: busy as a union, division by ``nsteps``, per-category
  tops, the port's kernels' launches, the module wall over step windows;
  ``kernel_origins`` through the launch correlation ids;
* ``trace()`` of a few CPU ops writes a file that ``analyze_trace_dir``
  finds; ``StepTimer``, ``timed_loop`` and ``timed_fn`` on the CPU;
* the cases of ``tests/test_stragglers.py`` against the port's registry,
  ``LoopContext.abort`` and the loader's prefetch thread;
* ``main.py profile``: its options carry JAX's names, ``--help`` parses,
  and a 32^2 run with ``--device cpu`` writes a trace and prints its
  report.
"""

import json
import shutil
import threading
import time

import click
import pytest
import torch
import yaml

from denoising_diffusion_deep_fake_tpu.main import cli as jax_cli
from denoising_diffusion_deep_fake_tpu.utils import profiling as jax_profiling
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.data import loader as port_loader
from denoising_diffusion_deep_fake_tpu_torch.main import build_parser, main
from denoising_diffusion_deep_fake_tpu_torch.training.loop import LoopContext
from denoising_diffusion_deep_fake_tpu_torch.utils import profiling
from denoising_diffusion_deep_fake_tpu_torch.utils import stragglers
from denoising_diffusion_deep_fake_tpu_torch.utils import timing

from helpers import make_image_dataset
from test_torch_port_cli import _port_options


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the traces and checkpoints
    written here would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------------- categories

UNION_CASES = [([], 0), ([(0, 10)], 10), ([(0, 10), (5, 20), (30, 40)], 30),
               ([(0, 10), (10, 20)], 20), ([(30, 40), (0, 10), (5, 20)], 30)]


@pytest.mark.parametrize("intervals,want", UNION_CASES)
def test_union_ps_matches_jax(intervals, want):
    assert profiling.union_ps(intervals) == want
    assert jax_profiling.union_ps(intervals) == want


HLO_NAMES = ["%convolution.42", "fusion.123", "loop_multiply_fusion.7",
             "copy.3", "all-reduce.1", "dot.9", "jit_step/transpose.2",
             "weird-op.5"]
DEVICE_NAMES = {
    "void noise_blend_f32_kernel<false>(float const*, float*, int)":
        "port_kernel",
    "warp_fused_kernel(unsigned char const*, float*)": "port_kernel",
    "void warp_rows_kernel<3>(float const*)": "port_kernel",
    "warp_cols_kernel": "port_kernel",
    "void normalise_noise_blend_u8_kernel<3, true>(...)": "port_kernel",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
        "convolution",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32": "convolution",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>": "convolution",
    "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x64>": "matmul",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, 512>": "batch_norm",
    "void at::native::batch_norm_collect_statistics_kernel<float>":
        "batch_norm",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>>": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>":
        "reduce",
    "Memcpy HtoD (Pinned -> Device)": "memcpy",
    "Memset (Device)": "memset",
    "aten::cudnn_convolution": "convolution",
    "aten::convolution_backward": "convolution",
    "aten::addmm": "matmul",
    "aten::native_batch_norm": "batch_norm",
    "aten::add_": "elementwise",
    "aten::mean": "reduce",
    "aten::copy_": "copy",
    "void at::native::(anonymous namespace)::upsample_nearest2d_nhwc_out_"
    "frame<c10::BFloat16>": "upsample",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(at::TensorIteratorBase&)>": "copy",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>":
        "copy",
    "void at::native::multi_tensor_apply_kernel<FusedAdamMathFunctor>":
        "optimizer",
    "aten::upsample_nearest2d_backward": "upsample",
    "aten::_fused_adam_": "optimizer",
    "aten::cat": "copy",
    "aten::grid_sampler_2d": "other",
}


@pytest.mark.parametrize("name", HLO_NAMES)
def test_categorize_hlo_names_as_jax(name):
    assert profiling.categorize(name) == jax_profiling.categorize(name)


@pytest.mark.parametrize("name,want", list(DEVICE_NAMES.items()))
def test_categorize_cuda_and_aten_names(name, want):
    assert profiling.categorize(name) == want


# ------------------------------------------------------ a hand-made trace

CONV = "sm90_xmma_fprop_implicit_gemm_bf16"
NOISE = "void noise_blend_f32_kernel<false>(float const*)"
WARP = "warp_fused_kernel(unsigned char const*)"
COPY = "Memcpy HtoD (Pinned -> Device)"


def _kernel(name, ts, dur, corr, device=0, stream=7, cat="kernel"):
    args = {"device": device, "stream": stream, "correlation": corr}
    if cat == "gpu_memcpy":
        args["bytes"] = 16 * 448 * 448 * 3
    return {"ph": "X", "cat": cat, "name": name, "pid": device,
            "tid": stream, "ts": ts, "dur": dur, "args": args}


def _host(name, ts, dur, cat="cpu_op", tid=11, corr=None, dims=None):
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if dims is not None:
        args["Input Dims"] = dims
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _write_trace(path, steps=True):
    """Two steps on cuda:0 (in microseconds): step 1 runs a conv 0-1000
    and the warp 500-700 on another stream (overlap), a copy 1000-1100,
    the noise kernel 1500-1600; step 2 the same 10000 later; one kernel
    on cuda:1; every device event launched by a runtime call inside an
    aten op or the warp's annotation."""
    events = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "python"}}]
    corr = 0
    for step, base in enumerate((0, 10_000)):
        if steps:
            events.append(_host(f"ProfilerStep#{step}", base - 50, 1_900,
                                cat="user_annotation"))
        for name, ts, dur, stream, op, dims in (
                (CONV, 0, 1_000, 7, "aten::cudnn_convolution",
                 [[16, 64, 112, 112], [64, 64, 3, 3]]),
                (WARP, 500, 200, 9, "warp_fused", None),
                (COPY, 1_000, 100, 7, "aten::copy_", [[16, 448, 448, 3]]),
                (NOISE, 1_500, 100, 7, "fused_noise_blend", None)):
            corr += 1
            cat = {"Memcpy": "gpu_memcpy"}.get(name.split()[0], "kernel")
            events.append(_kernel(name, base + ts, dur, corr, stream=stream,
                                  cat=cat))
            launch = base + ts - 40
            events.append(_host(op, launch - 5, 30,
                                cat="user_annotation" if dims is None
                                else "cpu_op", dims=dims))
            events.append(_host("cudaLaunchKernel", launch, 5,
                                cat="cuda_runtime", corr=corr))
    corr += 1
    events.append(_kernel(CONV, 3_000, 400, corr, device=1, stream=3))
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_analyze_trace_accounting(tmp_path):
    report = profiling.analyze_trace(_write_trace(tmp_path / "t.json"),
                                     nsteps=1)
    assert report["planes"] == ["cuda:0", "cuda:1"]
    dev = report["cuda:0"]
    # Busy: the union of 0-1100 and 1500-1600 in each step: 2 x 1.2 ms.
    assert dev["ops_busy_ms_per_step"] == pytest.approx(2.4)
    # Wall: each step window's first to last device event, 0-1600 us.
    assert dev["module_wall_ms_per_step"] == pytest.approx(3.2)
    assert dev["in_module_gap_ms_per_step"] == pytest.approx(0.8)
    # Categories sum durations (the warp's overlap counts in both).
    assert dev["category_ms_per_step"] == pytest.approx(
        {"convolution": 2.0, "port_kernel": 0.6, "memcpy": 0.2})
    assert dev["top_ops_ms_per_step"][CONV] == pytest.approx(2.0)
    assert dev["lines_ms_per_step"] == pytest.approx(
        {"stream 7": 2.4, "stream 9": 0.4})
    assert dev["n_distinct_ops"] == 4
    assert list(dev["top_ops_per_category"]) == ["convolution", "port_kernel",
                                                 "memcpy"]
    assert dev["top_ops_per_category"]["port_kernel"] == pytest.approx(
        {WARP: 0.4, NOISE: 0.2})
    assert dev["port_kernels"] == {
        "warp_fused_kernel": {"ms_per_step": pytest.approx(0.4),
                              "launches": 2},
        "noise_blend_f32_kernel": {"ms_per_step": pytest.approx(0.2),
                                   "launches": 2}}
    assert dev["memcpy"] == {"HtoD": {"count": 2, "bytes": 2 * 16 * 448 * 448
                                      * 3, "ms_per_step": pytest.approx(0.2)}}
    assert report["events_by_category"]["kernel"] == 7
    assert report["cuda:1"]["ops_busy_ms_per_step"] == pytest.approx(0.4)
    assert dev["layout_conversions"] == {"per_step": 0.0, "ms_per_step": 0.0}


def test_analyze_trace_counts_layout_conversions(tmp_path):
    """cuDNN's NCHW <-> NHWC kernels (a convolution fed another layout
    than it runs in) are counted and timed a step."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _kernel("void cudnn::engines_precompiled::nchwToNhwcKernel<float>",
                0, 30, 1),
        _kernel("void cudnn::engines_precompiled::nhwcToNchwKernel<float>",
                100, 20, 2),
        _kernel(CONV, 200, 400, 3)]}))
    dev = profiling.analyze_trace(path, nsteps=2)["cuda:0"]
    assert dev["layout_conversions"] == {
        "per_step": 1.0, "ms_per_step": pytest.approx(0.025)}


def test_analyze_trace_divides_by_nsteps_and_spans_unannotated(tmp_path):
    report = profiling.analyze_trace(
        _write_trace(tmp_path / "t.json", steps=False), nsteps=2)
    dev = report["cuda:0"]
    assert dev["ops_busy_ms_per_step"] == pytest.approx(1.2)
    # No step windows: the whole span, 0 to 11600 us, over 2 steps.
    assert dev["module_wall_ms_per_step"] == pytest.approx(5.8)
    assert dev["port_kernels"]["warp_fused_kernel"]["launches"] == 2


def test_kernel_origins_follow_the_correlation_ids(tmp_path):
    path = _write_trace(tmp_path / "t.json")
    origins = profiling.kernel_origins(path, ["fprop_implicit_gemm",
                                              "noise_blend_f32_kernel",
                                              "no_such_kernel"])
    # cuda:1's conv has no launch in the trace.
    assert origins["fprop_implicit_gemm"] == [
        {"op": "aten::cudnn_convolution",
         "input_dims": [[16, 64, 112, 112], [64, 64, 3, 3]], "count": 2},
        {"op": None, "input_dims": None, "count": 1}]
    assert origins["noise_blend_f32_kernel"] == [
        {"op": "fused_noise_blend", "input_dims": None, "count": 2}]
    assert origins["no_such_kernel"] == []


def test_trace_of_cpu_ops_is_found_by_analyze_trace_dir(tmp_path):
    assert profiling.analyze_trace_dir(tmp_path / "none") is None
    with profiling.trace(tmp_path / "tr", device="cpu"):
        with profiling.annotate("matmul"):
            x = torch.ones((8, 8))
            (x @ x).relu()
    files = list((tmp_path / "tr").glob(f"*{profiling.TRACE_SUFFIX}"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"matmul", "aten::matmul"} <= names
    # A CPU trace has no device plane.
    report = profiling.analyze_trace_dir(tmp_path / "tr")
    assert report["planes"] == [] and report["events_by_category"]["cpu_op"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.trace(tmp_path / "tr2"):  # the card by default
                pass


def test_step_timer_discards_warmup():
    clock = iter([0.0, 1.0, 3.0, 6.0, 10.0])
    timer = profiling.StepTimer(warmup=2)
    real = time.perf_counter
    time.perf_counter = lambda: next(clock)
    try:
        for _ in range(5):
            timer.tick()
    finally:
        time.perf_counter = real
    # Intervals 1, 2, 3, 4; the first two are warm-up.
    assert timer.mean_step_seconds == pytest.approx(3.5)
    assert timer.throughput(7) == pytest.approx(2.0)
    assert profiling.StepTimer().throughput(7) == 0.0


def test_timed_loop_and_fn_on_the_cpu():
    calls = []

    def step(state):
        calls.append(1)
        return {"x": state["x"] + 1}

    dt, state = timing.timed_loop(step, {"x": torch.zeros(3)}, steps=4,
                                  warmup=2, device="cpu")
    assert dt >= 0 and len(calls) == 6
    assert timing.value_barrier(state) == 6.0
    assert timing.value_barrier({"n": 3}) == 0.0
    assert timing.timed_fn(torch.add, torch.ones(2), torch.ones(2),
                           steps=3, warmup=1, device="cpu") >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            timing.timed_fn(torch.add, torch.ones(1), torch.ones(1))


# ------------------------------------------------------------- stragglers


def test_drain_joins_finishing_thread():
    release = threading.Event()
    t = threading.Thread(target=release.wait, daemon=True)
    t.start()
    stragglers.adopt(t)
    release.set()
    assert stragglers.drain(budget_s=5.0) is True
    assert not t.is_alive()


def test_drain_gives_up_on_stuck_thread(capsys):
    release = threading.Event()
    t = threading.Thread(target=release.wait, daemon=True, name="stuck-xfer")
    t.start()
    stragglers.adopt(t)
    assert stragglers.drain(budget_s=0.05) is False
    assert "stuck-xfer" in capsys.readouterr().err
    release.set()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_drain_budget_is_shared_across_threads():
    release = threading.Event()
    threads = [threading.Thread(target=release.wait, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
        stragglers.adopt(t)
    t0 = time.monotonic()
    assert stragglers.drain(budget_s=0.1) is False
    assert time.monotonic() - t0 < 2.0
    release.set()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive()


def _short_joins(monkeypatch):
    orig_join = threading.Thread.join
    monkeypatch.setattr(threading.Thread, "join",
                        lambda self, timeout=None: orig_join(self, 0.01))


def test_abort_adopts_stuck_metric_worker(tmp_path, monkeypatch):
    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt")), validate=False)
    ctx = LoopContext(cfg, {"k": 1}, workload="denoiser")
    release = threading.Event()
    fake = threading.Thread(target=release.wait, daemon=True)
    fake.start()
    real_worker = ctx._metric_thread
    ctx._metric_thread = fake
    adopted = []
    monkeypatch.setattr(stragglers, "adopt", adopted.append)
    _short_joins(monkeypatch)
    try:
        ctx.abort()
    finally:
        monkeypatch.undo()
    assert adopted == [fake]
    release.set()
    fake.join(timeout=5.0)
    # The real worker saw abort()'s stop event; the tb file is closed.
    real_worker.join(timeout=5.0)
    assert not fake.is_alive() and not real_worker.is_alive()


@pytest.mark.parametrize("consumer", ["loader", "device_prefetch"])
def test_prefetch_adopts_stuck_worker(monkeypatch, consumer):
    adopted = []
    monkeypatch.setattr(stragglers, "adopt", adopted.append)
    release = threading.Event()

    def slow_batches():
        yield (torch.zeros((1, 4, 4, 3), dtype=torch.uint8),)
        release.wait()  # a decode or an upload stuck
        yield (torch.zeros((1, 4, 4, 3), dtype=torch.uint8),)

    if consumer == "loader":
        def produce(put):
            for item in slow_batches():
                put(item)

        gen = port_loader._threaded(produce, depth=1)
    else:
        gen = port_loader.device_prefetch(slow_batches(), "cpu", depth=1)
    next(gen)
    _short_joins(monkeypatch)
    gen.close()
    monkeypatch.undo()
    assert len(adopted) == 1
    release.set()
    adopted[0].join(timeout=5.0)
    assert not adopted[0].is_alive()


# -------------------------------------------------------------- the CLI


def test_profile_options_carry_the_jax_names():
    command = jax_cli.commands["profile"]
    jax_options = {s for p in command.params if isinstance(p, click.Option)
                   for s in p.opts}
    args = build_parser().parse_args(["profile", "--config", "c.yml",
                                      "--input_list", "i.txt"])
    assert (args.steps, args.trace_dir, args.report, args.device) == (
        20, "profile_trace", False, "cuda")
    port = _port_options(("profile",))
    assert jax_options <= port and "--device" in port
    with pytest.raises(SystemExit) as exit_:
        main(["profile", "--help"])
    assert exit_.value.code == 0


def test_profile_command_on_the_cpu(tmp_path, capsys):
    manifest = make_image_dataset(tmp_path / "data", n=4, size=32)
    cfg = tmp_path / "denoiser.yml"
    cfg.write_text(yaml.safe_dump(dict(
        batch_size=2, encoder_name="resnet18", compute_dtype="float32",
        image_size=32, log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt"), remat="dots",
        color_jitter=[0.2, 0.2, 0.2, 0.05])))
    trace_dir = tmp_path / "trace"
    main(["profile", "--config", str(cfg), "--input_list", str(manifest),
          "--steps", "2", "--trace_dir", str(trace_dir), "--report",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"trace written to {trace_dir}" in out
    report = json.loads(out[out.index("{"):])
    events = json.loads(next(trace_dir.glob("*.json")).read_text())[
        "traceEvents"]
    assert report["planes"] == []  # the CPU run has no device plane
    assert report["events_by_category"]["cpu_op"] > 100
    # One ProfilerStep# window a train step, and one after the last.
    windows = [e["name"] for e in events
               if e.get("name", "").startswith("ProfilerStep#")]
    assert windows == [f"ProfilerStep#{i}" for i in range(3)]
    assert any(e.get("name") == "aten::convolution" for e in events)
