"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the program; names compared whole by their top
level, since the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from bench_port import core

PORT = "denoising_diffusion_deep_fake_tpu_torch"


def _loaded_after(code: str) -> dict:
    prelude = (f"import sys, json; sys.path.insert(0, {str(core.ROOT)!r}); ")
    out = subprocess.run(
        [sys.executable, "-c", prelude + code + "; print(json.dumps("
         "sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole():
    assert core.forbidden_loaded([PORT, f"{PORT}.ops", "numpy"]) == []
    assert core.forbidden_loaded(["jax.numpy", "optax"]) == ["jax", "optax"]
    assert core.forbidden_loaded(["denoising_diffusion_deep_fake_tpu.ops"]) \
        == ["denoising_diffusion_deep_fake_tpu"]


def test_reference_loads_nothing_of_the_program():
    names = _loaded_after(
        "import bench_port.reference.unet, bench_port.reference.train, "
        "bench_port.reference.kernels, "
        "bench_port.reference.lowp, bench_port.inputs, bench_port.flops")
    assert PORT not in names
    assert not names & core.FORBIDDEN


def test_a_whole_run_loads_no_jax():
    names = _loaded_after(
        f"sys.path.insert(0, {str(core.BENCH / 'tests')!r}); import cpu_cells; "
        "r = cpu_cells.run_small('train_r34_448_cached_k16'); "
        "assert r['correct']; "
        "import bench_port.calibrate")
    assert PORT in names
    assert not names & core.FORBIDDEN
