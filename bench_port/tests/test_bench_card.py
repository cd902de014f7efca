"""On the card, at each cell's own size: a sound run passes its limits, the
control (the reference in fp8) fails at least one, and so does the
planted fault. Skips without a card; the test decides that itself."""

import time

import pytest
import torch

from bench_port import core, run

SEED = 2 ** 31 + 4242
FAULTS = {"train_cached": ("half_batch",)}


def _cells():
    import json
    return [w["name"] for w in json.loads(
        (core.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells())
def test_cell_sound_control_and_fault_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = core.load_cell(name)
    device = torch.device("cuda", 0)
    r = run.run_cell(name, seed=SEED, seconds=2.0, trace=False,
                     device=device, t_start=time.perf_counter(),
                     calibrate=True, cell=cell)
    limits = cell.limits["limits"]
    assert r["correct"], r["checks"]
    for reading in ("control_fp8", *FAULTS[cell.traffic["driver"]]):
        checks = core.checks_from(r["calibration"][reading], limits)
        assert not all(c.ok for c in checks), (reading, checks)
