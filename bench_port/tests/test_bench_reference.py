"""The reference against the port at 64^2 on the CPU, fp32 on both sides:
the same draws, warp, noise, forward, loss and Adam give the first step's
loss to the last bit and the rest to rounding."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import cpu_cells  # noqa: E402


def test_training_reference_meets_the_port():
    r = cpu_cells.run_small("train_r34_448_cached_k16", calibrate=True)
    got = r["readings"]
    assert got["loss_gap_step1"] < 1e-6
    assert got["loss_gap_rms"] < 1e-5
    assert got["loss_gap_group_max"] < 1e-4
    assert got["change_gap_median"] < 1e-3
    assert got["change_gap"] < 0.01
    assert got["change_diff_median"] < 0.01
    assert got["adam_v_gap_median"] < 1e-3
    assert r["correct"] and r["failed"] == 0
    cal = r["calibration"]
    # The control and the planted faults read far above the sound run.
    for fault in ("control_fp8", "half_batch"):
        assert cal[fault]["loss_gap_rms"] > 100 * max(got["loss_gap_rms"],
                                                      1e-7)
    for fault in ("control_fp8", "half_batch", "mse_only"):
        assert cal[fault]["adam_v_gap_median"] > 10 * got["adam_v_gap_median"]
    # TF32 does not exist on the CPU: that witness is the reference itself.
    assert cal["witness_tf32"]["change_diff_all"] == 0.0
    # The bf16 witness parts from fp32 by rounding alone, first update on.
    assert cal["first_update_bf16"]["sign_flip_share"] > 0.0
    assert cal["witness_bf16"]["loss_gap_step1"] > 0.0

