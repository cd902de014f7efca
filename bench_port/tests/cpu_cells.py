"""The cells at a size a CPU test run holds: 64^2, the fused warp's route
(the 448^2 path's; ``auto`` would take ``hybrid`` at 64^2), fp32 compute
so that the program meets the fp32 reference to rounding."""

import dataclasses
import time

import torch

from bench_port import core, run

SMALL = {"image_size": 64, "batch_size": 4, "encoder_name": "resnet18",
         "compute_dtype": "float32", "warp_method": "pallas_fused"}
TRAFFIC = {"train_cached": {"frames": 16, "steps_per_call": 2,
                            "traced_groups": 1, "follow_groups": 2}}



def run_small(name: str, *, seed: int = 2 ** 31 + 99, calibrate=False,
              trace=False, seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    cell = core.load_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, **TRAFFIC[cell.traffic["driver"]]))
    return run.run_cell(name, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"),
                        t_start=time.perf_counter(), overrides=SMALL,
                        calibrate=calibrate, cell=cell)
