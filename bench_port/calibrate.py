"""Readings the correctness limits are set from, on the card, one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 0] [--out FILE]

For each seed it runs the cell as ``run.py`` does (a window of
``--seconds``, none by default: a training cell's check needs none) and
prints one JSON line: the program's readings against the fp32 reference,
and the same numbers of the control (the reference in fp8), of the
planted faults (the loss over half the batch; the SSIM term's gradient
dropped) and of the witnesses of rounding alone (the reference under
bf16 autocast, and with TF32) against it. The benchmark's own runs never
run them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import core  # noqa: E402

core.set_cache_env()

import torch  # noqa: E402

from bench_port import run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = core.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        result = run.run_cell(args.workload, seed=seed, seconds=args.seconds,
                              trace=False, device=device, t_start=t,
                              calibrate=True, cell=cell)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds_taken": time.perf_counter() - t,
                           **result})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
