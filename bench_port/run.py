"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the PyTorch package ``denoising_diffusion_deep_fake_tpu_torch``. It runs on
the card of the machine it starts on, and exits non-zero with no result
where there is none (or fewer than the cell asks for), where the package
is missing, or where JAX or the JAX package was loaded.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import core  # noqa: E402

core.set_cache_env()

import torch  # noqa: E402


def per_layer(cell: core.Cell, ctx: dict) -> dict:
    out = {}
    for metric in cell.per_layer:
        value = cell.metric_reader(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             overrides: dict | None = None, calibrate: bool = False,
             cell: core.Cell | None = None) -> dict:
    """The result of one run of cell ``name`` on ``device`` (the tests run
    it on the CPU at a small size through ``overrides``)."""
    cell = cell or core.load_cell(name)
    res = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device, t_start=t_start,
                            overrides=overrides, calibrate=calibrate)
    checks = core.checks_from(res["readings"], cell.limits["limits"])
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    result = {
        "correct": all(c.ok for c in checks) and res["failed"] == 0,
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": {},
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": res["memory_peak"]},
    }
    if trace:
        analysis = res["ctx"]["trace"]
        result["metrics"] = per_layer(cell, res["ctx"])
        if analysis is not None:
            result["device"]["busy_s"] = analysis["busy_s"]
            result["device"]["window_s"] = analysis["window_s"]
            result["breakdown"] = {"device_ops": analysis["top_ops"],
                                   "idle_gaps": analysis["idle_gaps"]}
    else:
        e2e = dict(res["e2e"], setup_s=res["setup_s"])
        result["metrics"] = {n: {"value": e2e[n], "unit": units[n]}
                             for n in units}
    result["readings"] = {k: v for k, v in res["readings"].items()
                          if isinstance(v, (int, float))}
    if calibrate:
        result["readings"] = res["readings"]
        result["calibration"] = res["calibration"]
    result["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit}
                        for c in checks}
    return result


def _finite(value: float):
    """A reading as JSON takes it: a number, or None where the run could
    not make it."""
    return value if value == value and abs(value) != float("inf") else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device,
                      t_start=T_START, cell=cell)
    found = core.forbidden_loaded()
    if found:
        print(f"loaded in the measured process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if args.trace and "busy_s" not in result["device"]:
        print("the trace holds no device work in its traced window",
              file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        ok = check["value"] is not None and check["value"] <= check["limit"]
        print(f"check {name} {check['value']!r} limit {check['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
