"""What every cell shares: finding its files, the run's record, the checks.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds, by those names alone:

* ``configs/<config>.json``: the model and its hyperparameters as run;
* ``traffic/<traffic>.json``: the mix; its ``driver`` names the general
  generator that reads it, ``drivers/<driver>.py``;
* ``workloads/<cell>.json``: the cell's correctness limits;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``
  returning a number or None (nothing to read: the metric is left out).

So a later cell, configuration or metric is added by adding files and
entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
# Compared whole against each loaded module's top-level name: the port's
# own name begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "denoising_diffusion_deep_fake_tpu"})


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to its own ``_build/``); no
    library may load JAX behind the port."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> list[str]:
    """The top-level names of loaded modules that the port's run may not
    hold, compared whole."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & FORBIDDEN)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH

    def metric_reader(self, name: str):
        return _load(f"bench_metric_{name}",
                     self.bench_dir / "metrics" / f"{name}.py").read

    def driver(self):
        name = self.traffic["driver"]
        return _load(f"bench_driver_{name}",
                     self.bench_dir / "drivers" / f"{name}.py")


def _load(name: str, path: Path):
    """The module at ``path``, loaded once under ``name``."""
    name = name.replace(".", "_").replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, *, root: Path = ROOT, bench_dir: Path = BENCH
              ) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _covers(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _covers(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(bench_dir / "configs" / f"{w['config']}.json"),
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench_dir / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (a reading
    above the limit fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks_from(readings: dict, limits: dict) -> list[Check]:
    """The readings that the cell's ``limits`` hold, in the limits'
    order; a reading the run could not make fails."""
    return [Check(n, float(readings.get(n, float("nan"))), float(lim))
            for n, lim in limits.items()]


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """For each leaf kept, the gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = [n for n in ref if n in keep]
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def leaf_diffs(prog: dict, ref: dict, keep) -> dict:
    """For each leaf kept, the norm of the difference between the program's
    tensor and the reference's, over the reference's norm of that leaf or
    of the median leaf, whichever is larger: unlike a gap of norms, it
    sees a tensor pointing elsewhere."""
    names = [n for n in ref if n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return {n: float((prog[n].double() - ref[n].double()).norm())
            / max(rn[n], med, 1e-30) for n in names}


def moving_leaves(grad1: dict) -> set:
    """Leaves whose first reference gradient is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in grad1.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v >= 1e-3 * med}
