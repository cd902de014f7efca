"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers. They are built at first use, never at
import (the CPU machine that runs the tests has no ``nvcc``), into
``denoising_diffusion_deep_fake_tpu_torch/_build/`` (listed in .gitignore),
under a name that carries a hash of the sources and flags, so an edited
source is rebuilt.

``-fmad=false`` keeps nvcc from contracting ``a * b + c`` into an FMA: the
warp kernels must round where the TPU kernels do (see csrc/warp.cu), and
the noise kernels where their plain PyTorch versions do (csrc/noise.cu).
There is no ``--use_fast_math``: the uint8 normalise is a true division,
and ``logf``, ``sinf`` and ``cosf`` are the accurate ones.

``LAUNCHES`` counts, per kernel wrapper, the launches made on the GPU.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use on a machine with the CUDA toolkit")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless built already; returns the library
    path and the compiler's report (empty when it was built before)."""
    source = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path, _ = build(name)
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def build_variants(sources: dict[str, str], out: Path
                   ) -> dict[str, tuple[Path, str]]:
    """Compile variant sources (name -> CUDA text) into ``out``, all nvcc
    processes at once; returns name -> (library, compiler report) for those
    that built, and prints the report of those that did not."""
    procs = {}
    for name, text in sources.items():
        src = out / f"{name.replace(':', '_')}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[1]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{report}")
        else:
            built[name] = (lib, report)
    return built


def ptxas_summary(report: str, kernel_tag: str) -> str:
    """ptxas's registers and spill lines for the kernels whose mangled
    name contains ``kernel_tag``."""
    lines = report.splitlines()
    return " | ".join(" ".join(x.strip() for x in lines[i + 1:i + 3])
                      for i, line in enumerate(lines) if kernel_tag in line)
