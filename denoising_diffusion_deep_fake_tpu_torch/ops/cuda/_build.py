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
and ``logf`` and ``sincosf`` are the accurate ones.

``build_host`` compiles host C++ (the native image loader under
``data/csrc/``) with ``g++`` the same way, with link flags (``-ljpeg``)
that join the hash. Two processes may build one library at
once: each writes a temporary name and renames it into place. The hash
covers sources and flags, not the machine: ``missing_headers`` asks g++
whether this machine has a library's headers before it is built or
loaded.

``LAUNCHES`` counts, per kernel wrapper, the launches made on the GPU. A
wrapper adds to it in Python when it launches, which under CUDA-graph
capture (``training/multi_step.py``) is once at capture and never at the
replays that run the kernels: ``moved_launches`` takes what a capture
counts out of ``LAUNCHES`` into the graph's own count, which every replay
adds back. A capture's warm-up on a throwaway copy of the
state is set-up, as a comparison with a plain version is: its launches are
dropped the same way.
"""

from __future__ import annotations

import collections
import contextlib
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
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@contextlib.contextmanager
def moved_launches(into: collections.Counter | None = None):
    """Counts made inside go to ``into`` (dropped when None), not to
    ``LAUNCHES``."""
    before = LAUNCHES.copy()
    try:
        yield
    finally:
        made = LAUNCHES - before
        LAUNCHES.clear()
        LAUNCHES.update(before)
        if into is not None:
            into.update(made)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use on a machine with the CUDA toolkit")


def _compile(command: list[str], sources: list[Path], name: str,
             flags: tuple[str, ...]) -> tuple[Path, str]:
    """Run ``command + flags`` on ``sources`` into ``_build/`` unless a
    library of the same sources (and the headers beside them) and flags is
    there; returns its path and the compiler's report."""
    texts = b"".join(p.read_bytes() for p in sources)
    for d in sorted({p.parent for p in sources}):
        texts += b"".join(h.read_bytes() for h in sorted(d.glob("*.h")))
    digest = hashlib.sha256(texts + " ".join(
        [*command[1:], *flags]).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), *map(str, sources),
                           *flags], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(command[0]).name} failed on "
                           f"{', '.join(p.name for p in sources)}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` with nvcc unless built already; returns
    the library path and the compiler's report (empty when it was built
    before)."""
    return _compile([_nvcc(), *NVCC_FLAGS], [_CSRC / f"{name}.cu"], name, ())


def build_host(name: str, sources: list[Path],
               link: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile host C++ ``sources`` into one shared library with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {name} is built on first use")
    return _compile([gxx, *GXX_FLAGS], list(sources), name, link)


def missing_headers(headers: tuple[str, ...]) -> list[str]:
    """Those of ``headers`` that g++'s preprocessor cannot include here
    (all of them without g++): a machine's own check, run before a build
    that needs them."""
    gxx = shutil.which("g++")
    if gxx is None:
        return list(headers)
    return [h for h in headers if subprocess.run(
        [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
        input=f"#include <cstdio>\n#include <{h}>\n", capture_output=True,
        text=True).returncode != 0]


def _load_once(name: str, make) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(make()[0]))
        return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return _load_once(name, lambda: build(name))


def load_host(name: str, sources: list[Path],
              link: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded g++ library ``name`` of ``sources``, built on first use."""
    return _load_once(name, lambda: build_host(name, sources, link))


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
