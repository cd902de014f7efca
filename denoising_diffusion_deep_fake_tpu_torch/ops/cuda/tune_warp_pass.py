"""Sweep the pass kernels' tiling on one GPU.

    python -m denoising_diffusion_deep_fake_tpu_torch.ops.cuda.tune_warp_pass \\
        [--out DIR] [--segs N,N,...] \\
        [ROW_P:ROW_WARPS:COL_S:COL_P:COL_THREADS ...]

Each variant is ``csrc/warp.cu`` with five compile-time constants of
``warp_rows_kernel`` and ``warp_cols_kernel`` replaced: ROW_P (consecutive
outputs a row-kernel thread computes), ROW_WARPS (lines a row-kernel block,
one a warp), COL_S (lines a column-kernel block stages), COL_P (consecutive
outputs a column-kernel thread computes) and COL_THREADS (threads a
column-kernel block). Every variant keeps 64 registers a thread at most
(``__launch_bounds__``' second argument). All variants are built at once.
Then, on the two shapes of the two-pass route's passes, 448^2 x 16 and
640^2 x 4 fp32 with C = 3 and ``random_affine`` params, each variant's row
kernel runs the x-pass layout (NHWC source, planar destination) and its
column kernel the y-pass layout (planar source, NHWC destination), the
latter for each most segment length of ``--segs`` (0: the whole line;
the line is cut as ``warp_kernel.column_segment`` cuts it). Each
configuration is first checked bit-equal to ``warp_axis_pass_plain``, then
timed three times (``bench_warp_pass.graph_ms``: CUDA-graph replays of 20
launches). It prints ptxas's registers and spills per variant, the card's
name and power limit, and one line per configuration.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_kernel as wk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass import (
    graph_ms,
    route_cases,
)

DEFAULT = ["2:8:16:2:256"]
NAMES = ("ROW_P", "ROW_WARPS", "COL_S", "COL_P", "COL_THREADS")


def variant_source(text: str, values: list[int]) -> str:
    for name, value in zip(NAMES, values):
        const = f"constexpr int {name} = "
        start = text.find(const)
        if start < 0:
            raise RuntimeError(f"csrc/warp.cu no longer has {const!r}")
        end = text.index(";", start)
        text = text[:start] + f"{const}{value}" + text[end:]
    return text


def build_all(names: list[str], out: Path) -> dict[str, Path]:
    text = (_build._CSRC / "warp.cu").read_text()
    built = _build.build_variants(
        {f"pass_{name}": variant_source(text, [int(v) for v in
                                               name.split(":")])
         for name in names}, out)
    libs = {}
    for name in names:
        if f"pass_{name}" in built:
            lib, report = built[f"pass_{name}"]
            for tag in ("warp_rows_kernelILi3", "warp_cols_kernelILi3"):
                print(f"{name} {tag[:16]}: "
                      + _build.ptxas_summary(report, tag))
            libs[name] = lib
    return libs


def sweep(libs: dict[str, Path], segs: list[int]) -> None:
    dev = torch.device("cuda")
    cases = [(shape["key"], case) for shape in route_cases(dev)
             for case in shape["passes"]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).d3f_warp_pass
        i64x4 = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4,
                       i64x4, i64x4, *[ctypes.c_void_p] * 3,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    for name, fn in fns.items():
        for key, case in cases:
            src, dst = case["src"], case["dst"]
            b, l, c, n = src.shape
            strides = [(ctypes.c_longlong * 4)(*t.stride())
                       for t in (src, dst)]
            alpha, base, resid = case["scalars"]
            kernel = int(case["what"] == "y-pass")  # the one its layout picks
            for seg in (segs if kernel else [0]):

                def launch():
                    err = fn(src.data_ptr(), dst.data_ptr(), b, l, c, n,
                             strides[0], strides[1], alpha.data_ptr(),
                             base.data_ptr(), resid.data_ptr(), kernel,
                             wk.column_segment(n, seg or n),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                dst.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                equal = torch.equal(dst, case["want"])
                times = [graph_ms(launch) for _ in range(3)]
                print(f"{':'.join(NAMES)} {name} {case['what']} {key} seg "
                      f"{wk.column_segment(n, seg or n)}: "
                      f"{' '.join(f'{t:.4f}' for t in times)} "
                      f"ms, bit-equal {equal}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", default=DEFAULT)
    parser.add_argument("--out", type=Path, default=None,
                        help="build directory (default: a temporary one)")
    parser.add_argument("--segs", default=f"0,{wk.COL_SEG}",
                        help="column-kernel segment lengths, comma-separated "
                        "(0: the whole line)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_all(args.variants, out)
        sweep(libs, [int(v) for v in args.segs.split(",")])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
