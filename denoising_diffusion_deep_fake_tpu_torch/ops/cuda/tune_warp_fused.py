"""Sweep the fused warp kernel's tiling on one GPU.

    python -m denoising_diffusion_deep_fake_tpu_torch.ops.cuda.tune_warp_fused \
        [--out DIR] [--reps N] [S:FUSED_THREADS:MIN_BLOCKS:P ...]

Each variant is ``csrc/warp.cu`` with four compile-time constants of
``warp_fused_kernel`` replaced: S (output columns a block owns),
FUSED_THREADS (threads a block), MIN_BLOCKS (the second
``__launch_bounds__`` argument, which caps registers) and P (consecutive
outputs a thread computes). All variants are built at once,
then each is checked bit-equal to ``affine_warp_fused_plain`` and timed
(CUDA events over 200 launches into a preallocated output) on the main
path's call: 448^2 x 16 uint8 -> fp32, ``random_affine`` params, mean and
std 0.5. It prints ptxas's registers and spills per variant, the card's
name and power limit, and one line per variant and repetition.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_fused as wf
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_kernel as wk

DEFAULT = ["32:512:1:2", "16:256:2:2"]
CONSTANTS = ("constexpr int S = 32;", "constexpr int FUSED_THREADS = 512;",
             "__launch_bounds__(FUSED_THREADS, 1)", "constexpr int P = 2;")


def variant_source(text: str, s: int, threads: int, min_blocks: int,
                   p: int) -> str:
    for const in CONSTANTS:
        if const not in text:
            raise RuntimeError(f"csrc/warp.cu no longer has {const!r}")
    return (text.replace(CONSTANTS[0], f"constexpr int S = {s};")
            .replace(CONSTANTS[1], f"constexpr int FUSED_THREADS = {threads};")
            .replace(CONSTANTS[2],
                     f"__launch_bounds__(FUSED_THREADS, {min_blocks})")
            .replace(CONSTANTS[3], f"constexpr int P = {p};"))


def build_all(names: list[str], out: Path) -> dict[str, Path]:
    text = (_build._CSRC / "warp.cu").read_text()
    procs = {}
    for name in names:
        src = out / f"warp_{name.replace(':', '_')}.cu"
        src.write_text(variant_source(text, *map(int, name.split(":"))))
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[1]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{report}")
            continue
        # The uint8, 3-channel instantiation is the one the main path runs.
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "warp_fused_kernelIhLi3" in line:
                print(f"{name}: " + " ".join(
                    x.strip() for x in lines[i + 1:i + 3]))
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", default=DEFAULT)
    parser.add_argument("--out", type=Path, default=None,
                        help="build directory (default: a temporary one)")
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        libs = build_all(args.variants, out)
        sweep(libs, args.reps)
    return 0


def sweep(libs: dict[str, Path], reps: int) -> None:
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, _inverse_affine_coeffs, sample_affine_params)

    dev = torch.device("cuda")
    b, h, w, c = 16, 448, 448, 3
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (b, h, w, c), np.uint8)).to(dev)
    params = sample_affine_params(
        b, AffineAugmentConfig.random_affine(),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    coeffs = _inverse_affine_coeffs(params, h, w)
    norm = wf.norm_constants(0.5, 0.5, c)
    ax, sx, ay, sy = wk.shear_factors(coeffs, h, w)
    scalars = (ax.contiguous(), *wk.pass_scalars(ax, sx, w),
               ay.contiguous(), *wk.pass_scalars(ay, sy, h))
    want = wf.affine_warp_fused_plain(u8, coeffs, norm)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    c_norm = (ctypes.c_float * len(norm))(*norm)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).d3f_warp_fused
        fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 2,
                       *[ctypes.c_int] * 4, *[ctypes.c_void_p] * 6,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def launch(fn):
        err = fn(1, u8.data_ptr(), out.data_ptr(), b, h, w, c,
                 *(t.data_ptr() for t in scalars), c_norm,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for rep in range(reps):
        for name, fn in fns.items():
            out.zero_()
            launch(fn)
            torch.cuda.synchronize()
            equal = torch.equal(out, want)
            for _ in range(5):
                launch(fn)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                launch(fn)
            end.record()
            torch.cuda.synchronize()
            print(f"rep {rep} S:FUSED_THREADS:MIN_BLOCKS:P {name}: "
                  f"{start.elapsed_time(end) / 200:.4f} ms, bit-equal {equal}")


if __name__ == "__main__":
    raise SystemExit(main())
