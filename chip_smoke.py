"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py [--profile-out PATH]

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ops/cuda/csrc (nvcc, sm_90a), one nvcc per
   source, all started together;
3. each kernel against its plain PyTorch version at the shapes its path
   gives it, with the kernel's and the plain version's times and the least
   time the card could take: the warp kernels bit-equal (the fused warp,
   one launch, with both stat sets and at the corners of the augment's
   ranges, timed alone into a preallocated output; the axis pass's row and
   column kernels each on the x-pass and the y-pass layout at 448^2 x 16
   and 640^2 x 4, each pass timed alone, and the whole two-pass warp at
   640^2 x 4, at the range corners too; the fused warp at 640^2 x 4,
   recorded only); the noise kernels'
   Philox words bit-equal, their outputs within one ulp (share of differing
   elements stated), ratio 0 exactly the normalisation, and the noise's
   moments, bound, cross-sample correlation and determinism;
4. a small-input reference: one fp32 train step at 64^2 on the GPU against
   the same step on the CPU (plain versions), from the same weights and
   the same injected randomness;
5. the main path: the denoiser trainer at the width of
   configs/denoiser.yml (resnet34 U-Net, batch 16, bf16) at 448^2, whose
   auto warp route is the fused kernel and whose noise stage is the fp32
   noise kernel: 3 warm-up and 30 timed steps, then one eval-mode forward
   and a profile of 3 more steps;
6. the two-pass route: the same trainer at 640^2, batch 4 (auto routes
   sizes above 512^2 to the two-pass kernels), 2 warm-up and 10 timed
   steps, then a profile of 3 more;
7. the balancer: configs/balance.yml's width (resnet34, batch 12, bf16,
   lr 0.01, ratio 0.7, 10 classes) at 448^2: 3 warm-up and 20 timed train
   steps through the uint8 noise kernel, a profile of 3 more, then the
   scoring pass over 50 images (5 batches, the last padded from 2 to 12),
   difficulty classes, and the balanced manifest written and read back.

It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Every launch count is the count from the
path that runs the kernel, reset to 0 just before the path and read just
after it. Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
# int32 outside the tensor cores: 64 of an SM's 128 lanes a clock, so half
# the fp32 rate (the data sheet lists no int32 figure).
INT32_OPS_PER_S = 33.5e12
# fp32 operations one resample pass needs per output element: two residual
# taps (hat weight: 5 operations each, multiply-add: 2 each) and one
# band-matrix column (source position and its floor: 4; two taps of hat
# weight, bf16 rounding, product and sum: 8 each).
OPS_PER_PASS_ELEMENT = 34
# Operations of one noise-blend element, each counted once (a
# transcendental as one): int32, Philox4x32-10's 10 rounds of 2 low and 2
# high multiplies, 4 xors and 2 key adds per group of 4 (25) and the shift
# of the uniform (1); fp32, the uniform's convert, multiply and add (3),
# Box-Muller's log, two products, sqrt, cos and sin per pair (4 an element)
# and the blend's two products and sum (3), plus the uint8 kernel's
# subtract and divide (2).
NOISE_INT_OPS = 26
NOISE_FP_OPS = {"fused_normalise_noise_blend": 12, "fused_noise_blend": 10}
REPO = "denoising_diffusion_deep_fake_tpu"
CSRC = "denoising_diffusion_deep_fake_tpu_torch/ops/cuda/csrc"
KERNELS = {  # wrapper: (source, TPU kernel, device functions in a profile)
    "affine_warp_fused": ("warp.cu", "ops/pallas/warp_fused.py:140",
                          "warp_fused_kernel"),
    "warp_axis_pass": ("warp.cu", "ops/pallas/warp_kernel.py:126",
                       "warp_rows_kernel", "warp_cols_kernel"),
    "fused_normalise_noise_blend": ("noise.cu",
                                    "ops/pallas/noise_kernel.py:128",
                                    "normalise_noise_blend_u8_kernel"),
    "fused_noise_blend": ("noise.cu", "ops/pallas/noise_kernel.py:171",
                          "noise_blend_f32_kernel"),
}
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
HALF = ((0.5,) * 3, (0.5,) * 3)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, n_int_ops: float = 0.0
          ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / FP32_OPS_PER_S + n_int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Kernel vs plain version; the tolerance is 0 (bit equality)."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    max_err = float(diff.max())
    share = float((diff > 0).float().mean())
    log(f"  {what}: max|kernel - plain| {max_err:.3e}, differing share "
        f"{share:.3e}")
    check(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    check(max_err == 0.0, f"{what}: kernel disagrees with its plain version")
    return max_err


def compare_ulp(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Noise kernel vs plain version: within one ulp of the plain value
    (CUDA's logf/sinf/cosf against PyTorch's CUDA log/sin/cos)."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
        - want.abs()
    max_err = float(diff.max())
    share = float((diff > 0).float().mean())
    log(f"  {what}: max|kernel - plain| {max_err:.3e}, differing share "
        f"{share:.3e}, max in ulps {float((diff / ulp).max()):.2f}")
    check(torch.isfinite(got).all().item(), f"{what}: non-finite output")
    check(bool((diff <= ulp).all()), f"{what}: kernel more than one ulp "
          "from its plain version")
    return max_err


def noise_stats(eps: torch.Tensor, what: str) -> None:
    """Ratio-1 output = the noise itself: moments, bound, correlation."""
    mean, var = float(eps.mean()), float(eps.var())
    peak = float(eps.abs().max())
    corr = float(torch.corrcoef(eps[:2].reshape(2, -1))[0, 1])
    log(f"  {what} noise: mean {mean:.2e}, var - 1 {var - 1:.2e}, max|e| "
        f"{peak:.4f}, corr(sample 0, sample 1) {corr:.2e}")
    check(abs(mean) < 0.005 and abs(var - 1) < 0.005 and peak <= 5.9
          and abs(corr) < 0.01, f"{what}: noise statistics out of range")


def noise_checks(dev) -> dict:
    """Phase 3, noise kernels: uint8 448^2 x 12 (the balancer) and fp32
    448^2 x 16 (the denoiser's noise stage)."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.noise import blend_noise

    rng = np.random.default_rng(SEED + 3)
    results = {}
    seed, offset = 12345, 7

    # uint8: both mean/std pairs, per-sample ratios across [0, 1].
    b, h, w, c = 12, 448, 448, 3
    n = b * h * w * c
    u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, c),
                                       np.uint8)).to(dev)
    words = nk.philox_words((n + 3) // 4, seed=seed, offset=offset,
                            device=dev)
    check(torch.equal(words, nk.philox_words_plain(
        (n + 3) // 4, seed=seed, offset=offset, device=dev)),
        "Philox words differ from the plain version")
    log(f"  Philox words of {(n + 3) // 4} groups: bit-equal")
    ratios = torch.linspace(0, 1, b, device=dev)
    errs = []
    for mean, std in (HALF, IMAGENET):
        norm = nk.noise_constants(mean, std, c)
        got = nk.fused_normalise_noise_blend(u8, ratios, mean, std,
                                             seed=seed, offset=offset)
        want = nk.fused_normalise_noise_blend_plain(u8, ratios, norm,
                                                    seed=seed, offset=offset)
        errs.append(compare_ulp(got, want, f"u8 448^2 x12 mean={mean}"))
        zero = nk.fused_normalise_noise_blend(
            u8, torch.zeros(b, device=dev), mean, std, seed=seed)
        m255 = torch.tensor(norm[:c], device=dev)
        s255 = torch.tensor(norm[c:], device=dev)
        check(torch.equal(zero, (u8.float() - m255) / s255),
              "ratio 0 is not exactly the normalisation")
    ones = torch.ones(b, device=dev)
    eps = nk.fused_normalise_noise_blend(u8, ones, *HALF, seed=seed,
                                         offset=offset)
    noise_stats(eps, "u8 448^2 x12")
    check(torch.equal(eps, nk.fused_normalise_noise_blend(
        u8, ones, *HALF, seed=seed, offset=offset)), "not deterministic")
    other = nk.fused_normalise_noise_blend(u8, ones, *HALF, seed=seed,
                                           offset=offset + 1)
    check(float((other != eps).float().mean()) > 0.99,
          "another offset gives the same noise")
    # Timed with a preallocated output, so the host's launch rate stays
    # below the kernel's; the wrapper (allocation included) beside it.
    norm = nk.noise_constants(*HALF, c)
    out = torch.empty(u8.shape, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: nk.launch_blend(u8, out, ones, norm, seed=seed,
                                         offset=offset), 50)
    wrapper_ms = time_ms(lambda: nk.fused_normalise_noise_blend(
        u8, ones, *HALF, seed=seed, offset=offset), 50)
    plain_ms = time_ms(lambda: nk.fused_normalise_noise_blend_plain(
        u8, ones, norm, seed=seed, offset=offset), 3, warmup=1)
    bound_ms, bound_by = bound(
        n * (1 + 4) + 4 * b, n * NOISE_FP_OPS["fused_normalise_noise_blend"],
        n * NOISE_INT_OPS)
    log(f"  u8 448^2 x12: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by})")
    results["fused_normalise_noise_blend"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by)

    # fp32: the denoiser's noise stage after the warp.
    b = 16
    n = b * h * w * c
    x = torch.randn((b, h, w, c), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    ratios = torch.rand(b, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    got = nk.fused_noise_blend(x, ratios, seed=seed, offset=offset)
    err = compare_ulp(got, nk.fused_noise_blend_plain(
        x, ratios, seed=seed, offset=offset), "f32 448^2 x16")
    check(torch.equal(nk.fused_noise_blend(x, torch.zeros(b, device=dev),
                                           seed=seed), x),
          "ratio 0 is not the identity")
    zeros, ones = torch.zeros_like(x), torch.ones(b, device=dev)
    eps = nk.fused_noise_blend(zeros, ones, seed=seed, offset=offset)
    noise_stats(eps, "f32 448^2 x16")
    check(torch.equal(eps, nk.fused_noise_blend(zeros, ones, seed=seed,
                                                offset=offset)),
          "not deterministic")
    out = torch.empty_like(x)
    ms = time_ms(lambda: nk.launch_blend(x, out, ratios, None, seed=seed,
                                         offset=offset), 50)
    wrapper_ms = time_ms(lambda: nk.fused_noise_blend(
        x, ratios, seed=seed, offset=offset), 50)
    plain_ms = time_ms(lambda: nk.fused_noise_blend_plain(
        x, ratios, seed=seed, offset=offset), 3, warmup=1)
    # The stage it replaces on the denoiser path: torch.randn, then
    # blend_noise (PyTorch elementwise launches).
    gen = torch.Generator(device=dev).manual_seed(8)
    r4 = ratios.reshape(b, 1, 1, 1)
    before_ms = time_ms(lambda: blend_noise(
        x, torch.randn(x.shape, generator=gen, device=dev), r4), 50)
    bound_ms, bound_by = bound(n * (4 + 4) + 4 * b,
                               n * NOISE_FP_OPS["fused_noise_blend"],
                               n * NOISE_INT_OPS)
    log(f"  f32 448^2 x16: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} "
        f"ms), plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}); the PyTorch stage it "
        f"replaces (torch.randn + blend_noise) {before_ms:.4f} ms")
    results["fused_noise_blend"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
    return results


def random_params(b: int, seed: int, device) -> dict:
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return sample_affine_params(b, AffineAugmentConfig.random_affine(),
                                generator=gen, device=device)


def kernel_checks(dev) -> dict:
    """Phase 3: each kernel against its plain version at the path shapes."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        warp_fused as wf, warp_kernel as wk)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass \
        import graph_ms, route_cases

    rng = np.random.default_rng(SEED)
    results = {}

    # Fused warp, uint8 fold, 448^2 x 16: the main path's call, with both
    # stat sets, then the corners of random_affine's ranges (sources off
    # the edge, so the zero border is exercised).
    b, h, w, c = 16, 448, 448, 3
    u8 = torch.from_numpy(rng.integers(0, 256, (b, h, w, c),
                                       np.uint8)).to(dev)
    corners = torch.tensor([(15.0, 1.2, 0.2, 0.2), (-15.0, 0.8, -0.2, -0.2),
                            (15.0, 0.8, -0.2, 0.2), (-15.0, 1.2, 0.2, -0.2)],
                           device=dev).repeat(b // 4, 1).T
    extreme = dict(angle=corners[0], scale=corners[1], tx=corners[2],
                   ty=corners[3], apply=torch.ones(b, dtype=torch.bool,
                                                   device=dev))
    coeffs = _inverse_affine_coeffs(random_params(b, 1, dev), h, w)
    errs = []
    corner_coeffs = _inverse_affine_coeffs(extreme, h, w)
    for what, cf, (mean, std) in (("random params", coeffs, HALF),
                                  ("random params", coeffs, IMAGENET),
                                  ("range corners", corner_coeffs, IMAGENET)):
        got = wf.affine_warp_fused_coeffs(u8, cf, mean=mean, std=std)
        want = wf.affine_warp_fused_plain(
            u8, cf, wf.norm_constants(mean, std, c))
        errs.append(compare(got, want,
                            f"fused 448^2 x16 {what}, mean={mean}"))
    norm = wf.norm_constants(*HALF, c)
    alpha_x, shift_x, alpha_y, shift_y = wk.shear_factors(coeffs, h, w)
    bx, rx = wk.pass_scalars(alpha_x, shift_x, w)
    by, ry = wk.pass_scalars(alpha_y, shift_y, h)
    ax, ay = alpha_x.contiguous(), alpha_y.contiguous()
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    # The one launch, into a preallocated output, so the host's launch rate
    # stays below the kernel's; the wrapper (scalars, allocation) beside it.
    ms = time_ms(lambda: wf.launch_fused(u8, out, ax, bx, rx, ay, by, ry,
                                         norm), 50)
    wrapper_ms = time_ms(lambda: wf.affine_warp_fused_coeffs(
        u8, coeffs, mean=0.5, std=0.5), 50)
    plain_ms = time_ms(lambda: wf.affine_warp_fused_plain(u8, coeffs, norm),
                       3, warmup=1)
    n = b * h * w * c
    bound_ms, bound_by = bound(n * (1 + 4), 2 * n * OPS_PER_PASS_ELEMENT)
    log(f"  fused 448^2 x16: kernel {ms:.4f} ms (wrapper incl. scalar prep "
        f"{wrapper_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by})")
    results["affine_warp_fused"] = dict(max_abs_err=max(errs), ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)

    # Axis pass: both kernels on both layouts of the two-pass route (the
    # x-pass, NHWC source -> planar; the y-pass, planar -> NHWC) at 448^2 x
    # 16 and at the route's own 640^2 x 4, each bit-equal to the plain
    # version. Each pass alone, through the kernel its layout picks, into a
    # preallocated output: by CUDA-graph replay (the kernels back to back;
    # the wrapper's checks take longer on the host than a pass on the
    # card), and by the launch loop earlier PRs timed.
    errs, passes = [], {}
    shapes = route_cases(dev)
    for shape in shapes:
        for case in shape["passes"]:
            src, dst, scalars = case["src"], case["dst"], case["scalars"]
            key = f"{case['what']} {shape['key']}"
            for kernel in wk.PASS_KERNELS:
                dst.fill_(math.nan)
                wk.launch_pass(src, dst, *scalars, kernel=kernel)
                errs.append(compare(dst, case["want"],
                                    f"{key}, {kernel} kernel"))
            passes[key] = graph_ms(lambda: wk.launch_pass(src, dst, *scalars))
            loop_ms = time_ms(lambda: wk.launch_pass(src, dst, *scalars), 50)
            n = shape["elements"]
            bound_ms, bound_by = bound(n * (4 + 4), n * OPS_PER_PASS_ELEMENT)
            log(f"  {key} alone ({wk.pass_kernel(src.stride())} kernel): "
                f"{passes[key]:.4f} ms (launch loop {loop_ms:.4f} ms), bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}), "
                f"{bound_ms / passes[key]:.0%} of it")

    # The two-pass route through its wrapper: random params at both shapes
    # and the corners of random_affine's ranges at 640^2 x 4.
    x, x640 = shapes[0]["x"], shapes[1]["x"]
    c640 = shapes[1]["coeffs"]
    corner640 = _inverse_affine_coeffs(
        {k: v[:4] for k, v in extreme.items()}, 640, 640)
    plain640 = wk.affine_warp_twopass_plain(x640, c640)
    for what, xs, cf, want in (
            ("448^2 x16 random params", x, shapes[0]["coeffs"],
             wk.affine_warp_twopass_plain(x, shapes[0]["coeffs"])),
            ("640^2 x4 random params", x640, c640, plain640),
            ("640^2 x4 range corners", x640, corner640,
             wk.affine_warp_twopass_plain(x640, corner640))):
        errs.append(compare(wk.affine_warp_twopass_coeffs(xs, cf), want,
                            f"two-pass {what}"))
    # The whole two-pass warp at 640^2 x 4: its two launches into
    # preallocated tensors, then the wrapper (scalars, allocation).
    first, second = shapes[1]["passes"]
    (pax, pbx, prx), (pay, pby, pry) = first["scalars"], second["scalars"]
    t640 = first["dst"]                       # planar, as (B, H, C, W)
    o640 = second["dst"].permute(0, 3, 1, 2)  # NHWC

    def twopass():
        wk.launch_pass(first["src"], t640, pax, pbx, prx)
        wk.launch_pass(t640.permute(0, 3, 2, 1), second["dst"], pay, pby,
                       pry)

    ms = graph_ms(twopass)
    errs.append(compare(o640, plain640, "two-pass 640^2 x4, timed launches"))
    wrapper_ms = time_ms(lambda: wk.affine_warp_twopass_coeffs(x640, c640),
                         50)
    plain_ms = time_ms(lambda: wk.affine_warp_twopass_plain(x640, c640), 3,
                       warmup=1)
    n = shapes[1]["elements"]
    bound_ms, bound_by = bound(2 * n * (4 + 4), 2 * n * OPS_PER_PASS_ELEMENT)
    log(f"  two-pass 640^2 x4, both passes: kernels {ms:.4f} ms (wrapper "
        f"incl. scalar prep {wrapper_ms:.4f} ms), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms:.0%} "
        "of it")
    results["warp_axis_pass"] = dict(max_abs_err=max(errs), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, passes_ms=passes)

    # Recorded only (auto keeps the JAX routing): the fused warp at 640^2 x
    # 4, fp32 in, bit-equal to the two-pass warp, and uint8 with the
    # normalise folded in, as the route would call it.
    f640 = torch.empty_like(o640)
    fused_args = (pax, pbx, prx, pay, pby, pry)
    wf.launch_fused(x640, f640, *fused_args, None)
    compare(f640, plain640, "fused 640^2 x4 fp32 (recorded only)")
    fused_ms = graph_ms(lambda: wf.launch_fused(x640, f640, *fused_args,
                                                None))
    u640 = torch.from_numpy(rng.integers(0, 256, (4, 640, 640, c),
                                         np.uint8)).to(dev)
    wf.launch_fused(u640, f640, *fused_args, norm)
    compare(f640, wf.affine_warp_fused_plain(u640, c640, norm),
            "fused 640^2 x4 uint8 (recorded only)")
    fused_u8_ms = graph_ms(lambda: wf.launch_fused(u640, f640, *fused_args,
                                                   norm))
    log(f"  fused 640^2 x4 (recorded only, graph-timed): fp32 in "
        f"{fused_ms:.4f} ms, uint8 in {fused_u8_ms:.4f} ms, against the "
        f"two-pass kernels' {ms:.4f} ms")
    return results


def make_trainer(device, *, encoder: str, batch: int, size: int,
                 dtype: str, warp_method: str = "auto"):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)

    # The values of configs/denoiser.yml (the GPU machine may lack PyYAML),
    # at the 448^2 image size of configs/denoise.yml:23.
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path="synthetic", batch_size=batch,
        learning_rate=0.02, max_epochs=100, cosine_scheduler_max_epoch=100,
        encoder_name=encoder, noise_exponential_sampling_lambda=5,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), compute_dtype=dtype,
        image_size=size, warp_method=warp_method, seed=SEED))
    return DenoiserTrainer(cfg, steps_per_epoch=1000, image_size=size,
                           device=device)


def small_reference(dev) -> None:
    """Phase 4: a 64^2 fp32 step on the GPU against the CPU plain path."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, sample_affine_params)

    rng = np.random.default_rng(SEED + 1)
    b, s = 2, 64
    u8 = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    params = sample_affine_params(b, AffineAugmentConfig.random_affine(),
                                  generator=torch.Generator().manual_seed(5))
    ratios = torch.from_numpy(rng.uniform(0, 0.5, b).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
        np.float32))
    losses = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        trainer = make_trainer(device, encoder="resnet18", batch=b, size=s,
                               dtype="float32", warp_method="pallas_fused")
        state = trainer.init_state(seed=7)
        on = torch.device(device)
        m = trainer.train_step(
            state, u8, affine_params={k: v.to(on) for k, v in params.items()},
            ratios=ratios.to(on), noise=noise.to(on))
        losses[name] = float(m["loss"])
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"  64^2 fp32 step loss: cuda {losses['cuda']:.7f}, cpu "
        f"{losses['cpu']:.7f}, relative difference {rel:.2e} (limit 1e-4: "
        "cuDNN and the CPU sum convolutions in other orders)")
    check(math.isfinite(losses["cuda"]) and rel < 1e-4,
          "the GPU step disagrees with the CPU reference")


def drive(dev, launches, card: str, trainer, *, size: int, batch: int,
          warmup: int, steps: int, per_step: dict) -> dict:
    """Phases 5 to 7: train steps through the entry points, counted;
    ``per_step`` holds the launches each kernel wrapper must make a step."""
    state = trainer.init_state(seed=SEED)
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)
        for _ in range(min(warmup + steps, 8))]
    probe = next(state.model.parameters())
    before = probe.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    launches.clear()
    losses = []
    for i in range(warmup):
        losses.append(trainer.train_step(state, batches[i])["loss"])
    torch.cuda.synchronize()
    # One event per step boundary on the device's timeline: per-step
    # times without a host synchronisation between steps.
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(warmup, warmup + steps):
        losses.append(trainer.train_step(state, batches[i % len(batches)])
                      ["loss"])
        events[i - warmup + 1].record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = dict(launches)
    step_times = sorted(a.elapsed_time(b)
                        for a, b in zip(events, events[1:]))

    losses = [float(v) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {size}^2 x{batch} resnet34 bf16: losses "
        f"{[round(v, 5) for v in losses]}")
    log(f"  {size}^2 x{batch}: {step_ms:.3f} ms/step (host clock, mean of "
        f"{steps}), {batch / step_ms * 1e3:.1f} imgs/s; per-step device "
        f"timeline median {step_times[len(step_times) // 2]:.3f} ms, "
        f"min {step_times[0]:.3f}, max {step_times[-1]:.3f}; peak memory "
        f"{peak_gb:.2f} GB [{card}]")
    log(f"  launches: {counts}")
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    n_steps = warmup + steps
    for kernel in KERNELS:
        want = per_step.get(kernel, 0) * n_steps
        check(counts.get(kernel, 0) == want,
              f"{kernel} launched {counts.get(kernel, 0)} times in "
              f"{n_steps} steps, not {want}")
    check(not torch.equal(before, probe.detach()), "params did not change")
    return dict(trainer=trainer, state=state, counts=counts,
                step_ms=step_ms, batch=batch, size=size)


def profile_steps(run: dict, dev, path: Path | None) -> dict:
    """Device time by kernel over 3 more steps of a path; returns the port's
    kernels' time per step by device function."""
    from torch.profiler import ProfilerActivity, profile

    trainer, state, size = run["trainer"], run["state"], run["size"]
    u8 = torch.randint(0, 256, (run["batch"], size, size, 3),
                       dtype=torch.uint8, device=dev)
    trainer.train_step(state, u8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(state, u8)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=60)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(table)

    # Kernel rows only: an operator's row repeats its kernels' time.
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 3e3
    port_ms = {fn: sum(e.self_device_time_total for e in kernels
                       if fn in e.key) / 3e3
               for fn in sorted({f for k in KERNELS.values() for f in k[2:]})}
    if busy_ms > 0:
        share = busy_ms / run["step_ms"]
        log(f"  profile of 3 steps ({window_ms / 3:.3f} "
            f"ms/step under the profiler): kernels {busy_ms:.3f} ms per step"
            f", {share:.1%} of the unprofiled {run['step_ms']:.3f} ms step "
            f"(device idle {1 - share:.1%})")
        for fn, ms in port_ms.items():
            log(f"    {fn}: {ms:.4f} ms per step ({ms / busy_ms:.2%} of "
                "device time)")
    else:
        log("  profiler recorded no device time: busy share not measured")
    for line in table.splitlines()[:24]:
        log("    " + line[:60] + line[100:])
    return port_ms


def make_balancer(device):
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        BalanceConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        BalanceTrainer)

    # The values of configs/balance.yml at the 448^2 image size of
    # configs/denoise.yml:23.
    cfg = config_from_dict(BalanceConfig, dict(
        data_path="synthetic", batch_size=12, learning_rate=0.01,
        max_epochs=200, encoder_name="resnet34", ratio_of_noise=0.7,
        number_of_classes=10, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
        compute_dtype="bfloat16", image_size=448, seed=SEED))
    return BalanceTrainer(cfg, steps_per_epoch=1000, image_size=448,
                          device=device)


def score_and_write(run: dict, dev, launches) -> None:
    """Phase 7, after the train steps: score 50 images, bin them, write
    the balanced manifest and read it back. Launches accumulate on the
    train steps' counts."""
    from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
        read_image_manifest_with_classes)
    from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
        compute_difficulty_index, write_balanced_manifest)

    trainer, state = run["trainer"], run["state"]
    n, bs, size = 50, run["batch"], run["size"]
    data = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, 256, (n, size, size, 3), np.uint8)).to(dev)
    batches = [(data[i:i + bs], np.arange(i, min(i + bs, n)))
               for i in range(0, n, bs)]
    before = launches.get("fused_normalise_noise_blend", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indices, losses = trainer.score_dataset(state, batches, epoch=0)
    score_ms = (time.perf_counter() - t0) * 1e3
    scored = launches.get("fused_normalise_noise_blend", 0) - before
    classes = compute_difficulty_index(losses, trainer.cfg.number_of_classes)
    log(f"  scored {n} images in {len(batches)} batches (last {n % bs} "
        f"padded to {bs}): {score_ms:.3f} ms ({n / score_ms * 1e3:.1f} "
        f"imgs/s), losses {losses.min():.5f}..{losses.max():.5f}, class "
        f"counts {np.bincount(classes, minlength=10).tolist()}, noise "
        f"kernel launches {scored}")
    check(scored == len(batches) == 5, f"scoring launched the noise kernel "
          f"{scored} times for {len(batches)} batches")
    check(losses.shape == (n,) and np.isfinite(losses).all(),
          "scores are not 50 finite losses")
    check(np.array_equal(indices, np.arange(n)), "scoring lost the order")
    check(classes.min() >= 0 and classes.max() < 10, "class out of range")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "images" / f"{i:05d}.png" for i in range(n)]
        manifest = Path(tmp) / "balanced.txt"
        write_balanced_manifest(manifest, paths, indices, classes)
        got_paths, got_classes = read_image_manifest_with_classes(manifest)
    check(got_paths == paths and got_classes == classes.tolist(),
          "the balanced manifest does not read back")
    log(f"  balanced manifest: {n} lines written and read back")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-out", type=Path, default=None,
                        help="write the main path's profiler table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("[1] card (nvidia-smi name, power.limit):")
    log(card)
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    # The plain warp's matmul must stay in fp32 (bf16-valued operands give
    # exact products only there); PyTorch's default, stated and set.
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    sources = sorted({k[0][:-3] for k in KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    log(f"[2] built {', '.join(lib.name for lib, _ in built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, report in built:
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log("    " + line.strip()[:110])

    log("[3] kernels vs plain versions")
    results = kernel_checks(dev)
    results.update(noise_checks(dev))

    log("[4] small-input reference")
    small_reference(dev)

    log("[5] main path: 448^2, batch 16, auto warp route")
    main_run = drive(dev, _build.LAUNCHES, card,
                     make_trainer(dev, encoder="resnet34", batch=16,
                                  size=448, dtype="bfloat16"),
                     size=448, batch=16, warmup=3, steps=30,
                     per_step={"affine_warp_fused": 1,
                               "fused_noise_blend": 1})
    denoise = main_run["trainer"].make_denoise_fn()
    x = torch.rand((4, 448, 448, 3), device=dev) * 2 - 1
    out = denoise(main_run["state"], x)
    torch.cuda.synchronize()
    check(out.shape == x.shape and out.dtype == torch.float32
          and torch.isfinite(out).all().item(), "eval forward is not finite")
    log(f"  eval-mode forward {tuple(out.shape)} finite")
    profile_steps(main_run, dev, args.profile_out)

    log("[6] two-pass route: 640^2, batch 4, auto warp route")
    twopass_run = drive(dev, _build.LAUNCHES, card,
                        make_trainer(dev, encoder="resnet34", batch=4,
                                     size=640, dtype="bfloat16"),
                        size=640, batch=4, warmup=2, steps=10,
                        per_step={"warp_axis_pass": 2,
                                  "fused_noise_blend": 1})
    profile_steps(twopass_run, dev, None)

    log("[7] balancer: 448^2, batch 12, fixed ratio 0.7")
    balance_run = drive(dev, _build.LAUNCHES, card, make_balancer(dev),
                        size=448, batch=12, warmup=3, steps=20,
                        per_step={"fused_normalise_noise_blend": 1})
    # The path goes on to the scoring pass: its counts are read after it.
    score_and_write(balance_run, dev, _build.LAUNCHES)
    balance_counts = dict(_build.LAUNCHES)
    log(f"  launches on the balancer path: {balance_counts}")
    profile_steps(balance_run, dev, None)

    launches = {
        "affine_warp_fused": main_run["counts"].get("affine_warp_fused", 0),
        "warp_axis_pass": twopass_run["counts"].get("warp_axis_pass", 0),
        "fused_noise_blend": main_run["counts"].get("fused_noise_blend", 0),
        "fused_normalise_noise_blend":
            balance_counts.get("fused_normalise_noise_blend", 0)}
    kernels = [dict(name=k, route="cuda", source=f"{CSRC}/{src}",
                    replaces=f"{REPO}/{tpu}", launches=launches[k],
                    library_ms=None, **results[k])
               for k, (src, tpu, *_) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
