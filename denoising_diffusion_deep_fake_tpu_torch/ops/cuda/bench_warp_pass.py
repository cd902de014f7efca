"""Time the axis pass's kernels on one GPU, without the host's launch cost.

    python -m denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass
    PYTHONPATH=OTHER_CHECKOUT python \
        denoising_diffusion_deep_fake_tpu_torch/ops/cuda/bench_warp_pass.py

Times ``launch_pass`` of the ``denoising_diffusion_deep_fake_tpu_torch``
that Python finds first (the second form times another checkout's kernels,
a parent commit's say: ``launch_pass(src, dst, alpha, base, resid)`` has
taken these five arguments since the port began) on the two layouts of the
two-pass route,
the x-pass (NHWC source, planar destination) and the y-pass (planar source,
NHWC destination), at 448^2 x 16 and at the route's own 640^2 x 4, fp32,
C = 3, ``random_affine`` params, and both passes back to back at 640^2 x 4.
A time is the mean over CUDA-graph replays of 20 launches: the kernels back
to back, since the wrapper's checks take longer on the host than a pass
takes on the card. Each launch is first checked bit-equal to
``warp_axis_pass_plain``. Prints the card's name and power limit, then one
JSON line of times in ms.
"""

from __future__ import annotations

import json
import math
import subprocess

import torch


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device time of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, replayed ``replays`` times between two events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


ROUTE_SHAPES = ((16, 448, 1), (4, 640, 4))  # batch, size, params' seed


def route_cases(dev, shapes=ROUTE_SHAPES) -> list[dict]:
    """The two-pass route's inputs at 448^2 x 16 and 640^2 x 4: per shape
    the NHWC batch ``x``, its inverse-map ``coeffs`` and the ``passes``,
    each with its ``(B, L, C, N)`` source and preallocated destination
    views, the pass's ``alpha`` and ``shift``, ``launch_pass``'s scalars
    and the plain version's result. The y-pass reads the plain x-pass's
    planar result."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        AffineAugmentConfig, _inverse_affine_coeffs, sample_affine_params)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        warp_kernel as wk)

    out = []
    for b, h, seed in shapes:
        w, c = h, 3
        x = torch.randn((b, h, w, c), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
        params = sample_affine_params(
            b, AffineAugmentConfig.random_affine(),
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)
        coeffs = _inverse_affine_coeffs(params, h, w)
        ax, sx, ay, sy = wk.shear_factors(coeffs, h, w)
        xv = x.permute(0, 1, 3, 2)
        want_x = wk.warp_axis_pass_plain(xv, ax, sx)
        planar = want_x.permute(0, 2, 1, 3).contiguous()
        yv = planar.permute(0, 3, 1, 2)
        passes = []
        for what, src, dst, alpha, shift, want in (
                ("x-pass", xv, torch.empty((b, c, h, w), device=dev).permute(
                    0, 2, 1, 3), ax, sx, want_x),
                ("y-pass", yv, torch.empty((b, h, w, c), device=dev).permute(
                    0, 2, 3, 1), ay, sy, wk.warp_axis_pass_plain(yv, ay,
                                                                 sy))):
            base, resid = wk.pass_scalars(alpha, shift, src.shape[-1])
            passes.append(dict(what=what, src=src, dst=dst, alpha=alpha,
                               shift=shift, want=want,
                               scalars=(alpha.contiguous(), base, resid)))
        out.append(dict(key=f"{h}^2 x{b}", x=x, coeffs=coeffs,
                        elements=b * h * w * c, passes=passes))
    return out


def main() -> int:
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        warp_kernel as wk)

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    times = {}
    for shape in route_cases(dev):
        for case in shape["passes"]:
            src, dst = case["src"], case["dst"]
            dst.fill_(math.nan)
            wk.launch_pass(src, dst, *case["scalars"])
            torch.cuda.synchronize()
            if not torch.equal(dst, case["want"]):
                raise SystemExit(f"{case['what']} {shape['key']}: the "
                                 "kernel disagrees with the plain version")
            times[f"{case['what']} {shape['key']}"] = graph_ms(
                lambda: wk.launch_pass(src, dst, *case["scalars"]))
    first, second = shape["passes"]  # 640^2 x 4, the y-pass reads planar

    def both():
        wk.launch_pass(first["src"], first["dst"], *first["scalars"])
        wk.launch_pass(first["dst"].permute(0, 3, 2, 1), second["dst"],
                       *second["scalars"])

    times[f"two-pass {shape['key']}"] = graph_ms(both)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
