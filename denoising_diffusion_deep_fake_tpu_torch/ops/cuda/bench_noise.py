"""Time the noise kernels on one GPU, without the host's launch cost.

    python -m denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_noise \\
        [--json PATH] [--against PATH] [--variants THREADS:GROUPS ...]
    PYTHONPATH=OTHER_CHECKOUT python \\
        denoising_diffusion_deep_fake_tpu_torch/ops/cuda/bench_noise.py ...

Times ``launch_blend`` of the ``denoising_diffusion_deep_fake_tpu_torch``
that Python finds first (the second form times another checkout's kernels,
a parent commit's say: ``launch_blend`` and ``noise_constants`` have taken
these arguments since the noise kernels were ported) at the shapes of their
paths: the uint8 kernel at the balancer's 448^2 x 12 (ratio 0.7, mean and
std 0.5), on uniform noise and on a smooth image (bilinear upsampling of
14^2 noise, whose neighbouring lanes read near-equal table entries), and
the fp32 kernel at the denoiser's 448^2 x 16. A time is the mean over
CUDA-graph replays of 20 launches (``bench_warp_pass.graph_ms``): the
wrapper's checks take about as long on the host as a launch on the card.
Each timed launch is first held within one ulp of the plain version.

Then, for a check across checkouts, the SHA-256 of each kernel's output on
fixed inputs: 448^2 x 12 with ratios across [0, 1] under both stat sets, a
scoring offset above 2^32, an unaligned uint8 view, shapes whose samples
straddle groups of 4 ((3, 5, 7, 3), (8, 1, 1, 1), (6, 1, 1, 2)), a shape
whose samples straddle some of the uint8 kernel's blocks and not others
((3, 100, 100, 3)), and the fp32 kernel at 448^2 x 16 and (3, 5, 7, 3). ``--against`` fails unless
every digest equals the one in an earlier run's ``--json`` file.

Then each kernel's SASS (``cuobjdump -sass`` of the built library, NOPs
left out): its static instruction count, and its main-path count a group
of 4 elements, which leaves out the cold code (``main_path_count``) and
divides the uint8 kernel's by the groups a thread takes (``U8_GROUPS`` of
``csrc/noise.cu``, 1 where the source has none). That count is still
static: it counts the scalar paths for unaligned pointers and the tail
once, so it bounds what a group on the main path issues from above. The
issue time it implies is the warp instructions of the whole batch over
132 SMs x 4 schedulers x the card's maximum SM clock. Beside it, the
resource use (``cuobjdump -res-usage``: registers, stack, shared memory,
and LOCAL bytes, which would be spills).

``--variants`` (this checkout only) builds ``csrc/noise.cu`` with the
uint8 kernel's U8_THREADS and U8_GROUPS replaced, holds each variant
bit-equal to the built kernel and times it on both inputs, three times
each. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import noise_kernel as nk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.bench_warp_pass import (
    graph_ms,
)

SEED, OFFSET = 12345, 7
HALF = ((0.5,) * 3, (0.5,) * 3)
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
SMS, SCHEDULERS = 132, 4
KERNEL_NAMES = ("normalise_noise_blend_u8_kernel", "noise_blend_f32_kernel")
VARIANT_NAMES = ("U8_THREADS", "U8_GROUPS")


def card(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           f"--format={fmt}"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def balancer_inputs(dev) -> dict:
    """The uint8 kernel's path inputs: 448^2 x 12, noisy and smooth."""
    rng = np.random.default_rng(3)
    noisy = torch.from_numpy(rng.integers(0, 256, (12, 448, 448, 3),
                                          np.uint8)).to(dev)
    low = torch.from_numpy(rng.integers(0, 256, (12, 3, 14, 14)).astype(
        np.float32)).to(dev)
    smooth = F.interpolate(low, size=(448, 448), mode="bilinear",
                           align_corners=False).round().clamp(0, 255).to(
        torch.uint8).permute(0, 2, 3, 1).contiguous()
    return {"noisy": noisy, "smooth": smooth}


def within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
        - want.abs()
    return bool(((got - want).abs() <= ulp).all())


def timings(dev) -> dict:
    times = {}
    norm = nk.noise_constants(*HALF, 3)
    ratios = torch.full((12,), 0.7, device=dev)
    for what, u8 in balancer_inputs(dev).items():
        out = torch.empty(u8.shape, dtype=torch.float32, device=dev)
        nk.launch_blend(u8, out, ratios, norm, seed=SEED, offset=OFFSET)
        want = nk.fused_normalise_noise_blend_plain(u8, ratios, norm,
                                                    seed=SEED, offset=OFFSET)
        if not within_one_ulp(out, want):
            raise SystemExit(f"u8 {what}: more than one ulp from the plain "
                             "version")
        times[f"u8 448^2 x12 {what}"] = graph_ms(lambda: nk.launch_blend(
            u8, out, ratios, norm, seed=SEED, offset=OFFSET))
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((16, 448, 448, 3), device=dev, generator=gen)
    ratios = torch.rand(16, device=dev, generator=gen)
    out = torch.empty_like(x)
    nk.launch_blend(x, out, ratios, None, seed=SEED, offset=OFFSET)
    if not within_one_ulp(out, nk.fused_noise_blend_plain(
            x, ratios, seed=SEED, offset=OFFSET)):
        raise SystemExit("f32: more than one ulp from the plain version")
    times["f32 448^2 x16"] = graph_ms(lambda: nk.launch_blend(
        x, out, ratios, None, seed=SEED, offset=OFFSET))
    return times


def digests(dev) -> dict:
    rng = np.random.default_rng(4)
    out = {}

    def u8_case(key, u8, ratios, stats, offset):
        norm = nk.noise_constants(*stats, u8.shape[-1])
        got = torch.empty(u8.shape, dtype=torch.float32, device=dev)
        nk.launch_blend(u8, got, ratios, norm, seed=SEED, offset=offset)
        out[key] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()

    big = torch.from_numpy(rng.integers(0, 256, (12, 448, 448, 3),
                                        np.uint8)).to(dev)
    spread = torch.linspace(0, 1, 12, device=dev)
    u8_case("u8 448^2 x12 half", big, spread, HALF, OFFSET)
    u8_case("u8 448^2 x12 imagenet", big, spread, IMAGENET, OFFSET)
    u8_case("u8 448^2 x12 offset 2^32+3", big, spread, HALF, (1 << 32) + 3)
    flat = torch.from_numpy(rng.integers(0, 256, 4 * 64 * 64 * 3 + 1,
                                         np.uint8)).to(dev)
    u8_case("u8 64^2 x4 unaligned", flat[1:].view(4, 64, 64, 3),
            torch.linspace(0, 1, 4, device=dev), IMAGENET, OFFSET)
    for shape in ((3, 5, 7, 3), (8, 1, 1, 1), (6, 1, 1, 2),
                  (3, 100, 100, 3)):
        c = shape[-1]
        u8 = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)
        u8_case(f"u8 {shape}", u8, torch.linspace(0, 1, shape[0],
                                                  device=dev),
                (IMAGENET[0][:c], IMAGENET[1][:c]), (3 << 32) + 11)
    for shape in ((16, 448, 448, 3), (3, 5, 7, 3)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        got = torch.empty_like(x)
        nk.launch_blend(x, got, torch.linspace(0, 1, shape[0], device=dev),
                        None, seed=SEED, offset=OFFSET)
        out[f"f32 {shape}"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()
    return out


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise SystemExit(f"{name} not found")
    return found


_INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_GUARD = re.compile(r"@!?P\d\s+BRA\s+(?:!?P\d,\s*)?0x([0-9a-f]+)")
_CALL = re.compile(r"CALL\.\S+\s+0x([0-9a-f]+)")


def main_path_count(instrs: list[tuple[int, str]]) -> int:
    """Instructions of a kernel less its cold code: the subroutines it
    calls (from the first call target on: the math library's special
    cases of sqrt and division, and the uint8 kernel's sample-straddling
    path) and, for each call or local-memory access (the wide-argument
    trig reduction is the only code that spills), the code skipped by the
    nearest forward branch around it."""
    calls = [int(m.group(1), 16) for _, t in instrs if (m := _CALL.search(t))]
    end = min(calls, default=instrs[-1][0])  # the last is BRA to itself
    body = [(a, t) for a, t in instrs if a < end]
    cold = set()
    for i, (a, t) in enumerate(body):
        op = t.split()[1 if t.startswith("@") else 0]
        if not op.startswith(("CALL", "LDL", "STL")):
            continue
        for a2, t2 in reversed(body[:i]):
            guard = _GUARD.match(t2)
            if guard and int(guard.group(1), 16) > a:
                cold.update(x for x, _ in body
                            if a2 < x < int(guard.group(1), 16))
                break
    return sum(a not in cold for a, _ in body)


def sass_counts(lib: Path, groups_a_thread: int, elements: dict) -> dict:
    """Static SASS instructions, main-path instructions and resources of
    each noise kernel."""
    def dump(flag):
        return subprocess.run([_tool("cuobjdump"), flag, str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()

    funcs, func = {}, None
    for line in dump("-sass"):
        head = re.search(r"Function : (\S+)", line)
        if head:
            func = head.group(1)
            funcs[func] = []
        elif func and (m := _INSTR.match(line)) and "NOP" not in m.group(2):
            funcs[func].append((int(m.group(1), 16), m.group(2).strip()))
    res = dump("-res-usage")
    clock_hz = float(card("clocks.max.sm", units=False)) * 1e6
    out = {}
    for func, instrs in funcs.items():
        name = next((k for k in KERNEL_NAMES if k in func), None)
        if name is None:
            continue
        u8 = "u8" in name
        chans = re.search(r"ILi(\d)E", func)
        # The train steps' form reads its offset on the device (AT true).
        at = "Lb1E" in func
        per_group = main_path_count(instrs) / (groups_a_thread if u8 else 1)
        usage = " ".join(" ".join(res[i:i + 2]) for i, ln in enumerate(res)
                         if func in ln)
        issue_ms = (per_group * elements["u8" if u8 else "f32"] / 4 / 32
                    / (SMS * SCHEDULERS * clock_hz) * 1e3)
        out[name + (f"<{chans.group(1)}>" if chans else "")
            + (" offset_at" if at else "")] = dict(
            static=len(instrs), main_path_per_group=per_group,
            issue_ms=issue_ms, resources=" ".join(re.findall(
                r"(?:REG|STACK|SHARED|LOCAL):\d+", usage)))
    return out


def variant_source(text: str, values: list[int]) -> str:
    for name, value in zip(VARIANT_NAMES, values):
        const = f"constexpr int {name} = "
        start = text.find(const)
        if start < 0:
            raise RuntimeError(f"csrc/noise.cu has no {const!r}")
        text = text[:start] + f"{const}{value}" + text[text.index(";",
                                                                   start):]
    return text


def sweep(names: list[str], dev) -> dict:
    """Each variant bit-equal to the built kernel, then timed three times
    on the noisy and the smooth input."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build
    text = (_build._CSRC / "noise.cu").read_text()
    norm = nk.noise_constants(*HALF, 3)
    c_norm = (ctypes.c_float * len(norm))(*norm)
    ratios = torch.full((12,), 0.7, device=dev)
    inputs = balancer_inputs(dev)
    wants = {}
    for what, u8 in inputs.items():
        wants[what] = torch.empty(u8.shape, dtype=torch.float32, device=dev)
        nk.launch_blend(u8, wants[what], ratios, norm, seed=SEED,
                        offset=OFFSET)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        built = _build.build_variants(
            {f"noise_{n}": variant_source(text, [int(v) for v in
                                                 n.split(":")])
             for n in names}, Path(tmp))
        for name in names:
            if f"noise_{name}" not in built:
                continue
            lib, report = built[f"noise_{name}"]
            fn = ctypes.CDLL(str(lib)).d3f_noise_blend
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                           ctypes.c_ulonglong, ctypes.c_ulonglong,
                           ctypes.c_ulonglong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            row = {"ptxas": _build.ptxas_summary(
                report, "normalise_noise_blend_u8_kernelILi3")}
            for what, u8 in inputs.items():
                out = torch.full(u8.shape, math.nan, device=dev)

                def launch():
                    err = fn(2, u8.data_ptr(), out.data_ptr(), u8.numel(),
                             448 * 448 * 3, 3, ratios.data_ptr(), c_norm,
                             SEED, OFFSET, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                row[what] = dict(equal=torch.equal(out, wants[what]),
                                 ms=[graph_ms(launch) for _ in range(3)])
            results[name] = row
            print(f"{':'.join(VARIANT_NAMES)} {name}: {json.dumps(row)}",
                  flush=True)
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the result line here")
    parser.add_argument("--against", type=Path, default=None,
                        help="an earlier run's --json file whose digests "
                        "this run's must equal")
    parser.add_argument("--variants", nargs="*", default=[],
                        help="U8_THREADS:U8_GROUPS variants to sweep")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(card())
    dev = torch.device("cuda")
    lib, _ = _build.build("noise")
    source = (_build._CSRC / "noise.cu").read_text()
    groups = re.search(r"constexpr int U8_GROUPS = (\d+);", source)
    result = dict(
        card=card(), times_ms=timings(dev), digests=digests(dev),
        sass=sass_counts(lib, int(groups.group(1)) if groups else 1,
                         {"u8": 12 * 448 * 448 * 3, "f32": 16 * 448 * 448 * 3}))
    if args.variants:
        result["sweep"] = sweep(args.variants, dev)
    line = json.dumps(result)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    if args.against:
        theirs = json.loads(args.against.read_text())["digests"]
        differ = [k for k, v in result["digests"].items()
                  if theirs.get(k) != v]
        print(f"digests against {args.against}: "
              f"{len(result['digests']) - len(differ)} of "
              f"{len(result['digests'])} equal")
        if differ:
            raise SystemExit(f"outputs differ from {args.against}: {differ}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
