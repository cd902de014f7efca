"""Variance-preserving noise blend with the noise drawn in the kernel.

Replaces the two Pallas TPU kernels of
``denoising_diffusion_deep_fake_tpu/ops/pallas/noise_kernel.py``:
``fused_normalise_noise_blend`` (``:128``; uint8 -> normalise -> blend) and
``fused_noise_blend`` (``:171``; a normalised float batch -> blend), with the
balancer's wrapper ``fused_noise_for_balance`` (``:204-211``). The kernels
are ``csrc/noise.cu``; its notes give the random stream (Philox4x32-10 keyed
by the seed, counted by element group and ``offset``; Box-Muller on 24-bit
uniforms) and what bounds them (memory).

Beside them, the plain PyTorch version of the same functions: Philox on
int64 tensors, then the same uniforms, Box-Muller and blend in fp32. It runs
for CPU tensors and is the yardstick the kernels are held to on the card; a
CUDA tensor always goes to a kernel. The plain versions also take the noise
as an argument, so a test can hand both frameworks the same numbers.

The TPU kernel's shape limits (batch a multiple of 8, H*W*C of 256) do not
carry over: any NHWC shape works, the balancer's batch of 12 included.

The stream ``offset`` is an int, or a one-element int64 tensor on the
batch's device. A CUDA tensor goes to the kernels' device-offset form, which
reads it when the kernel runs: a train step inside a CUDA graph
(``training/multi_step.py``) takes its offset from a table the graph is
replayed from, where a value passed by launch would be frozen at capture. A
CPU tensor is read as an int. Both forms draw the same words.

``element_base`` is the flat index of the batch's first element in a
larger batch (0 by default): a data-parallel rank passes ``rank * lb * H *
W * C`` and draws the noise of its own rows of the global batch, the noise
the one-process step gives them (``parallel/mesh.py``). The base need not
be a multiple of 4: the kernels and the plain versions then start inside
a Philox group.

``sample_stride`` is the row window of a spatial rank, which holds rows
``s * H/S .. (s + 1) * H/S - 1`` of each image: the batch is then ``B``
runs of ``(H/S) * W * C`` elements, sample ``b``'s first at global element
``element_base + b * sample_stride`` (``H * W * C`` of the whole image).
Each run starts at its own Philox group and lane (``W * C`` need not be a
multiple of 4). None, or the batch's own ``H * W * C``, is one run: the
launch without a window.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
    LAUNCHES,
    load,
)

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI = 6.283185307179586
_KIND = {torch.float32: 0, torch.uint8: 2}
U8_MAX_ELEMENTS = 2 ** 31 - 1  # the uint8 kernel's 32-bit indices


def noise_constants(mean, std, channels: int) -> list[float]:
    """``[mean*255 per channel] + [std*255 per channel]``, each product taken
    in fp32 as ``normalise_batch`` and the Pallas noise kernel take it
    (noise_kernel.py:145-146). The fused warp's ``norm_constants`` takes it
    in float64 instead; for a std of 0.224 the two differ by an ulp."""
    def scaled(v):
        v = np.asarray(v, np.float32).reshape(-1)
        if v.size == 1:
            v = np.repeat(v, channels)
        if v.size != channels:
            raise ValueError(f"need 1 or {channels} values, got {v.size}")
        return [float(e) for e in v * np.float32(255.0)]

    return scaled(mean) + scaled(std)


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low words of ``m * c`` for 32-bit ``m`` and ``c`` in int64:
    ``c`` is split in 16-bit halves so no partial product reaches 2^63."""
    p_lo = m * (c & 0xFFFF)
    t = m * (c >> 16) + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, key) -> list[torch.Tensor]:
    """Philox4x32-10 of the four int64 counter words (tensors or ints with
    values below 2^32) under the two key words; returns the four output
    words as int64 tensors in ``[0, 2^32)``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _key(seed: int) -> tuple[int, int]:
    seed = int(seed) & _MASK64
    return seed & _MASK32, seed >> 32


def _device_offset(offset, device: torch.device) -> torch.Tensor | None:
    """A tensor offset as the kernels read it (one int64 on ``device``),
    or None for an int."""
    if not isinstance(offset, torch.Tensor):
        return None
    if (offset.dtype != torch.int64 or offset.numel() != 1
            or offset.device != device):
        raise ValueError(f"a tensor offset must be one int64 on {device}, "
                         f"got {offset.dtype} {tuple(offset.shape)} on "
                         f"{offset.device}")
    return offset


def _host_offset(offset) -> int:
    """An int offset, or a CPU tensor's value, modulo 2^64."""
    return int(offset) & _MASK64


def philox_words_plain(n_groups: int, *, seed: int, offset, device,
                       group_base: int = 0) -> torch.Tensor:
    """``(n_groups, 4)`` int64: the words of groups ``group_base ..
    group_base + n_groups - 1``."""
    g = torch.arange(n_groups, dtype=torch.int64, device=device) + group_base
    offset = _host_offset(offset)
    zeros = torch.zeros_like(g)
    counter = (g & _MASK32, g >> 32, zeros + (offset & _MASK32),
               zeros + (offset >> 32))
    return torch.stack(philox4x32_10(counter, _key(seed)), dim=1)


def philox_words(n_groups: int, *, seed: int, offset, device,
                 group_base: int = 0) -> torch.Tensor:
    """The same words from the kernel's generator (a debug entry of
    ``csrc/noise.cu``, in the form the offset asks for) for a CUDA
    ``device``; the plain version otherwise."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_words_plain(n_groups, seed=seed, offset=offset,
                                  device=device, group_base=group_base)
    _require_cuda(device)
    out = torch.empty((n_groups, 4), dtype=torch.int32, device=device)
    lib = _noise_lib()
    at = _device_offset(offset, out.device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if at is None:
        err = lib.d3f_philox_words(out.data_ptr(), n_groups,
                                   int(seed) & _MASK64, _host_offset(offset),
                                   _base(group_base), stream)
    else:
        err = lib.d3f_philox_words_at(out.data_ptr(), n_groups,
                                      int(seed) & _MASK64, at.data_ptr(),
                                      _base(group_base), stream)
    if err != 0:
        raise RuntimeError(f"philox words kernel launch failed: CUDA error "
                           f"{err}")
    return out.to(torch.int64) & _MASK32


def uniforms_from_words(words: torch.Tensor) -> torch.Tensor:
    """``(w >> 8) * 2^-24 + 2^-25`` in fp32: in (0, 1], never 0."""
    return (words >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25


def _base(element_base: int) -> int:
    base = int(element_base)
    if base < 0:
        raise ValueError(f"element_base must be >= 0, got {base}")
    return base


def normal_plain(n: int, *, seed: int, offset, device,
                 element_base: int = 0) -> torch.Tensor:
    """``(n,)`` fp32 standard normals of elements ``element_base ..
    element_base + n - 1``: Box-Muller pairs ``sqrt(-2 ln u0) (cos 2 pi u1,
    sin 2 pi u1)`` and the same of ``(u2, u3)`` for each group of four."""
    shift = _base(element_base) % 4
    u = uniforms_from_words(philox_words_plain(
        (shift + n + 3) // 4, seed=seed, offset=offset, device=device,
        group_base=element_base // 4))
    rad = torch.sqrt(torch.log(u[:, 0::2]) * -2.0)
    theta = u[:, 1::2] * TWO_PI
    eps = torch.stack([rad * torch.cos(theta), rad * torch.sin(theta)], -1)
    return eps.reshape(-1)[shift:shift + n]


def _blend(x: torch.Tensor, eps: torch.Tensor, ratios: torch.Tensor
           ) -> torch.Tensor:
    """``sqrt(1 - r) * x + sqrt(r) * eps``, each operation rounded on its
    own (``ops.noise.blend_noise``)."""
    r = ratios.to(torch.float32).reshape(x.shape[0], 1, 1, 1)
    return torch.sqrt(1.0 - r) * x + torch.sqrt(r) * eps


def _runs(x: torch.Tensor, sample_stride: int | None) -> tuple[int, int]:
    """``(run length, run stride)`` of a launch on the NHWC ``x``: one run
    of every element, or one run a sample ``sample_stride`` apart."""
    per_sample = x[0].numel() if x.shape[0] else 0
    if sample_stride is None or sample_stride == per_sample:
        return x.numel(), 0
    if sample_stride < per_sample:
        raise ValueError(f"sample_stride {sample_stride} is below a "
                         f"sample's {per_sample} elements")
    return per_sample, int(sample_stride)


def _noise_like(x: torch.Tensor, seed: int, offset,
                noise: torch.Tensor | None,
                element_base: int = 0,
                sample_stride: int | None = None) -> torch.Tensor:
    if noise is not None:
        return noise.to(torch.float32)
    run, stride = _runs(x, sample_stride)
    if run == x.numel():
        return normal_plain(x.numel(), seed=seed, offset=offset,
                            device=x.device,
                            element_base=element_base).reshape(x.shape)
    return torch.cat([
        normal_plain(run, seed=seed, offset=offset, device=x.device,
                     element_base=element_base + j * stride)
        for j in range(x.shape[0])]).reshape(x.shape)


def fused_normalise_noise_blend_plain(batch_u8: torch.Tensor,
                                      ratios: torch.Tensor,
                                      norm: list[float], *, seed: int,
                                      offset=0,
                                      noise: torch.Tensor | None = None,
                                      element_base: int = 0,
                                      sample_stride: int | None = None
                                      ) -> torch.Tensor:
    """Plain version: normalise (a true division), then blend with
    ``noise`` or with the kernel's stream of ``(seed, offset)`` from
    element ``element_base`` on (in runs ``sample_stride`` apart)."""
    c = batch_u8.shape[-1]
    m255 = torch.tensor(norm[:c], dtype=torch.float32, device=batch_u8.device)
    s255 = torch.tensor(norm[c:], dtype=torch.float32, device=batch_u8.device)
    x = (batch_u8.to(torch.float32) - m255) / s255
    return _blend(x, _noise_like(x, seed, offset, noise, element_base,
                                 sample_stride), ratios)


def fused_noise_blend_plain(x: torch.Tensor, ratios: torch.Tensor, *,
                            seed: int, offset=0,
                            noise: torch.Tensor | None = None,
                            element_base: int = 0,
                            sample_stride: int | None = None
                            ) -> torch.Tensor:
    """Plain version of the fp32 blend."""
    return _blend(x, _noise_like(x, seed, offset, noise, element_base,
                                 sample_stride), ratios)


def _noise_lib() -> ctypes.CDLL:
    lib = load("noise")
    if lib.d3f_noise_blend.argtypes is None:
        lib.d3f_noise_blend.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_ulonglong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.d3f_noise_blend.restype = ctypes.c_int
        lib.d3f_philox_words.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
            ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
        lib.d3f_philox_words.restype = ctypes.c_int
        # The device-offset forms: the offset argument is a device pointer.
        at_args = list(lib.d3f_noise_blend.argtypes)
        at_args[9] = ctypes.c_void_p
        lib.d3f_noise_blend_at.argtypes = at_args
        lib.d3f_noise_blend_at.restype = ctypes.c_int
        lib.d3f_philox_words_at.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
        lib.d3f_philox_words_at.restype = ctypes.c_int
    return lib


def _require_cuda(*devices) -> None:
    if any(torch.device(d).type != "cuda" for d in devices):
        raise ValueError("every operand must be on one CUDA device (CPU "
                         "tensors take the plain version)")


def launch_blend(x: torch.Tensor, out: torch.Tensor, ratios: torch.Tensor,
                 norm: list[float] | None, *, seed: int, offset,
                 element_base: int = 0,
                 sample_stride: int | None = None) -> None:
    """Launch one blend of ``csrc/noise.cu`` on the current stream from
    ``x`` (uint8 with ``norm``, at most ``U8_MAX_ELEMENTS`` elements, or
    fp32 without) into the contiguous fp32 ``out`` of the same shape; an
    int ``offset`` by value, a device int64 through the kernels'
    device-offset form; ``sample_stride`` the row window (module
    docstring)."""
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC batch, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _require_cuda(x.device, ratios.device, out.device)
    if not x.device == ratios.device == out.device:
        raise ValueError("x, out and ratios must be on one CUDA device")
    kind = _KIND.get(x.dtype)
    if kind is None or (kind == 2) != (norm is not None):
        raise TypeError(f"unsupported input {x.dtype} (uint8 with mean/std, "
                        "or float32 without)")
    if kind == 2 and x.numel() > U8_MAX_ELEMENTS:
        raise ValueError(f"the uint8 kernel indexes in 32 bits: at most "
                         f"{U8_MAX_ELEMENTS} elements, got {x.numel()}")
    if (out.shape != x.shape or out.dtype != torch.float32
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 tensor of x's "
                         "shape")
    if ratios.shape != (b,):
        raise ValueError(f"ratios must have shape ({b},), got "
                         f"{tuple(ratios.shape)}")
    if norm is not None and len(norm) != 2 * c:
        raise ValueError("norm needs a mean and a std per channel")
    at = _device_offset(offset, x.device)
    run, stride = _runs(x, sample_stride)
    if b > 65535 and run < x.numel():
        raise ValueError(f"a row window launches a run a sample: at most "
                         f"65535 samples, got {b}")
    x = x.contiguous()
    r = ratios.to(torch.float32).contiguous()
    c_norm = None if norm is None else (ctypes.c_float * len(norm))(*norm)
    lib = _noise_lib()
    fn, off = ((lib.d3f_noise_blend, _host_offset(offset)) if at is None
               else (lib.d3f_noise_blend_at, at.data_ptr()))
    err = fn(kind, x.data_ptr(), out.data_ptr(), x.numel(), h * w * c, c,
             r.data_ptr(), c_norm, int(seed) & _MASK64, off,
             _base(element_base), run, stride,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"noise blend kernel launch failed: CUDA error "
                           f"{err}")


def fused_normalise_noise_blend(batch_u8: torch.Tensor, ratios: torch.Tensor,
                                mean, std, *, seed: int, offset=0,
                                element_base: int = 0,
                                sample_stride: int | None = None
                                ) -> torch.Tensor:
    """Fused ``normalise -> + noise`` over a uint8 NHWC batch.

    ``ratios``: ``(B,)`` per-sample noise ratios in [0, 1]; ``mean``/``std``
    per channel (or one value) on the 0-1 scale; ``seed`` keys the random
    stream and ``offset`` (the step) picks a disjoint part of it;
    ``element_base`` and ``sample_stride`` place the batch in a larger one
    (module docstring). Returns the fp32 noisy batch.
    """
    if batch_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {batch_u8.dtype}")
    norm = noise_constants(mean, std, batch_u8.shape[-1])
    if batch_u8.device.type == "cpu":
        return fused_normalise_noise_blend_plain(
            batch_u8, ratios, norm, seed=seed, offset=offset,
            element_base=element_base, sample_stride=sample_stride)
    out = torch.empty(batch_u8.shape, dtype=torch.float32,
                      device=batch_u8.device)
    launch_blend(batch_u8, out, ratios, norm, seed=seed, offset=offset,
                 element_base=element_base, sample_stride=sample_stride)
    LAUNCHES["fused_normalise_noise_blend"] += 1
    return out


def fused_noise_blend(x: torch.Tensor, ratios: torch.Tensor, *, seed: int,
                      offset=0, element_base: int = 0,
                      sample_stride: int | None = None) -> torch.Tensor:
    """Fused VP noise blend of a normalised fp32 NHWC batch: the noise stage
    of ``blend_random_amount_of_noise`` with the noise drawn in the kernel
    (the ratios still come from the caller)."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_noise_blend_plain(x, ratios, seed=seed, offset=offset,
                                       element_base=element_base,
                                       sample_stride=sample_stride)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    launch_blend(x, out, ratios, None, seed=seed, offset=offset,
                 element_base=element_base, sample_stride=sample_stride)
    LAUNCHES["fused_noise_blend"] += 1
    return out


def fused_noise_for_balance(batch_u8: torch.Tensor, ratio: float, mean, std,
                            seed: int, offset=0, element_base: int = 0,
                            sample_stride: int | None = None
                            ) -> torch.Tensor:
    """Balance-workload wrapper: one fixed ratio for the whole batch."""
    ratios = torch.full((batch_u8.shape[0],), ratio, dtype=torch.float32,
                        device=batch_u8.device)
    return fused_normalise_noise_blend(batch_u8, ratios, mean, std,
                                       seed=seed, offset=offset,
                                       element_base=element_base,
                                       sample_stride=sample_stride)
