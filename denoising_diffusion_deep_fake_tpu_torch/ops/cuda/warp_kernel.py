"""Two-pass affine warp: a CUDA kernel per 1-D resample pass.

Replaces the Pallas TPU kernel ``warp_axis_pass_pallas``
(``denoising_diffusion_deep_fake_tpu/ops/pallas/warp_kernel.py:126``) and its
caller ``affine_warp_pallas`` (``:180-208``). The kernels are
``warp_rows_kernel`` and ``warp_cols_kernel`` in ``csrc/warp.cu``; its notes
say how each is laid out on the H100 and what bounds them (memory: one read
and one write of the fp32 batch per pass, 77.1 MB and 23.0 us at 448^2 x 16,
39.3 MB and 11.7 us at 640^2 x 4, on 3.35 TB/s).

Beside them, the plain PyTorch version of the same function, written as the
TPU kernel computes it: the banded hat matrix (``band_matrix``) applied as a
bf16-valued fp32 matmul, then the 25-tap residual MAC (``residual_mac``).
It runs for CPU tensors and is the yardstick the kernels are held to on the
card; a CUDA tensor always goes to a kernel.

Layout: a pass resamples the last axis of a ``(B, L, C, N)`` view (L
lines, C channels, N positions); the kernels read and write any strides,
so the callers hand them permuted views and no transpose is materialised.
Both kernels are right for every layout. ``pass_kernel`` picks the one
laid out for the source: the row kernel where positions lie closer together
in memory than lines (the x-pass from NHWC, a contiguous ``(B, H, C, W)``
batch), the column kernel where lines do (the y-pass from the planar
intermediate).
"""

from __future__ import annotations

import ctypes

import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import (
    LAUNCHES,
    load,
)

K = 12               # residual half-width (warp_kernel.py:41)
TAPS = 2 * K + 1
ROWS = 32            # lines per block-quantisation group
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
# csrc/warp.cu warp_rows_kernel and warp_cols_kernel, as d3f_warp_pass numbers
# them.
PASS_KERNELS = ("rows", "cols")
COL_LINES = 32       # lines a column-kernel block stages (csrc/warp.cu COL_S)
COL_SEG = 224        # most outputs a column-kernel block covers (tuned)
_GROUP = 4           # channels a launch takes (csrc/warp.cu MAX_C)


def band_matrix(alpha, base, n_in: int, n_win: int) -> torch.Tensor:
    """``S[..., i, o] = hat(src(o) - i)``, ``src(o) = alpha (o - K + base -
    c) + c``, ``c = n_in / 2``; ``alpha`` and ``base`` broadcast over the
    leading dims. A source outside ``[0, n_in)`` matches no row: zero
    border."""
    dev = alpha.device
    c = n_in / 2.0
    i_idx = torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]
    o_idx = torch.arange(n_win, dtype=torch.float32, device=dev)[None, :]
    src = alpha[..., None, None] * (o_idx - float(K) + base[..., None, None]
                                    - c) + c
    return torch.clamp(1.0 - torch.abs(src - i_idx), 0.0, 1.0)


def residual_mac(g_win: torch.Tensor, wgt: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """``out[..., t] = sum_j wgt[..., j] * g_win[..., j + t]``, each tap
    accumulated with one rounding.

    The reference's ``acc + wgt * g`` is a fused multiply-add (XLA contracts
    it). The product of two fp32 values is exact in float64, so one float64
    add rounded to fp32 reproduces it; the double rounding could differ from
    a true FMA only where the float64 sum lands exactly on an fp32 tie.
    """
    acc = torch.zeros(g_win.shape[:-1] + (n,), dtype=torch.float32,
                      device=g_win.device)
    g64 = g_win.to(torch.float64)
    w64 = wgt.to(torch.float64)
    for j in range(TAPS):
        acc = (acc.to(torch.float64)
               + w64[..., j:j + 1] * g64[..., j:j + n]).to(torch.float32)
    return acc


def pass_scalars(alpha: torch.Tensor, shift: torch.Tensor, n_resample: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block integer base ``(B, L/32)`` int32 and per-line residual
    displacement ``(B, L)`` fp32 for one pass (warp_kernel.py:78-96).

    ``g[t + d] = img[alpha t + shift]`` with ``d = (shift - (1 - alpha) c)
    / alpha``; ``base`` is ``d`` at each block's centre line, rounded half
    to even (``torch.round``, like ``jnp.round``).
    """
    c = n_resample / 2.0
    alpha = alpha.to(torch.float32)[:, None]
    d = (shift.to(torch.float32) - (1.0 - alpha) * c) / alpha
    b, n = d.shape
    d_blocks = d.reshape(b, n // ROWS, ROWS)
    base = torch.round(d_blocks[:, :, ROWS // 2]).to(torch.int32)
    resid = (d_blocks - base[:, :, None].to(torch.float32)).reshape(b, n)
    return base.contiguous(), resid.contiguous()


def residual_weights(resid: torch.Tensor) -> torch.Tensor:
    """``(..., TAPS)`` hat weights of the residual taps ``-K..K``."""
    taps = torch.arange(TAPS, dtype=torch.float32, device=resid.device) - K
    return torch.clamp(1.0 - torch.abs(resid[..., None] - taps), 0.0, 1.0)


def shear_factors(coeffs, h: int, w: int):
    """LDU shear factors of the inverse affine map (augment.py:285-292):
    ``(alpha_x (B,), shift_x (B, H), alpha_y (B,), shift_y (B, W))``."""
    i00, i01, i10, i11, itx, ity = coeffs
    dev = i00.device
    alpha_x = i00 - i01 * i10 / i11
    vs = torch.arange(h, dtype=torch.float32, device=dev)
    shift_x = ((i01 / i11)[:, None] * vs[None, :]
               + (itx - i01 * ity / i11)[:, None])
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    shift_y = i10[:, None] * xs[None, :] + ity[:, None]
    return alpha_x, shift_x, i11, shift_y


def warp_axis_pass_plain(img_blcn: torch.Tensor, alpha: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[b, v, c, x] = img[b, v, c, alpha_b x +
    shift[b, v]]`` with the TPU kernel's bf16 rounding points."""
    b, l, c, n = img_blcn.shape
    base, resid = pass_scalars(alpha, shift, n)
    nb = l // ROWS
    # The window only has to cover the outputs: x + j <= (n - 1) + 2K.
    n_win = n + 2 * K
    s = band_matrix(alpha.to(torch.float32)[:, None],
                    base.to(torch.float32), n, n_win)
    s = s.to(torch.bfloat16).to(torch.float32)              # (B, nb, n, n_win)
    tile = img_blcn.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    # bf16 x bf16 products are exact in fp32 and each column of S has at
    # most two nonzeros: this fp32 matmul rounds once, as the MXU does.
    g = torch.matmul(tile.reshape(b, nb, ROWS * c, n), s)
    g = g.reshape(b, l, c, n_win)
    return residual_mac(g, residual_weights(resid)[:, :, None, :], n)


def affine_warp_twopass_plain(images: torch.Tensor, coeffs) -> torch.Tensor:
    """Plain version of the two-pass warp: fp32 NHWC out."""
    _, h, w, _ = images.shape
    alpha_x, shift_x, alpha_y, shift_y = shear_factors(coeffs, h, w)
    x = images.to(torch.float32)
    t = warp_axis_pass_plain(x.permute(0, 1, 3, 2), alpha_x, shift_x)
    out_t = warp_axis_pass_plain(t.permute(0, 3, 2, 1), alpha_y,
                                 shift_y)                     # (B, W, C, H)
    return out_t.permute(0, 3, 1, 2).contiguous()


def _warp_lib() -> ctypes.CDLL:
    lib = load("warp")
    fn = lib.d3f_warp_pass
    if fn.argtypes is None:
        i64x4 = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, i64x4, i64x4,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_scalars(b: int, lines: int, alpha: torch.Tensor,
                  base: torch.Tensor, resid: torch.Tensor) -> None:
    """The scalars of one pass over ``lines`` lines, as the kernels take
    them (``pass_scalars``)."""
    if (alpha.dtype != torch.float32 or alpha.shape != (b,)
            or not alpha.is_contiguous()):
        raise ValueError("alpha must be a contiguous float32 (B,) tensor")
    if (base.dtype != torch.int32 or base.shape != (b, lines // ROWS)
            or not base.is_contiguous()):
        raise ValueError("base must be a contiguous int32 (B, L/32) tensor")
    if (resid.dtype != torch.float32 or resid.shape != (b, lines)
            or not resid.is_contiguous()):
        raise ValueError("resid must be a contiguous float32 (B, L) tensor")


def pass_kernel(src_stride) -> str:
    """The pass kernel laid out for a ``(B, L, C, N)`` source of these
    strides: ``"rows"`` where positions lie closer together in memory than
    lines, else ``"cols"``. Either is right for any strides."""
    return "rows" if src_stride[3] < src_stride[1] else "cols"


def column_segment(n: int, most: int = COL_SEG) -> int:
    """Outputs a column-kernel block covers: the line cut into equal
    segments of at most ``most``, rounded up to an even count (a thread
    computes two consecutive outputs)."""
    k = -(-n // most)
    seg = -(-n // k)
    return seg + seg % 2


def strip_bytes(n: int, c: int, seg: int) -> int:
    """Shared memory a column-kernel block takes (csrc/warp.cu
    ``strip_rows``, ``strip_pitch``): the bf16 strip of ``COL_LINES`` lines
    of up to 4 channels, rows padded to an odd number of 32-bit words; the
    whole line for one segment, else the window of ``|alpha| <= 1.5``."""
    window = 3 * (seg + 2 * K) // 2 + 4
    rows = n if seg >= n or window >= n else window
    pitch = 2 * (((COL_LINES * min(c, _GROUP) + 1) // 2) | 1)
    return rows * pitch * 2


def check_pass_layout(shape, src_stride, dst_stride, kernel: str,
                      seg: int) -> None:
    """Raise where a pass kernel cannot take these ``(B, L, C, N)`` views;
    shapes and strides only, so it runs before anything is built."""
    b, l, c, n = shape
    if l % ROWS:
        raise ValueError(f"lines={l} must be a multiple of {ROWS}")
    if not 1 <= b < 65536 or min(l, c, n) < 1:
        raise ValueError(f"shape {tuple(shape)}: every size must be at "
                         "least 1 and the batch below 65536")
    if any(st == 0 for st, d in zip(dst_stride, shape) if d > 1):
        raise ValueError("dst overlaps itself (an expanded view): the "
                         "kernel's blocks would race on it")
    for stride in (src_stride, dst_stride):
        if sum((d - 1) * st for d, st in zip(shape[1:], stride[1:])) >= 2**31:
            raise ValueError("a sample must span fewer than 2^31 elements: "
                             "the kernels index within a sample in 32 bits")
    if kernel not in PASS_KERNELS:
        raise ValueError(f"kernel {kernel!r} is not one of {PASS_KERNELS}")
    if seg < 1:
        raise ValueError(f"seg={seg} must be at least 1")
    if kernel == "cols" and strip_bytes(n, c, seg) > SMEM_LIMIT:
        raise ValueError(f"a strip of {min(n, seg)} outputs of {n} needs "
                         f"{strip_bytes(n, c, seg)} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} a block may use")


def launch_pass(src: torch.Tensor, dst: torch.Tensor, alpha: torch.Tensor,
                base: torch.Tensor, resid: torch.Tensor, *,
                kernel: str | None = None, seg: int | None = None) -> None:
    """Launch one resample pass of ``csrc/warp.cu`` on the current stream.

    ``src`` and ``dst`` are fp32 ``(B, L, C, N)`` views of GPU tensors (any
    strides). ``kernel`` is ``"rows"`` or ``"cols"`` (default:
    ``pass_kernel`` of the source's strides); ``seg`` the outputs a
    column-kernel block covers (default: ``column_segment``).
    """
    if src.dim() != 4 or src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst "
                         f"{tuple(dst.shape)} must be one (B, L, C, N) shape")
    b, l, c, n = src.shape
    kernel = kernel or pass_kernel(src.stride())
    seg = column_segment(n) if seg is None else seg
    check_pass_layout(src.shape, src.stride(), dst.stride(), kernel, seg)
    for t in (src, dst, alpha, base, resid):
        if t.device != src.device or t.device.type != "cuda":
            raise ValueError("every operand must be on the same CUDA device")
    if src.dtype != torch.float32 or dst.dtype != torch.float32:
        raise TypeError(f"unsupported pass {src.dtype} -> {dst.dtype}: the "
                        "pass kernels take fp32 to fp32")
    check_scalars(b, l, alpha, base, resid)

    fn = _warp_lib().d3f_warp_pass
    strides = [(ctypes.c_longlong * 4)(*t.stride()) for t in (src, dst)]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(src.data_ptr(), dst.data_ptr(), b, l, c, n, strides[0],
             strides[1], alpha.data_ptr(), base.data_ptr(), resid.data_ptr(),
             PASS_KERNELS.index(kernel), seg, stream)
    if err != 0:
        raise RuntimeError(f"warp pass kernel launch failed: CUDA error "
                           f"{err}")


def warp_axis_pass(img_bhcw: torch.Tensor, alpha: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    """``out[b, v, c, x] = img[b, v, c, alpha_b x + shift[b, v]]`` on a
    ``(B, H, C, W)`` batch; fp32 out, linear interpolation, zero border."""
    b, h, c, w = img_bhcw.shape
    if h % ROWS:
        raise ValueError(f"H={h} must be a multiple of {ROWS}")
    if img_bhcw.device.type == "cpu":
        return warp_axis_pass_plain(img_bhcw, alpha, shift)
    x = img_bhcw.to(torch.float32)
    base, resid = pass_scalars(alpha, shift, w)
    out = torch.empty((b, h, c, w), dtype=torch.float32, device=x.device)
    launch_pass(x, out, alpha.to(torch.float32).contiguous(), base, resid)
    LAUNCHES["warp_axis_pass"] += 1
    return out


def affine_warp_twopass_coeffs(images: torch.Tensor, coeffs) -> torch.Tensor:
    """Per-sample affine warp of an NHWC batch from its inverse-map
    coefficients (``ops.augment._inverse_affine_coeffs``): an x-pass, then
    a y-pass on the intermediate, as ``affine_warp_pallas`` does."""
    b, h, w, c = images.shape
    if h % ROWS or w % ROWS:
        raise ValueError(f"H={h}, W={w} must be multiples of {ROWS}")
    if images.device.type == "cpu":
        return affine_warp_twopass_plain(images, coeffs).to(images.dtype)
    alpha_x, shift_x, alpha_y, shift_y = shear_factors(coeffs, h, w)
    x = images.to(torch.float32)
    base_x, resid_x = pass_scalars(alpha_x, shift_x, w)
    base_y, resid_y = pass_scalars(alpha_y, shift_y, h)
    # x-pass: NHWC seen as (B, H, C, W) -> planar (B, C, H, W) intermediate.
    t = torch.empty((b, c, h, w), dtype=torch.float32, device=x.device)
    launch_pass(x.permute(0, 1, 3, 2), t.permute(0, 2, 1, 3),
                alpha_x.contiguous(), base_x, resid_x)
    # y-pass: the intermediate seen as (B, W, C, H) -> NHWC output.
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
    launch_pass(t.permute(0, 3, 1, 2), out.permute(0, 2, 3, 1),
                alpha_y.contiguous(), base_y, resid_y)
    LAUNCHES["warp_axis_pass"] += 2
    return out.to(images.dtype)


def affine_warp_twopass(images: torch.Tensor, params: dict) -> torch.Tensor:
    """Two-pass affine warp of an NHWC batch (``affine_warp_pallas``)."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)

    _, h, w, _ = images.shape
    return affine_warp_twopass_coeffs(
        images, _inverse_affine_coeffs(params, h, w))
