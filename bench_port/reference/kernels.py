"""Plain PyTorch versions of the two CUDA kernels on the training path.

Frozen copies, made for the benchmark, of the plain versions the port
holds its kernels to (``ops/cuda/warp_kernel.py``, ``ops/cuda/warp_fused.py``
and ``ops/cuda/noise_kernel.py`` of the PyTorch package, and the affine
coefficients of ``ops/augment.py``). They stay here so that a later change
to the program cannot move the yardstick. Nothing of the program is
imported.

* ``warp_fused_plain``: normalise a uint8 NHWC batch (a true division by
  ``std * 255``, products taken in float64 then rounded to fp32), then
  the LDU-shear two-pass warp with its bf16 rounding points: a banded hat
  matrix applied per 32-line block, then the 25-tap residual MAC.
* ``noise_blend_plain``: Philox4x32-10 keyed by the seed, counted by
  element group and ``offset``, 24-bit uniforms, Box-Muller, then
  ``sqrt(1 - r) x + sqrt(r) eps`` in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

K = 12
TAPS = 2 * K + 1
ROWS = 32
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI = 6.283185307179586


# ------------------------------------------------------------------ warp

def affine_draws(batch: int, degrees: float, translate: float,
                 scale_min: float, scale_max: float, probability: float,
                 generator: torch.Generator, device) -> dict:
    """One step's affine draws, in the order and shapes the trainers draw
    them: angle, scale, tx, ty, each ``lo + (hi - lo) * U``, then the
    apply mask."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)

    angle = u(-degrees, degrees)
    scale = u(scale_min, scale_max)
    tx = u(-translate, translate)
    ty = u(-translate, translate)
    apply = torch.rand(batch, generator=generator,
                       device=device) < probability
    return {"angle": angle, "scale": scale, "tx": tx, "ty": ty,
            "apply": apply}


def inverse_affine_coeffs(params: dict, height: int, width: int):
    """dst -> src coefficients (cv2 convention, rotation about the centre,
    then the shift); identity where ``apply`` is False."""
    theta = torch.deg2rad(params["angle"].to(torch.float32))
    s = params["scale"].to(torch.float32)
    a, b = s * torch.cos(theta), s * torch.sin(theta)
    cx, cy = width / 2.0, height / 2.0
    fx = params["tx"].to(torch.float32) * width
    fy = params["ty"].to(torch.float32) * height
    tx_full = (1.0 - a) * cx - b * cy + fx
    ty_full = b * cx + (1.0 - a) * cy + fy
    det = a * a + b * b
    inv00 = a / det
    inv01 = -b / det
    inv10 = b / det
    inv11 = a / det
    itx = -(inv00 * tx_full + inv01 * ty_full)
    ity = -(inv10 * tx_full + inv11 * ty_full)
    apply = params["apply"].to(torch.bool)
    zero = torch.zeros_like(inv00)
    one = torch.ones_like(inv00)
    return (torch.where(apply, inv00, one), torch.where(apply, inv01, zero),
            torch.where(apply, inv10, zero), torch.where(apply, inv11, one),
            torch.where(apply, itx, zero), torch.where(apply, ity, zero))


def _band_matrix(alpha, base, n_in: int, n_win: int) -> torch.Tensor:
    dev = alpha.device
    c = n_in / 2.0
    i_idx = torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]
    o_idx = torch.arange(n_win, dtype=torch.float32, device=dev)[None, :]
    src = alpha[..., None, None] * (o_idx - float(K) + base[..., None, None]
                                    - c) + c
    return torch.clamp(1.0 - torch.abs(src - i_idx), 0.0, 1.0)


def _residual_mac(g_win: torch.Tensor, wgt: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """Each tap accumulated with one rounding (a float64 add of an exact
    fp32 product, rounded to fp32: a fused multiply-add)."""
    acc = torch.zeros(g_win.shape[:-1] + (n,), dtype=torch.float32,
                      device=g_win.device)
    g64 = g_win.to(torch.float64)
    w64 = wgt.to(torch.float64)
    for j in range(TAPS):
        acc = (acc.to(torch.float64)
               + w64[..., j:j + 1] * g64[..., j:j + n]).to(torch.float32)
    return acc


def _pass_scalars(alpha, shift, n_resample: int):
    c = n_resample / 2.0
    alpha = alpha.to(torch.float32)[:, None]
    d = (shift.to(torch.float32) - (1.0 - alpha) * c) / alpha
    b, n = d.shape
    d_blocks = d.reshape(b, n // ROWS, ROWS)
    base = torch.round(d_blocks[:, :, ROWS // 2]).to(torch.int32)
    resid = (d_blocks - base[:, :, None].to(torch.float32)).reshape(b, n)
    return base, resid


def _residual_weights(resid: torch.Tensor) -> torch.Tensor:
    taps = torch.arange(TAPS, dtype=torch.float32, device=resid.device) - K
    return torch.clamp(1.0 - torch.abs(resid[..., None] - taps), 0.0, 1.0)


def _shear_factors(coeffs, h: int, w: int):
    i00, i01, i10, i11, itx, ity = coeffs
    dev = i00.device
    alpha_x = i00 - i01 * i10 / i11
    vs = torch.arange(h, dtype=torch.float32, device=dev)
    shift_x = ((i01 / i11)[:, None] * vs[None, :]
               + (itx - i01 * ity / i11)[:, None])
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    shift_y = i10[:, None] * xs[None, :] + ity[:, None]
    return alpha_x, shift_x, i11, shift_y


def _axis_pass(img_blcn: torch.Tensor, alpha, shift) -> torch.Tensor:
    """``out[b, v, c, x] = img[b, v, c, alpha_b x + shift[b, v]]`` with
    bf16-rounded taps and band."""
    b, l, c, n = img_blcn.shape
    base, resid = _pass_scalars(alpha, shift, n)
    nb = l // ROWS
    n_win = n + 2 * K
    s = _band_matrix(alpha.to(torch.float32)[:, None],
                     base.to(torch.float32), n, n_win)
    s = s.to(torch.bfloat16).to(torch.float32)
    tile = img_blcn.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    g = torch.matmul(tile.reshape(b, nb, ROWS * c, n), s)
    g = g.reshape(b, l, c, n_win)
    return _residual_mac(g, _residual_weights(resid)[:, :, None, :], n)


def norm_constants(mean, std, channels: int) -> tuple[list, list]:
    """``mean * 255`` and ``std * 255`` per channel: float64 products
    rounded to fp32."""
    mean_l = np.asarray(mean, np.float64).reshape(-1).tolist()
    std_l = np.asarray(std, np.float64).reshape(-1).tolist()
    if len(mean_l) == 1:
        mean_l, std_l = mean_l * channels, std_l * channels
    return ([float(np.float32(m * 255.0)) for m in mean_l],
            [float(np.float32(s * 255.0)) for s in std_l])


def warp_fused_plain(images_u8: torch.Tensor, params: dict, mean, std
                     ) -> torch.Tensor:
    """Normalised, warped fp32 NHWC batch from a uint8 NHWC batch."""
    _, h, w, c = images_u8.shape
    m255, s255 = norm_constants(mean, std, c)
    dev = images_u8.device
    x = ((images_u8.to(torch.float32)
          - torch.tensor(m255, dtype=torch.float32, device=dev))
         / torch.tensor(s255, dtype=torch.float32, device=dev))
    coeffs = inverse_affine_coeffs(params, h, w)
    alpha_x, shift_x, alpha_y, shift_y = _shear_factors(coeffs, h, w)
    t = _axis_pass(x.permute(0, 1, 3, 2), alpha_x, shift_x)
    out_t = _axis_pass(t.permute(0, 3, 2, 1), alpha_y, shift_y)
    return out_t.permute(0, 3, 1, 2).contiguous()


# ----------------------------------------------------------------- noise

def _mulhilo(m: int, c: torch.Tensor):
    p_lo = m * (c & 0xFFFF)
    t = m * (c >> 16) + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def _philox(counter, key):
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def philox_normal(n: int, *, seed: int, offset: int, device
                  ) -> torch.Tensor:
    """``(n,)`` fp32 standard normals of elements ``0 .. n - 1`` of the
    stream ``(seed, offset)``: Box-Muller of each group's four uniforms."""
    groups = (n + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    offset = int(offset) & _MASK64
    seed = int(seed) & _MASK64
    zeros = torch.zeros_like(g)
    counter = (g & _MASK32, g >> 32, zeros + (offset & _MASK32),
               zeros + (offset >> 32))
    words = torch.stack(_philox(counter, (seed & _MASK32, seed >> 32)), 1)
    u = (words >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    rad = torch.sqrt(torch.log(u[:, 0::2]) * -2.0)
    theta = u[:, 1::2] * TWO_PI
    eps = torch.stack([rad * torch.cos(theta), rad * torch.sin(theta)], -1)
    return eps.reshape(-1)[:n]


def truncated_exponential(uniform: torch.Tensor, lam: float
                          ) -> torch.Tensor:
    """``log(1 / (y (1 - c) + c)) / lam``, ``c = exp(-lam)`` in fp32."""
    y = uniform.to(torch.float32)
    c = torch.exp(torch.tensor(-lam, dtype=torch.float32, device=y.device))
    return (1.0 / lam) * torch.log(1.0 / (y * (1.0 - c) + c))


def noise_blend_plain(x: torch.Tensor, ratios: torch.Tensor, *, seed: int,
                      offset: int) -> torch.Tensor:
    """``sqrt(1 - r) x + sqrt(r) eps`` of an fp32 NHWC batch, eps the
    stream ``(seed, offset)`` over the whole batch."""
    eps = philox_normal(x.numel(), seed=seed, offset=offset,
                        device=x.device).reshape(x.shape)
    r = ratios.to(torch.float32).reshape(x.shape[0], 1, 1, 1)
    return torch.sqrt(1.0 - r) * x + torch.sqrt(r) * eps
