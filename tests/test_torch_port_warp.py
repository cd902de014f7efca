"""Plain versions of the port's warp kernels vs the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as
tests/test_warp_fused.py runs them. Both sides get the same inverse-map
coefficients (computed by JAX), so the comparison sees only the warp: the
target, met here, is bit equality. It holds because the plain versions
round where the interpreted kernels do: bf16 tile and hat weights, an
fp32 matmul whose products are exact, and the residual MAC's
multiply-add with one rounding (XLA contracts it into an FMA).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.ops.augment import (
    _inverse_affine_coeffs,
)
from denoising_diffusion_deep_fake_tpu.ops.pallas import warp_kernel as jk
from denoising_diffusion_deep_fake_tpu.ops.pallas.warp_fused import (
    affine_warp_pallas_fused,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_fused as pf
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import warp_kernel as pk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda._build import LAUNCHES

B = 2
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _params(seed):
    rng = np.random.default_rng(seed)
    return {
        "angle": jnp.asarray(rng.uniform(-15, 15, B).astype(np.float32)),
        "scale": jnp.asarray(rng.uniform(0.8, 1.2, B).astype(np.float32)),
        "tx": jnp.asarray(rng.uniform(-0.2, 0.2, B).astype(np.float32)),
        "ty": jnp.asarray(rng.uniform(-0.2, 0.2, B).astype(np.float32)),
        "apply": jnp.ones((B,), bool),
    }


def _coeffs(params, h, w):
    return [torch.from_numpy(np.array(c))
            for c in _inverse_affine_coeffs(params, h, w)]


def test_axis_pass_plain_matches_pallas_exactly():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, 64, 3, 96)).astype(np.float32)
    alpha = rng.uniform(0.8, 1.25, B).astype(np.float32)
    shift = (rng.uniform(-10, 10, (B, 1))
             + 0.2 * np.arange(64)[None]).astype(np.float32)
    ref = np.asarray(jk.warp_axis_pass_pallas(
        jnp.asarray(img), jnp.asarray(alpha), jnp.asarray(shift),
        interpret=True))
    got = pk.warp_axis_pass(torch.from_numpy(img), torch.from_numpy(alpha),
                            torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("c", [1, 5])
def test_axis_pass_plain_matches_pallas_exactly_other_channels(c):
    rng = np.random.default_rng(10 + c)
    img = rng.standard_normal((B, 32, c, 80)).astype(np.float32)
    alpha = rng.uniform(0.8, 1.25, B).astype(np.float32)
    shift = (rng.uniform(-10, 10, (B, 1))
             + 0.2 * np.arange(32)[None]).astype(np.float32)
    ref = np.asarray(jk.warp_axis_pass_pallas(
        jnp.asarray(img), jnp.asarray(alpha), jnp.asarray(shift),
        interpret=True))
    got = pk.warp_axis_pass_plain(torch.from_numpy(img),
                                  torch.from_numpy(alpha),
                                  torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy(), ref)


def _pass_views(layout, b=1, lines=64, n=96, c=3):
    """``(src, dst)`` ``(B, L, C, N)`` views of the two-pass route's layouts
    and of a contiguous ``(B, H, C, W)`` batch."""
    if layout == "x-pass":     # NHWC source -> planar intermediate
        return (torch.zeros((b, lines, n, c)).permute(0, 1, 3, 2),
                torch.zeros((b, c, lines, n)).permute(0, 2, 1, 3))
    if layout == "y-pass":     # planar intermediate -> NHWC output
        return (torch.zeros((b, c, n, lines)).permute(0, 3, 1, 2),
                torch.zeros((b, n, lines, c)).permute(0, 2, 3, 1))
    return torch.zeros((b, lines, c, n)), torch.zeros((b, lines, c, n))


@pytest.mark.parametrize("layout,kernel", [("x-pass", "rows"),
                                           ("y-pass", "cols"),
                                           ("bhcw", "rows")])
def test_pass_kernel_is_picked_from_the_source_strides(layout, kernel):
    src, dst = _pass_views(layout)
    assert pk.pass_kernel(src.stride()) == kernel
    # Square or not, the choice follows the layout, not the sizes.
    src, dst = _pass_views(layout, lines=32, n=7)
    assert pk.pass_kernel(src.stride()) == kernel


def test_column_segments_cover_the_line_within_the_strip():
    for n in (1, 7, 64, 96, 160, 161, 448, 640, 1000, 4096):
        seg = pk.column_segment(n)
        assert seg % 2 == 0 or seg >= n
        assert -(-n // seg) * seg >= n and seg <= max(pk.COL_SEG, 2)
        assert pk.strip_bytes(n, 4, seg) <= pk.SMEM_LIMIT
    assert (pk.column_segment(448), pk.column_segment(640)) == (224, 214)


@pytest.mark.parametrize("case,match", [
    ("lines", "multiple"), ("strip", "shared memory"), ("span", "2\\^31"),
    ("kernel", "kernel")])
def test_pass_launcher_checks_raise_before_anything_is_built(case, match):
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import _build

    built = dict(_build._libs)
    src, dst = _pass_views("y-pass", lines=32, n=64)
    alpha, base = torch.ones(1), torch.zeros((1, 1), dtype=torch.int32)
    resid = torch.zeros((1, 32))
    with pytest.raises(ValueError, match=match):
        if case == "lines":
            src, dst = _pass_views("x-pass", lines=40)
            pk.launch_pass(src, dst, alpha, base, resid)
        elif case == "strip":
            # 2400 outputs in one segment: a 470,400-byte strip at C = 3.
            src, dst = _pass_views("y-pass", lines=32, n=2400)
            pk.launch_pass(src, dst, alpha, base, resid, kernel="cols",
                           seg=2400)
        elif case == "span":
            pk.check_pass_layout((1, 32, 3, 64), (0, 2 ** 27, 1, 2 ** 20),
                                 dst.stride(), "rows", 64)
        else:
            pk.launch_pass(src, dst, alpha, base, resid, kernel="diagonal")
    assert dict(_build._libs) == built


def test_pass_scalars_match_pallas():
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.8, 1.25, B).astype(np.float32)
    shift = (rng.uniform(-30, 30, (B, 1))
             + 0.3 * np.arange(96)[None]).astype(np.float32)
    base_j, wgt_j = jk.pass_scalars(jnp.asarray(alpha), jnp.asarray(shift),
                                    64)
    base_t, resid_t = pk.pass_scalars(torch.from_numpy(alpha),
                                      torch.from_numpy(shift), 64)
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(pk.residual_weights(resid_t).numpy(),
                                  np.asarray(wgt_j)[..., :pk.TAPS])
    s_j = jk.band_matrix(jnp.float32(alpha[0]), jnp.float32(3.0), 64, 128)
    s_t = pk.band_matrix(torch.tensor(alpha[0]), torch.tensor(3.0), 64, 128)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_twopass_plain_matches_pallas_exactly(hw):
    h, w = hw
    img = np.random.default_rng(2).standard_normal((B, h, w, 3)).astype(
        np.float32)
    params = _params(3)
    ref = np.asarray(jk.affine_warp_pallas(jnp.asarray(img), params,
                                           interpret=True))
    got = pk.affine_warp_twopass_coeffs(torch.from_numpy(img),
                                        _coeffs(params, h, w))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw,norm", [((64, 64), ((0.5,) * 3, (0.5,) * 3)),
                                     ((64, 64), IMAGENET),
                                     ((96, 64), IMAGENET),
                                     ((64, 96), (0.5, 0.5))])
def test_fused_plain_uint8_fold_matches_pallas_exactly(hw, norm):
    h, w = hw
    u8 = np.random.default_rng(4).integers(0, 256, (B, h, w, 3), np.uint8)
    params = _params(5)
    mean, std = norm
    ref = np.asarray(affine_warp_pallas_fused(
        jnp.asarray(u8), params, mean=mean, std=std, interpret=True))
    got = pf.affine_warp_fused_coeffs(torch.from_numpy(u8),
                                      _coeffs(params, h, w), mean=mean,
                                      std=std)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _fixed_params(rows):
    """One sample per ``(angle, scale, tx, ty)`` row."""
    cols = np.asarray(rows, np.float32).T
    return {"angle": jnp.asarray(cols[0]), "scale": jnp.asarray(cols[1]),
            "tx": jnp.asarray(cols[2]), "ty": jnp.asarray(cols[3]),
            "apply": jnp.ones((len(rows),), bool)}


# Corners of AffineAugmentConfig.random_affine (ops/augment.py:46-50), where
# sources fall off the edge and the zero border lands in normalised space,
# and the identity.
@pytest.mark.parametrize("rows", [
    [(15.0, 1.2, 0.2, 0.2), (-15.0, 0.8, -0.2, -0.2)],
    [(15.0, 0.8, -0.2, 0.2), (-15.0, 1.2, 0.2, -0.2)],
    [(0.0, 1.0, 0.0, 0.0)] * 2], ids=["corners-a", "corners-b", "identity"])
def test_fused_plain_at_fixed_params_matches_pallas_exactly(rows):
    u8 = np.random.default_rng(8).integers(0, 256, (len(rows), 64, 64, 3),
                                           np.uint8)
    params = _fixed_params(rows)
    mean, std = IMAGENET
    ref = np.asarray(affine_warp_pallas_fused(
        jnp.asarray(u8), params, mean=mean, std=std, interpret=True))
    got = pf.affine_warp_fused_coeffs(torch.from_numpy(u8),
                                      _coeffs(params, 64, 64), mean=mean,
                                      std=std)
    np.testing.assert_array_equal(got.numpy(), ref)
    # The zero border is zero after the normalise (not -mean/std, which
    # normalising after the warp would give); the identity has none.
    border = (ref == 0).all(axis=-1).mean(axis=(1, 2))
    if rows[0][0] == 0.0:
        assert (border == 0).all()
    else:
        assert (border > 0.02).all()


def test_fused_plain_float_input_from_params_matches_pallas():
    img = np.random.default_rng(6).standard_normal((B, 64, 64, 3)).astype(
        np.float32)
    params = _params(7)
    ref = np.asarray(affine_warp_pallas_fused(jnp.asarray(img), params,
                                              interpret=True))
    got = pf.affine_warp_fused(torch.from_numpy(img), {
        k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    # Coefficients computed by each framework: cos/sin may differ by an
    # ulp, which can flip the bf16 rounding of a hat weight or of the
    # intermediate in rare elements (one bf16 step of a value <= ~4).
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 2.0 ** -6 and (diff > 0).mean() < 1e-2


def test_cpu_wrappers_do_not_count_launches():
    before = dict(LAUNCHES)
    u8 = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    params = {"angle": torch.zeros(1), "scale": torch.ones(1),
              "tx": torch.zeros(1), "ty": torch.zeros(1),
              "apply": torch.ones(1, dtype=torch.bool)}
    pf.affine_warp_fused(u8, params, mean=0.5, std=0.5)
    pk.affine_warp_twopass(u8.float(), params)
    assert dict(LAUNCHES) == before


def test_launcher_rejects_an_overlapping_output():
    src = torch.zeros((1, 32, 3, 64))
    dst = torch.empty((1, 32, 3, 1)).expand(1, 32, 3, 64)
    base = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="overlaps"):
        pk.launch_pass(src, dst, torch.ones(1), base, torch.zeros((1, 32)))


def test_wrappers_reject_unaligned_shapes():
    params = {"angle": torch.zeros(1), "scale": torch.ones(1),
              "tx": torch.zeros(1), "ty": torch.zeros(1),
              "apply": torch.ones(1, dtype=torch.bool)}
    with pytest.raises(ValueError, match="multiples"):
        pf.affine_warp_fused(torch.zeros((1, 64, 40, 3)), params)
    with pytest.raises(ValueError, match="multiples"):
        pk.affine_warp_twopass(torch.zeros((1, 40, 64, 3)), params)


def test_fused_wrapper_checks_raise_before_any_launch():
    before = dict(LAUNCHES)
    params = {"angle": torch.zeros(1), "scale": torch.ones(1),
              "tx": torch.zeros(1), "ty": torch.zeros(1),
              "apply": torch.ones(1, dtype=torch.bool)}
    with pytest.raises(ValueError, match="channels"):
        pf.affine_warp_fused(torch.zeros((1, 32, 32, 5), dtype=torch.uint8),
                             params, mean=0.5, std=0.5)
    with pytest.raises(ValueError, match="shared memory"):
        pf.affine_warp_fused(torch.zeros((1, 1184, 32, 3),
                                         dtype=torch.uint8), params)
    assert pf.strip_bytes(448, 3, torch.uint8) == 448 * 196 + 3 * 1024
    # The launcher refuses tensors that do not lie on a CUDA device.
    x = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    alpha = torch.ones(1)
    base = torch.zeros((1, 1), dtype=torch.int32)
    resid = torch.zeros((1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        pf.launch_fused(x, torch.empty(x.shape), alpha, base, resid, alpha,
                        base, resid, None)
    assert dict(LAUNCHES) == before
