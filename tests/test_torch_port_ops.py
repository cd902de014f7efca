"""PyTorch port vs the JAX package: noise, affine maths, gather warp, SSIM
and the loss (value and gradient).

The same inputs, made with numpy from a seed, go through both frameworks on
the CPU. Tolerances and their causes:

* exact where both sides do the same IEEE fp32 operations (sqrt-free blend
  arithmetic, the gather warp, normalise);
* rtol 1e-6 where a transcendental (exp, log, cos, sin) is evaluated: XLA's
  and PyTorch's CPU math libraries differ by up to one ulp;
* 1e-6 absolute on SSIM and the loss, 1e-6 relative to the largest element
  on their gradients: the blur sums are taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.ops import augment as jaug
from denoising_diffusion_deep_fake_tpu.ops import losses as jlosses
from denoising_diffusion_deep_fake_tpu.ops import noise as jnoise
from denoising_diffusion_deep_fake_tpu.ops.ssim import ssim as jax_ssim
from denoising_diffusion_deep_fake_tpu_torch.ops import augment as taug
from denoising_diffusion_deep_fake_tpu_torch.ops import losses as tlosses
from denoising_diffusion_deep_fake_tpu_torch.ops import noise as tnoise
from denoising_diffusion_deep_fake_tpu_torch.ops import ssim as tssim

B, S = 2, 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _affine_params(rng, b=B, apply=None):
    return {
        "angle": rng.uniform(-15, 15, b).astype(np.float32),
        "scale": rng.uniform(0.8, 1.2, b).astype(np.float32),
        "tx": rng.uniform(-0.2, 0.2, b).astype(np.float32),
        "ty": rng.uniform(-0.2, 0.2, b).astype(np.float32),
        "apply": np.ones(b, bool) if apply is None else np.asarray(apply),
    }


@pytest.mark.parametrize("lam", [1.0, 5.0])
def test_truncated_exponential_matches_jax(lam):
    y = np.random.default_rng(0).uniform(0, 1, (64, 1, 1, 1)).astype(
        np.float32)
    key = jax.random.PRNGKey(0)
    # The JAX sampler draws its own uniforms; feed it the same ones.
    ref = jax.jit(lambda u: (1.0 / lam) * jnp.log(
        1.0 / (u * (1.0 - jnp.exp(jnp.float32(-lam))) + jnp.exp(
            jnp.float32(-lam)))))(jnp.asarray(y))
    got = tnoise.sample_truncated_exponential(y.shape, lam, uniform=_t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    # The JAX function's own draws land in the same range.
    r = np.asarray(jnoise.sample_truncated_exponential(key, (256,), lam))
    assert r.min() >= 0.0 and r.max() < 1.0


def test_blend_noise_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    r = rng.uniform(0, 1, (B, 1, 1, 1)).astype(np.float32)
    ref = np.asarray(jnoise.blend_noise(jnp.asarray(x), jnp.asarray(eps),
                                        jnp.asarray(r)))
    got = tnoise.blend_noise(_t(x), _t(eps), _t(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_blend_random_and_fixed_amount_with_injected_draws():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    u = rng.uniform(0, 1, B).astype(np.float32)
    noisy, r = tnoise.blend_random_amount_of_noise(
        _t(x), 5.0, uniform=_t(u), noise=_t(eps))
    assert r.shape == (B, 1, 1, 1)
    want_r = tnoise.sample_truncated_exponential((B, 1, 1, 1), 5.0,
                                                 uniform=_t(u).reshape(
                                                     B, 1, 1, 1))
    torch.testing.assert_close(r, want_r, rtol=0, atol=0)
    ref = np.asarray(jnoise.blend_noise(jnp.asarray(x), jnp.asarray(eps),
                                        jnp.asarray(r.numpy())))
    np.testing.assert_allclose(noisy.numpy(), ref, rtol=1e-6, atol=1e-6)
    fixed = tnoise.blend_fixed_amount_of_noise(_t(x), 0.7, noise=_t(eps))
    ref_fixed = np.asarray(jnoise.blend_noise(
        jnp.asarray(x), jnp.asarray(eps), jnp.full((B, 1, 1, 1), 0.7)))
    np.testing.assert_allclose(fixed.numpy(), ref_fixed, rtol=1e-6,
                               atol=1e-6)
    # Drawn from a generator: shape and the variance-preserving moments.
    gen = torch.Generator().manual_seed(0)
    big = torch.zeros(4, 64, 64, 3)
    noisy, r = tnoise.blend_random_amount_of_noise(big, 5.0, generator=gen)
    std = noisy.std(dim=(1, 2, 3))
    torch.testing.assert_close(std, r.reshape(-1).sqrt(), rtol=0.05,
                               atol=0.01)


@pytest.mark.parametrize("apply", [(True, True), (True, False)])
def test_inverse_affine_coeffs_match_jax(apply):
    p = _affine_params(np.random.default_rng(3), apply=apply)
    ref = jaug._inverse_affine_coeffs({k: jnp.asarray(v) for k, v in
                                       p.items()}, 64, 96)
    got = taug._inverse_affine_coeffs({k: _t(v) for k, v in p.items()},
                                      64, 96)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(S, S), (40, 56)])
def test_gather_warp_matches_jax(shape):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((B,) + shape + (3,)).astype(np.float32)
    p = _affine_params(rng)
    ref = np.asarray(jaug.affine_warp(jnp.asarray(img), {
        k: jnp.asarray(v) for k, v in p.items()}))
    got = taug.affine_warp(_t(img), {k: _t(v) for k, v in p.items()})
    # Coefficients go through cos/sin (an ulp apart at most); the bilinear
    # weights inherit that.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_normalise_batch_matches_jax_exactly():
    u8 = np.random.default_rng(5).integers(0, 256, (B, 8, 8, 3), np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = np.asarray(jaug.normalise_batch(jnp.asarray(u8), mean, std))
    got = taug.normalise_batch(_t(u8), mean, std).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,method", [
    ((448, 448), "pallas_fused"), ((384, 512), "pallas_fused"),
    ((640, 640), "pallas"), ((64, 64), "hybrid"), ((256, 256), "hybrid"),
    ((60, 64), "shear"), ((448, 440), "gather")])
def test_select_warp_method(hw, method):
    cfg = taug.AffineAugmentConfig.random_affine()
    assert taug.select_warp_method(*hw, cfg) == method


def test_augment_batch_routes_on_cpu():
    u8 = _t(np.random.default_rng(6).integers(0, 256, (B, S, S, 3),
                                               np.uint8))
    cfg = taug.AffineAugmentConfig.random_affine()
    gen = torch.Generator().manual_seed(0)
    params = taug.sample_affine_params(B, cfg, generator=gen)
    outs = {m: taug.augment_batch(u8, (0.5,) * 3, (0.5,) * 3, cfg,
                                  params=params, method=m)
            for m in ("pallas", "pallas_fused", "gather")}
    for out in outs.values():
        assert out.shape == u8.shape and out.dtype == torch.float32
        assert torch.isfinite(out).all()
    # The fused warp is bit-equal to normalise -> two-pass warp.
    torch.testing.assert_close(outs["pallas_fused"], outs["pallas"], rtol=0,
                               atol=0)
    # The XLA layouts of the same warp, ported as plain PyTorch: another
    # resampling of the same map (tests/test_torch_port_warp.py holds
    # them to JAX's).
    for method in ("shear", "hybrid"):
        out = taug.augment_batch(u8, (0.5,) * 3, (0.5,) * 3, cfg,
                                 params=params, method=method)
        assert out.shape == u8.shape and out.dtype == torch.float32
        assert torch.isfinite(out).all(), method


def _image_pair(seed, shape=(B, S, S, 3)):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(shape), -1, 1).astype(
        np.float32)
    return x, y


def test_ssim_matches_jax():
    x, y = _image_pair(7)
    x01, y01 = (x + 1) / 2, (y + 1) / 2
    ref = np.asarray(jax_ssim(jnp.asarray(x01), jnp.asarray(y01),
                             reduce_batch=False))
    got = tssim.ssim(_t(x01), _t(y01), reduce_batch=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    one = tssim.ssim(_t(x01), _t(x01))
    assert abs(float(one) - 1.0) < 1e-6


def test_mse_ssim_loss_value_and_grad_match_jax():
    x, y = _image_pair(8)
    ref_loss, ref_grad = jax.value_and_grad(jlosses.mse_ssim_loss)(
        jnp.asarray(x), jnp.asarray(y))
    xt = _t(x).requires_grad_(True)
    loss = tlosses.mse_ssim_loss(xt, _t(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) < 1e-6
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(xt.grad.numpy(), ref_grad, rtol=0,
                               atol=1e-6 * np.abs(ref_grad).max())
    mse = tlosses.mse_loss(_t(x), _t(y))
    np.testing.assert_allclose(float(mse), float(jlosses.mse_loss(
        jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
