"""The port's noise kernels (plain versions, on the CPU) vs the JAX package.

* Philox4x32-10: Random123's known-answer vectors, exactly.
* Ratio 0: the port equals the interpreted Pallas kernels exactly (the
  normalisation for the uint8 kernel, the identity for the fp32 one). Only
  ratio 0 is deterministic there: the interpreter stubs the TPU's random
  bits.
* With the same numpy noise handed to both, the port's blend equals the JAX
  ``blend_noise(normalise_batch(u8), eps, r)`` within 1e-6 absolute: XLA on
  the CPU may contract the blend's multiply and add into one fused
  multiply-add, which rounds once where PyTorch rounds twice.
* The drawn noise: standard-normal moments, bounded by the smallest uniform
  (``sqrt(-2 ln 2^-25)`` < 5.9), uncorrelated between samples, a function
  of (seed, offset, element index) alone, on any NHWC shape, including
  those the TPU kernel refuses.
* The denoiser's train step draws its noise from that stream at offset
  ``state.step``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.ops.augment import (
    normalise_batch as jax_normalise,
)
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu.ops.pallas import noise_kernel as pnk
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import noise_kernel as nk

HALF = ((0.5,) * 3, (0.5,) * 3)
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    assert tuple(int(w) for w in nk.philox4x32_10(counter, key)) == want
    # The same words through int64 tensors, and through the stream's
    # packing of (group, offset) and seed into counter and key.
    tensors = [torch.tensor([c], dtype=torch.int64) for c in counter]
    assert tuple(int(w) for w in nk.philox4x32_10(tensors, key)) == want
    if counter[:2] == (0, 0):
        words = nk.philox_words_plain(
            1, seed=key[0] | key[1] << 32,
            offset=counter[2] | counter[3] << 32, device="cpu")
        assert tuple(words[0].tolist()) == want


@pytest.mark.parametrize("case", ["u8-half", "u8-imagenet", "f32"])
def test_zero_ratio_matches_the_interpreted_pallas_kernel(case):
    rng = np.random.default_rng(1)
    if case == "f32":
        x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
        want = np.asarray(pnk.fused_noise_blend(
            jnp.asarray(x), jnp.zeros(8), seed=0, interpret=True))
        got = nk.fused_noise_blend(torch.from_numpy(x), torch.zeros(8),
                                   seed=3, offset=9).numpy()
        np.testing.assert_array_equal(got, x)
    else:
        mean, std = HALF if case == "u8-half" else IMAGENET
        u8 = rng.integers(0, 256, (8, 16, 16, 3), np.uint8)
        want = np.asarray(pnk.fused_normalise_noise_blend(
            jnp.asarray(u8), jnp.zeros(8), mean, std, seed=0,
            interpret=True))
        got = nk.fused_normalise_noise_blend(
            torch.from_numpy(u8), torch.zeros(8), mean, std, seed=3,
            offset=9).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_normalise(jnp.asarray(u8), mean, std)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("r", [0.3, 0.7, 1.0])
def test_blend_with_injected_noise_matches_jax(kind, r):
    rng = np.random.default_rng(2)
    b = 3
    u8 = rng.integers(0, 256, (b, 10, 12, 3), np.uint8)
    eps = rng.standard_normal(u8.shape).astype(np.float32)
    ratios = np.full(b, r, np.float32)
    image = jax_normalise(jnp.asarray(u8), *IMAGENET)
    want = np.asarray(blend_noise(image, jnp.asarray(eps),
                                  jnp.asarray(ratios).reshape(b, 1, 1, 1)))
    if kind == "u8":
        got = nk.fused_normalise_noise_blend_plain(
            torch.from_numpy(u8), torch.from_numpy(ratios),
            nk.noise_constants(*IMAGENET, 3), seed=0,
            noise=torch.from_numpy(eps))
    else:
        got = nk.fused_noise_blend_plain(
            torch.from_numpy(np.array(image)), torch.from_numpy(ratios),
            seed=0, noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_drawn_noise_statistics_and_determinism():
    u8 = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (12, 64, 64, 3), np.uint8))
    ones = torch.ones(12)

    def draw(seed, offset):
        return nk.fused_normalise_noise_blend(u8, ones, *HALF, seed=seed,
                                              offset=offset)

    eps = draw(7, 11)
    n = eps.numel()
    # 147,456 draws: the mean's standard error is 0.0026, the variance's
    # 0.0037, a correlation's over 12,288 pairs 0.009; limits at ~6 of them.
    assert abs(float(eps.mean())) < 0.015
    assert abs(float(eps.var()) - 1.0) < 0.02
    assert float(eps.abs().max()) <= 5.9
    corr = np.corrcoef(eps[0].reshape(-1).numpy(),
                       eps[1].reshape(-1).numpy())[0, 1]
    assert abs(corr) < 0.05
    assert torch.equal(eps, draw(7, 11))
    assert torch.equal(eps.reshape(-1),
                       nk.normal_plain(n, seed=7, offset=11, device="cpu"))
    for other in (draw(7, 12), draw(8, 11)):
        assert float((other != eps).float().mean()) > 0.99


@pytest.mark.parametrize("shape", [(12, 8, 8, 3), (3, 8, 8, 3),
                                   (3, 5, 7, 3), (2, 3, 3, 1), (1, 1, 1, 1)])
def test_any_shape_draws_the_same_stream(shape):
    """Shapes the TPU kernel refuses (B % 8, H*W*C % 256, here also
    H*W*C % 4): ratio 0 is the normalisation, ratio 1 the stream's first
    numel() values, a prefix of any longer draw."""
    b, c = shape[0], shape[-1]
    u8 = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, shape, np.uint8))
    mean, std = (0.5,) * c, (0.25,) * c
    got0 = nk.fused_normalise_noise_blend(u8, torch.zeros(b), mean, std,
                                          seed=5, offset=1)
    want0 = np.asarray(jax_normalise(jnp.asarray(u8.numpy()), mean, std))
    np.testing.assert_array_equal(got0.numpy(), want0)
    x = torch.zeros(shape)
    got1 = nk.fused_noise_blend(x, torch.ones(b), seed=5, offset=1)
    longer = nk.normal_plain(u8.numel() + 37, seed=5, offset=1, device="cpu")
    assert torch.equal(got1.reshape(-1), longer[:u8.numel()])


def test_per_sample_ratios_and_the_balance_wrapper():
    u8 = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 4, 4, 3), np.uint8))
    ratios = torch.tensor([0.0, 0.7, 0.7])
    mixed = nk.fused_normalise_noise_blend(u8, ratios, *HALF, seed=2,
                                           offset=4)
    fixed = nk.fused_noise_for_balance(u8, 0.7, *HALF, 2, offset=4)
    assert torch.equal(mixed[1:], fixed[1:])
    assert torch.equal(mixed[0], (u8[0].float() - 127.5) / 127.5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        nk.fused_noise_blend(torch.zeros((1, 2, 2, 3), dtype=torch.float64),
                             torch.zeros(1), seed=0)
    with pytest.raises(TypeError):
        nk.fused_normalise_noise_blend(torch.zeros((1, 2, 2, 3)),
                                       torch.zeros(1), 0.5, 0.5, seed=0)
    # A tensor that is not on the CPU never reaches the plain version.
    with pytest.raises(ValueError, match="CUDA"):
        nk.fused_noise_blend(torch.empty((1, 2, 2, 3), device="meta"),
                             torch.zeros(1, device="meta"), seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        nk.fused_normalise_noise_blend(
            torch.empty((1, 2, 2, 3), dtype=torch.uint8, device="meta"),
            torch.zeros(1, device="meta"), 0.5, 0.5, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        nk.philox_words(4, seed=0, offset=0, device="meta")


def test_denoiser_noise_stage_draws_the_kernel_stream():
    from denoising_diffusion_deep_fake_tpu_torch.config import (
        DenoiserConfig, config_from_dict)
    from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
        DenoiserTrainer)

    b, s = 2, 32
    cfg = config_from_dict(DenoiserConfig, dict(
        input_image_list_path="unused", batch_size=b, encoder_name="resnet18",
        compute_dtype="float32", warp_method="gather", seed=13))
    rng = np.random.default_rng(6)
    u8 = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    params = {"angle": torch.tensor([3.0, -7.0]),
              "scale": torch.tensor([1.1, 0.9]),
              "tx": torch.tensor([0.05, -0.1]),
              "ty": torch.tensor([0.0, 0.1]),
              "apply": torch.ones(b, dtype=torch.bool)}
    ratios = torch.tensor([0.2, 0.6])
    losses = []
    for noise in (None, nk.normal_plain(b * s * s * 3, seed=13, offset=0,
                                        device="cpu").reshape(b, s, s, 3)):
        trainer = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=s,
                                  device="cpu")
        state = trainer.init_state(seed=0)
        losses.append(float(trainer.train_step(
            state, u8, affine_params=params, ratios=ratios,
            noise=noise)["loss"]))
    assert losses[0] == losses[1]
