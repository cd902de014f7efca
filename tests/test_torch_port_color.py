"""The port's color jitter (``ops/color.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through each JAX op and its
port. Tolerances:

* each ``adjust_*`` op alone and the HSV round trip: 2e-6 absolute on
  [0, 1]. XLA on the CPU may contract a multiply and an add into one
  rounding, and ``%`` is ``jnp.remainder`` against ``torch.remainder``;
  both move a value by an ulp or two of 1.0;
* the whole chain and ``color_jitter_normalised``: 1e-5 absolute, except
  where the chain's earlier ops leave a pixel's largest channels a tie
  apart by an ulp, so the two frameworks pick another hue sector: such a
  pixel may differ by up to the hue shift's size. Their share is held
  under 1e-3 of the values, and the test states it;
* one jitter-on denoiser step from the same weights with the same affine,
  jitter, ratio and noise numbers, the U-Net in float64 on both sides
  between the fp32 warp, jitter and noise and the fp32 loss (as
  ``tests/test_torch_port_efficientnet.py`` composes its step): the loss
  and the new BN running statistics within 1e-4 relative, every gradient
  within 1e-4 of its tensor's largest magnitude (the step test's bounds,
  ``tests/test_torch_port_step.py``). In fp32 the two frameworks'
  gradients differ by 0.4-7% of a tensor's largest at every point tried
  (a decoder BN's bias gradient is a sum that nearly cancels, so the
  order of fp32 sums shows); in float64 they agree to 8e-6 at this point
  (seeds 21-23), which was searched as that file's was: at seed 31 a
  sample coordinate of the gather warp lands on an integer, XLA contracts
  its multiply-add and takes another tap, and the gradients part by
  0.6%.

The sampling rules follow ``tests/test_color.py``: factor ranges, the
identity for disabled ops (drawing nothing), the ``apply`` probability.
64^2 or smaller, batch <= 4, resnet18, torch on one thread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.ops import color as jc
from denoising_diffusion_deep_fake_tpu.ops.augment import (
    affine_warp as jax_affine_warp,
    normalise_batch as jax_normalise_batch,
)
from denoising_diffusion_deep_fake_tpu.ops.losses import mse_ssim_loss
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.ops import augment as taug
from denoising_diffusion_deep_fake_tpu_torch.ops import color as tc
from denoising_diffusion_deep_fake_tpu_torch.ops.image import panel_grid_u8
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

from test_torch_port_model import random_flax_variables

STRONG = (0.5, 0.4, 0.6, 0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, b=3, size=16):
    x = np.random.default_rng(seed).random((b, size, size, 3)).astype(
        np.float32)
    x[0, :2] = 0.5          # gray pixels: no hue, saturation 0
    x[1, 0, :3] = 0.0       # black pixels: maxc 0
    x[2, 0, 0] = (0.9, 0.9, 0.1)   # ties between the largest channels
    x[2, 0, 1] = (0.2, 0.7, 0.7)
    return x


def _factors(seed, b=3, hue=0.5):
    rng = np.random.default_rng(seed)
    return {"brightness": rng.uniform(0.3, 1.7, b).astype(np.float32),
            "contrast": rng.uniform(0.3, 1.7, b).astype(np.float32),
            "saturation": rng.uniform(0.0, 2.0, b).astype(np.float32),
            "hue": rng.uniform(-hue, hue, b).astype(np.float32),
            "apply": np.array([True, False, True][:b])}


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch(params):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast",
                                "adjust_saturation", "adjust_hue"])
def test_each_op_matches_jax(op):
    x = _img(1)
    f = _factors(2)[{"adjust_brightness": "brightness",
                     "adjust_contrast": "contrast",
                     "adjust_saturation": "saturation",
                     "adjust_hue": "hue"}[op]]
    want = np.asarray(jax.jit(getattr(jc, op))(jnp.asarray(x),
                                               jnp.asarray(f)))
    got = getattr(tc, op)(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_hsv_round_trip_matches_jax():
    x = _img(3)
    jh = jax.jit(jc._rgb_to_hsv)(jnp.asarray(x))
    th = tc._rgb_to_hsv(torch.from_numpy(x))
    for got, want in zip(th, jh):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)
    # Hues past [0, 1) and negative ones: the floor-mod of both sides.
    h = np.linspace(-1.7, 2.3, 3 * 16 * 16, dtype=np.float32).reshape(
        3, 16, 16)
    s, v = (np.array(t) for t in jh[1:])
    want = np.asarray(jax.jit(jc._hsv_to_rgb)(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(v)))
    got = tc._hsv_to_rgb(torch.from_numpy(h), torch.from_numpy(s),
                         torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _sector_flips(got, want, atol):
    """The share of values beyond ``atol`` and their largest difference."""
    diff = np.abs(got - want)
    return float((diff > atol).mean()), float(diff.max())


@pytest.mark.parametrize("seed", [4, 5])
def test_chain_matches_jax(seed):
    x = _img(seed, b=3, size=32)
    params = _factors(seed + 10)
    want = np.asarray(jax.jit(jc.color_jitter)(jnp.asarray(x),
                                               _jax(params)))
    got = tc.color_jitter(torch.from_numpy(x), _torch(params)).numpy()
    share, worst = _sector_flips(got, want, 1e-5)
    assert share < 1e-3, (share, worst)
    assert worst <= 2 * abs(params["hue"]).max() + 1e-5
    # Samples with apply False pass through bit for bit.
    np.testing.assert_array_equal(got[1], x[1])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_normalised_matches_jax_and_keeps_dtype(dtype):
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    x01 = _img(6, b=3, size=32)
    x = ((x01 - np.array(mean)) / np.array(std)).astype(np.float32)
    params = _factors(7)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jax.jit(jc.color_jitter_normalised, static_argnums=(2, 3))(
        jx, _jax(params), mean, std)
    got = tc.color_jitter_normalised(tx, _torch(params), mean, std)
    assert got.dtype == tx.dtype
    want = np.asarray(want.astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    # bf16 output: one bf16 ulp of the values (|x| < 4) where fp32 rounds
    # to the other side of a bf16 boundary.
    atol = 1e-5 if dtype == np.float32 else 2 ** -6
    share, worst = _sector_flips(got, want, atol)
    assert share < 1e-3, (share, worst)


def test_identity_factors_round_trip():
    x01 = _img(8)
    x = torch.from_numpy((x01 - 0.5) / 0.5)
    params = {"brightness": torch.ones(3), "contrast": torch.ones(3),
              "saturation": torch.ones(3), "hue": torch.zeros(3),
              "apply": torch.ones(3, dtype=torch.bool)}
    out = tc.color_jitter_normalised(x, params, [0.5] * 3, [0.5] * 3)
    torch.testing.assert_close(out, x, rtol=0, atol=1e-5)


def test_factor_ranges_and_apply_probability():
    cfg = tc.ColorJitterConfig(brightness=0.4, contrast=0.3, saturation=2.0,
                               hue=0.25, probability=0.5)
    p = tc.sample_color_jitter_params(torch.Generator().manual_seed(0),
                                      2000, cfg)
    assert 0.6 <= p["brightness"].min() and p["brightness"].max() <= 1.4
    assert 0.7 <= p["contrast"].min() and p["contrast"].max() <= 1.3
    # saturation strength 2.0: the lower bound clamps at 0.
    assert 0.0 <= p["saturation"].min() and p["saturation"].max() <= 3.0
    assert p["hue"].abs().max() <= 0.25
    assert 0.4 < p["apply"].float().mean() < 0.6
    assert all(v.shape == (2000,) for v in p.values())


def test_disabled_ops_take_identity_and_draw_nothing():
    gen = torch.Generator().manual_seed(1)
    p = tc.sample_color_jitter_params(gen, 16,
                                      tc.ColorJitterConfig(brightness=0.5))
    assert torch.equal(p["contrast"], torch.ones(16))
    assert torch.equal(p["saturation"], torch.ones(16))
    assert torch.equal(p["hue"], torch.zeros(16))
    # Two draws only: the brightness factor and apply.
    ref = torch.Generator().manual_seed(1)
    torch.rand(16, generator=ref)
    torch.rand(16, generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("jitter,p,match", [
    ((0.1, 0.1, 0.1, 0.7), 1.0, "hue"),
    ((-0.1, 0.0, 0.0, 0.0), 1.0, "brightness"),
    ((0.0, 0.0, 0.0, 0.0), 1.5, "probability")])
def test_config_validates_ranges_with_jax_messages(jitter, p, match):
    data = dict(input_image_list_path="x", color_jitter=jitter,
                color_jitter_p=p)
    from denoising_diffusion_deep_fake_tpu.config import (
        DenoiserConfig as JaxDenoiserConfig, config_from_dict as jax_cfg)

    with pytest.raises(ValueError, match=match) as jax_err:
        jax_cfg(JaxDenoiserConfig, data)
    with pytest.raises(ValueError, match=match) as port_err:
        port_config.config_from_dict(port_config.DenoiserConfig, data)
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------- a jitter-on train step

S, B, LR = 64, 2, 0.02
MEAN = STD = (0.5, 0.5, 0.5)


def test_jitter_on_denoiser_step_matches_jax():
    rng = np.random.default_rng(21)
    u8 = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    affine = {"angle": rng.uniform(-15, 15, B).astype(np.float32),
              "scale": rng.uniform(0.8, 1.2, B).astype(np.float32),
              "tx": rng.uniform(-0.2, 0.2, B).astype(np.float32),
              "ty": rng.uniform(-0.2, 0.2, B).astype(np.float32),
              "apply": np.ones(B, bool)}
    jitter = _factors(22, b=B, hue=0.05)
    jitter["apply"] = np.array([True, False])
    ratios = rng.uniform(0.0, 0.6, B).astype(np.float32)
    noise = rng.standard_normal((B, S, S, 3)).astype(np.float32)

    variables = random_flax_variables(jax_unet("resnet18"), S, seed=23)
    head = variables["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1  # predictions inside (-1, 1)
    image = jax_affine_warp(jax_normalise_batch(jnp.asarray(u8), MEAN, STD),
                            _jax(affine))
    image = jc.color_jitter_normalised(image, _jax(jitter), MEAN, STD)
    noisy = blend_noise(image, jnp.asarray(noise),
                        jnp.asarray(ratios).reshape(B, 1, 1, 1))

    with jax.enable_x64(True):
        model = jax_unet("resnet18", dtype=jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])

        def loss_fn(p):
            pred, mutated = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                noisy, train=True, mutable=["batch_stats"])
            return mse_ssim_loss(pred, image), mutated["batch_stats"]

        (loss, new_bs), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        grads = jax.tree.map(np.asarray, grads)

    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=B, learning_rate=LR,
        encoder_name="resnet18", compute_dtype="float32", mean=MEAN,
        std=STD, warp_method="gather", color_jitter=(0.3, 0.3, 0.3, 0.05)))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=10, image_size=S,
                              device="cpu")
    state = trainer.init_state(seed=0)
    state.model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    state.model.double().dtype = torch.float64
    before = trainer.generator.get_state()
    metrics = trainer.train_step(
        state, torch.from_numpy(u8), affine_params=_torch(affine),
        jitter_params=_torch(jitter), ratios=torch.from_numpy(ratios),
        noise=torch.from_numpy(noise))
    assert torch.equal(trainer.generator.get_state(), before)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-4)
    want = state_dict_from_jax({}, new_bs)
    got = state.model.state_dict()
    assert want
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    want = state_dict_from_jax(grads, {})
    params = dict(state.model.named_parameters())
    assert set(want) == set(params)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(params[name].grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_jitter_draws_only_when_on_and_after_the_warp():
    """With the jitter on, the denoiser draws the affine params, then the
    jitter factors, then the ratios from its generator; off, no draw
    moves (the K-step graphs and bit-equality tests stand)."""
    u8 = torch.from_numpy(np.random.default_rng(24).integers(
        0, 256, (B, 32, 32, 3), np.uint8))
    gens = {}
    for name, jitter in (("off", (0.0,) * 4), ("on", STRONG)):
        cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
            input_image_list_path="x", batch_size=B, encoder_name="resnet18",
            compute_dtype="float32", color_jitter=jitter))
        trainer = DenoiserTrainer(cfg, steps_per_epoch=1, image_size=32,
                                  device="cpu")
        trainer.train_step(trainer.init_state(seed=0), u8)
        gens[name] = trainer.generator.get_state()
    cfg = taug.AffineAugmentConfig.random_affine()
    for name, jitter in (("off", None), ("on", STRONG)):
        ref = torch.Generator().manual_seed(0)
        taug.sample_affine_params(B, cfg, generator=ref)
        if jitter is not None:
            tc.sample_color_jitter_params(ref, B,
                                          tc.ColorJitterConfig(*jitter))
        torch.rand(B, generator=ref)  # the ratios
        assert torch.equal(gens[name], ref.get_state()), name


def test_deep_fake_jitters_each_identity_with_its_own_stats():
    """Swap mode: the real panels are each identity's warp jittered with
    its own mean and std; the fakes come from the shadows."""
    stats = {"a": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
             "b": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))}
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        data_path_a="a", data_path_b="b", batch_size=B, mode="swap",
        encoder_name="resnet18", compute_dtype="float32",
        mean_a=stats["a"][0], std_a=stats["a"][1], mean_b=stats["b"][0],
        std_b=stats["b"][1], color_jitter=STRONG, warp_method="gather"))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=32,
                              device="cpu")
    rng = np.random.default_rng(25)
    u8 = {n: torch.from_numpy(rng.integers(0, 256, (B, 32, 32, 3),
                                           np.uint8)) for n in "ab"}
    gen = torch.Generator().manual_seed(26)
    aff = {n: taug.sample_affine_params(
        B, trainer.aug, generator=gen) for n in "ab"}
    jit = {n: _torch(_factors(27 + i, b=B)) for i, n in enumerate("ab")}
    _, panels = trainer.train_step(
        trainer.init_states(seed=0), u8["a"], u8["b"], affine_params=aff,
        jitter_params=jit, with_images=True)
    for n in "ab":
        real = taug.augment_batch(u8[n], *stats[n], trainer.aug,
                                  params=aff[n], method="gather")
        want = panel_grid_u8(tc.color_jitter_normalised(real, jit[n],
                                                        *stats[n]))
        assert torch.equal(panels[f"swap_1_real/{n}"], want)
