"""The port's i420 wire format against the JAX package, on the CPU.

* ``ops/image.py``: ``rgb_to_i420`` and ``i420_to_rgb`` bit-equal to JAX's
  at 64^2, 448x544 and 100x64 (both compute in fp32 one operation at a
  time and round half to even); ``validate_i420_dims`` raises JAX's
  message; the host pack and unpack are bit-equal to JAX's (cv2's
  converters) where cv2 imports, and to the device functions on CPU
  tensors where it does not; the device functions hold JAX's own
  tolerances against cv2 (1 LSB for the pack, 2 for the unpack:
  ``tests/test_image_ops.py``).
* the fused warp with fp32 input and the normalise folded in, the route an
  i420 upload takes at 448^2, bit-equal to the interpreted Pallas kernel on
  the same unpacked batch.
* ``config.py``'s i420 checks, ``device_prefetch``'s packing.
* one train step of the denoiser, the deep-fake trainer in swap mode and
  the balancer with ``upload_format: i420``, against JAX's
  ``_train_step`` with the same config, from the same weights; the port
  gets the affine params, noise ratios and noise that JAX draws from its
  keys. The losses (and swap differences) are held within 1e-4 relative.
  The new BN running statistics are held within 1e-3 of each tensor's
  largest magnitude: inside its jitted step XLA computes the affine
  coefficients' cos/sin and the noise's log to other ulps than the port,
  and the deepest layers (2x2 maps, 8 values a channel at batch 2) carry
  such input differences up to 5e-4 of a tensor's largest statistic, with
  rgb uploads as with i420 (measured at two weight and data points).
  The gradients at random 64^2 x 2 points are rough (a ReLU input near
  zero flips a gradient on or off: ``test_torch_port_deep_fake.py``), so
  they are held by the smoothed points of the RGB step tests, which share
  every piece but the unpack checked here.
* ``fit_denoiser`` with i420 uploads (``tests/test_upload_format.py:94``).
* the engine and server i420 matrix (``tests/test_serving.py:208-331``):
  every reply also equal to the pipeline's output on its padded batch.

64^2 (32^2 for the runner, the engine and the server), batch 2, resnet18,
fp32.
"""

import dataclasses
import functools
import http.client
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.ops import augment as jax_augment
from denoising_diffusion_deep_fake_tpu.ops import image as jax_image
from denoising_diffusion_deep_fake_tpu.ops import noise as jax_noise
from denoising_diffusion_deep_fake_tpu.ops.pallas.warp_fused import (
    affine_warp_pallas_fused,
)
from denoising_diffusion_deep_fake_tpu.serving.server import (
    _supported_formats as jax_supported_formats,
)
from denoising_diffusion_deep_fake_tpu.training.balance import (
    BalanceTrainer as JaxBalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.deep_fake import (
    DeepFakeTrainer as JaxDeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.denoiser import (
    DenoiserTrainer as JaxDenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.state import (
    ModelState as JaxModelState,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch import inference
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.data.loader import (
    device_prefetch,
)
from denoising_diffusion_deep_fake_tpu_torch.ops import image
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
    warp_fused as port_fused,
)
from denoising_diffusion_deep_fake_tpu_torch.serving import SwapEngine
from denoising_diffusion_deep_fake_tpu_torch.serving.server import (
    SwapServer,
    _supported_formats,
)
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.runners import (
    fit_denoiser,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    load_jax_state,
    state_dict_from_jax,
)

from helpers import make_image_dataset
from test_torch_port_model import random_flax_variables

ENCODER, S, B = "resnet18", 64, 2
STEP_RTOL = 1e-4
STATS_OF_MAX = 1e-3
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the runners' checkpoints and
    event files would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth(rng, h=16, w=16):
    """JAX's test field (``tests/test_image_ops.py``): a cubic-free
    bilinear blow-up of random pixels, so chroma varies little within a
    2x2 block, as on real frames."""
    cv2 = pytest.importorskip("cv2")
    small = rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


# ------------------------------------------------------------------ the ops


@pytest.mark.parametrize("hw", [(64, 64), (448, 544), (100, 64)])
def test_rgb_to_i420_bit_equal(hw):
    u8 = _u8((2,) + hw + (3,), 1)
    # Floats off the integers and outside [0, 255]: the clamp and the
    # half-to-even rounding.
    f32 = np.random.default_rng(2).uniform(-20, 275, (2,) + hw + (3,)
                                           ).astype(np.float32)
    for x in (u8, f32):
        want = np.asarray(jax_image.rgb_to_i420(jnp.asarray(x)))
        got = image.rgb_to_i420(torch.from_numpy(x)).numpy()
        assert got.dtype == np.uint8
        assert got.shape == (2, hw[0] * 3 // 2, hw[1])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(64, 64), (448, 544), (100, 64)])
def test_i420_to_rgb_bit_equal(hw):
    packed = _u8((2, hw[0] * 3 // 2, hw[1]), 3)
    want = np.asarray(jax_image.i420_to_rgb(jnp.asarray(packed)))
    got = image.i420_to_rgb(torch.from_numpy(packed)).numpy()
    assert got.dtype == np.float32 and got.shape == (2,) + hw + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(66, 64), (64, 65)])
def test_validate_i420_dims_raises_like_jax(hw):
    with pytest.raises(ValueError) as want:
        jax_image.validate_i420_dims(*hw)
    with pytest.raises(ValueError) as got:
        image.validate_i420_dims(*hw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="height % 4"):
        image.rgb_to_i420(torch.zeros((1,) + hw + (3,), dtype=torch.uint8))
    image.validate_i420_dims(64, 64)


def test_host_pack_and_unpack_bit_equal_to_device(monkeypatch):
    """Where cv2 does not import (it is hidden here), the host pack and
    unpack are the device functions on CPU tensors, bit for bit."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    rgb = _u8((3, 64, 96, 3), 4)
    packed = image.pack_rgb_batch_to_i420_np(rgb)
    assert packed.dtype == np.uint8 and packed.nbytes == rgb.nbytes // 2
    np.testing.assert_array_equal(
        packed, image.rgb_to_i420(torch.from_numpy(rgb)).numpy())
    np.testing.assert_array_equal(
        packed, np.asarray(jax_image.rgb_to_i420(jnp.asarray(rgb))))
    back = image.unpack_i420_batch_to_rgb_np(packed)
    assert back.dtype == np.uint8 and back.shape == rgb.shape
    np.testing.assert_array_equal(back, torch.round(image.i420_to_rgb(
        torch.from_numpy(packed))).to(torch.uint8).numpy())


def test_host_pack_and_unpack_against_cv2():
    """Where cv2 imports, the host pack and unpack are the JAX package's
    (cv2's converters), bit for bit, on JAX's test field and on noise; the
    device functions stay within JAX's tolerances of them (1 LSB for the
    pack, 2 for the unpack: ``tests/test_image_ops.py``)."""
    cv2 = pytest.importorskip("cv2")
    for rgb in (_smooth(np.random.default_rng(5))[None],
                _u8((3, 64, 96, 3), 4)):
        packed = image.pack_rgb_batch_to_i420_np(rgb)
        np.testing.assert_array_equal(
            packed, jax_image.pack_rgb_batch_to_i420_np(rgb))
        np.testing.assert_array_equal(packed[0], cv2.cvtColor(
            rgb[0][..., ::-1].copy(), cv2.COLOR_BGR2YUV_I420))
        back = image.unpack_i420_batch_to_rgb_np(packed)
        np.testing.assert_array_equal(
            back, jax_image.unpack_i420_batch_to_rgb_np(packed))
        device = image.rgb_to_i420(torch.from_numpy(rgb)).numpy()
        assert np.abs(device.astype(int) - packed.astype(int)).max() <= 1
        device_back = torch.round(image.i420_to_rgb(torch.from_numpy(
            packed))).to(torch.uint8).numpy()
        assert np.abs(device_back.astype(int)
                      - back.astype(int)).max() <= 2


def test_unpack_upload():
    u8 = torch.from_numpy(_u8((2, 8, 8, 3), 6))
    assert image.unpack_upload(u8, "rgb") is u8
    packed = image.rgb_to_i420(u8)
    assert torch.equal(image.unpack_upload(packed, "i420"),
                       image.i420_to_rgb(packed))


@pytest.mark.parametrize("overrides,match", [
    (dict(image_size=30), "image_size % 4"),
    (dict(spatial_parallel=2, image_size=32), "spatial_parallel"),
    (dict(data_cache="device"), "data_cache"),
])
def test_config_checks_match_jax(overrides, match):
    data = dict(input_image_list_path="x", batch_size=2,
                upload_format="i420", **overrides)
    with pytest.raises(ValueError, match=match):
        jax_config.config_from_dict(jax_config.DenoiserConfig, data)
    with pytest.raises(ValueError, match=match):
        port_config.config_from_dict(port_config.DenoiserConfig, data)
    port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", upload_format="i420", image_size=32))


def test_device_prefetch_packs_uint8_batches():
    rgb = _u8((2, 16, 16, 3), 7)
    idx = np.arange(2)
    items = [(rgb, idx)]
    (packed, got_idx), = device_prefetch(iter(items), "cpu",
                                         upload_format="i420")
    assert got_idx is idx
    np.testing.assert_array_equal(packed.numpy(),
                                  image.pack_rgb_batch_to_i420_np(rgb))
    (same, _), = device_prefetch(iter(items), "cpu")
    np.testing.assert_array_equal(same.numpy(), rgb)


@pytest.mark.parametrize("mean,std", [((0.5,) * 3, (0.5,) * 3), IMAGENET])
def test_fused_warp_fp32_input_with_norm_matches_pallas(mean, std):
    """The route of an i420 upload at 448^2: fp32 RGB in [0, 255] into the
    fused warp with the normalise folded in, against the interpreted
    Pallas kernel on the same batch (here at 64^2).

    The port divides by ``std*255`` (``__fdiv_rn`` on the card, a true
    division in the plain version, as ``normalise_batch``); XLA on the CPU
    compiles the Pallas kernel's division by that constant into a multiply
    by its fp32 reciprocal, which rounds about one value in six the other
    way. The x-pass rounds its input to bf16, so the two outputs differ
    only where such a value straddles a bf16 rounding boundary: the JAX
    output is bit-equal to the port's plain two-pass warp of the
    reciprocal-multiplied batch, and the port's differs from it in a share
    of elements held below 1e-3 (printed), each by at most one bf16 ulp of
    a tap times its weight."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        _inverse_affine_coeffs)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.warp_kernel import (
        affine_warp_twopass_plain)

    rgb = image.i420_to_rgb(torch.from_numpy(_u8((B, S * 3 // 2, S), 8)))
    rng = np.random.default_rng(9)
    params = {"angle": rng.uniform(-15, 15, B).astype(np.float32),
              "scale": rng.uniform(0.8, 1.2, B).astype(np.float32),
              "tx": rng.uniform(-0.2, 0.2, B).astype(np.float32),
              "ty": rng.uniform(-0.2, 0.2, B).astype(np.float32),
              "apply": np.array([True, False])}
    want = np.asarray(affine_warp_pallas_fused(
        jnp.asarray(rgb.numpy()), {k: jnp.asarray(v)
                                   for k, v in params.items()},
        mean=mean, std=std, interpret=True))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got = port_fused.affine_warp_fused(rgb, tparams, mean=mean,
                                       std=std).numpy()
    norm = np.asarray(port_fused.norm_constants(mean, std, 3), np.float32)
    recip = (rgb - torch.from_numpy(norm[:3])) * torch.from_numpy(
        np.float32(1) / norm[3:])
    xla = affine_warp_twopass_plain(recip, _inverse_affine_coeffs(
        tparams, S, S)).numpy()
    np.testing.assert_array_equal(xla, want)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    print(f"fused fp32+norm vs interpreted Pallas: differing share "
          f"{share:.2e}, max {diff.max():.2e}")
    assert share < 1e-3
    assert diff.max() <= 2.0 ** -8 * np.abs(want).max()


# ---------------------------------------------------- train steps vs JAX


def _jax_state(trainer, seed, *, ema_seed=None):
    v = random_flax_variables(trainer.model, S, seed=seed)
    # Predictions inside the loss's clamp (test_torch_port_step.py).
    head = v["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1
    s = JaxModelState(step=jnp.int32(0), params=v["params"],
                      batch_stats=v["batch_stats"],
                      opt_state=trainer.tx.init(v["params"]))
    if ema_seed is not None:
        e = random_flax_variables(trainer.model, S, seed=ema_seed)
        s = s.replace(ema_params=e["params"],
                      ema_batch_stats=e["batch_stats"],
                      ema_step=jnp.int32(10 ** 7))
    return s


def _jax_step(trainer):
    return jax.jit(functools.partial(trainer._train_step, with_images=False))


def _draws(key, aug, lam):
    """The affine params, ratios and noise a JAX step draws from ``key``
    (its ``k_aug``/``k_noise`` split), as torch tensors."""
    k_aug, k_noise = jax.random.split(key)
    params = jax_augment.sample_affine_params(k_aug, B, aug)
    key_r, key_n = jax.random.split(k_noise)
    r = jax_noise.sample_truncated_exponential(key_r, (B, 1, 1, 1), lam)
    noise = jax.random.normal(key_n, (B, S, S, 3))
    return ({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
            torch.from_numpy(np.array(r)).reshape(B),
            torch.from_numpy(np.array(noise)))


def _stats(sd):
    return {k: v for k, v in sd.items() if "running" in k}


def _check_stats(port_model, jax_state):
    want = _stats(state_dict_from_jax(jax.device_get(jax_state.params),
                                      jax.device_get(jax_state.batch_stats)))
    got = _stats(port_model.state_dict())
    assert want and got.keys() == want.keys()
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=STATS_OF_MAX * np.abs(w).max(),
                                   err_msg=name)


def _packed(seed):
    return image.pack_rgb_batch_to_i420_np(_u8((B, S, S, 3), seed))


@pytest.fixture(scope="module")
def denoiser_steps():
    data = dict(input_image_list_path="x", batch_size=B, learning_rate=0.02,
                encoder_name=ENCODER, compute_dtype="float32", image_size=S,
                upload_format="i420", warp_method="pallas_fused",
                mean=IMAGENET[0], std=IMAGENET[1])
    jt = JaxDenoiserTrainer(jax_config.config_from_dict(
        jax_config.DenoiserConfig, data), steps_per_epoch=10, image_size=S)
    js = _jax_state(jt, 12)
    packed = _packed(11)
    key = jax.random.PRNGKey(3)
    new_js, jm = _jax_step(jt)(js, jnp.asarray(packed), key)
    params, ratios, noise = _draws(jax.random.fold_in(key, 0), jt.aug,
                                   jt.cfg.noise_exponential_sampling_lambda)
    pt = DenoiserTrainer(port_config.config_from_dict(
        port_config.DenoiserConfig, data), steps_per_epoch=10, image_size=S,
        device="cpu")
    ps = pt.init_state(seed=0)
    load_jax_state(ps, jax.device_get(js))
    pm = pt.train_step(ps, torch.from_numpy(packed), affine_params=params,
                       ratios=ratios, noise=noise)
    return new_js, jm, ps, pm


def test_denoiser_i420_step_matches_jax(denoiser_steps):
    new_js, jm, ps, pm = denoiser_steps
    assert ps.step == 1
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=STEP_RTOL)
    _check_stats(ps.model, new_js)


@pytest.fixture(scope="module")
def swap_steps():
    data = dict(mode="swap", data_path_a="a", data_path_b="b",
                batch_size=B, encoder_name=ENCODER, compute_dtype="float32",
                image_size=S, upload_format="i420",
                warp_method="pallas_fused", mean_a=IMAGENET[0],
                std_a=IMAGENET[1])
    jt = JaxDeepFakeTrainer(jax_config.config_from_dict(
        jax_config.DeepFakeConfig, data), steps_per_epoch=10, image_size=S)
    js = {"a": _jax_state(jt, 20, ema_seed=22),
          "b": _jax_state(jt, 21, ema_seed=23)}
    packed = {"a": _packed(24), "b": _packed(25)}
    key = jax.random.PRNGKey(4)
    new_js, jm = _jax_step(jt)(js, jnp.asarray(packed["a"]),
                               jnp.asarray(packed["b"]), key)
    k_a, k_b = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, 0), 0))
    lam = jt.cfg.noise_exponential_sampling_lambda
    draws = {"a": _draws(k_a, jt.aug, lam), "b": _draws(k_b, jt.aug, lam)}
    pt = DeepFakeTrainer(port_config.config_from_dict(
        port_config.DeepFakeConfig, data), steps_per_epoch=10, image_size=S,
        device="cpu")
    ps = pt.init_states(seed=0)
    for name in ps:
        load_jax_state(ps[name], jax.device_get(js[name]))
    pm = pt.train_step(
        ps, torch.from_numpy(packed["a"]), torch.from_numpy(packed["b"]),
        affine_params={n: d[0] for n, d in draws.items()},
        ratios={n: d[1] for n, d in draws.items()},
        noise={n: d[2] for n, d in draws.items()})
    return new_js, jm, ps, pm


def test_deep_fake_swap_i420_step_matches_jax(swap_steps):
    new_js, jm, ps, pm = swap_steps
    for key in ("loss_swap/train_a", "loss_swap/train_b",
                "swap_difference/a", "swap_difference/b"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    for name in ("a", "b"):
        assert ps[name].step == 1
        _check_stats(ps[name].model, new_js[name])


@pytest.fixture(scope="module")
def balance_steps():
    data = dict(data_path="x", batch_size=B, learning_rate=0.01,
                encoder_name=ENCODER, compute_dtype="float32", image_size=S,
                upload_format="i420", ratio_of_noise=0.7)
    jt = JaxBalanceTrainer(jax_config.config_from_dict(
        jax_config.BalanceConfig, data), steps_per_epoch=10, image_size=S)
    js = _jax_state(jt, 30)
    packed = _packed(31)
    key = jax.random.PRNGKey(5)
    new_js, jm = _jax_step(jt)(js, jnp.asarray(packed), key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, 0), (B, S, S, 3))))
    pt = BalanceTrainer(port_config.config_from_dict(
        port_config.BalanceConfig, data), steps_per_epoch=10, image_size=S,
        device="cpu")
    ps = pt.init_state(seed=0)
    load_jax_state(ps, jax.device_get(js))
    pm = pt.train_step(ps, torch.from_numpy(packed), noise=noise)
    return new_js, jm, ps, pm, pt, packed


def test_balancer_i420_step_matches_jax(balance_steps):
    new_js, jm, ps, pm, _, _ = balance_steps
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=STEP_RTOL)
    _check_stats(ps.model, new_js)


def test_balancer_i420_noise_is_the_fp32_kernels_stream(balance_steps):
    """Without injected noise an i420 step noises the unpacked, normalised
    batch with ``fused_noise_blend`` (its plain version here) at the fixed
    ratio and the step's offset; the uint8 kernel's stream on an RGB batch
    is the same stream."""
    from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
        normalise_batch)
    from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import (
        noise_kernel as nk)

    _, _, _, _, trainer, packed = balance_steps
    cfg = trainer.cfg
    image_, noisy = trainer._images(torch.from_numpy(packed), 7, None,
                                    "i420")
    rgb = image.i420_to_rgb(torch.from_numpy(packed))
    assert torch.equal(image_, normalise_batch(rgb, cfg.mean, cfg.std))
    ratios = torch.full((B,), cfg.ratio_of_noise)
    assert torch.equal(noisy, nk.fused_noise_blend_plain(
        image_, ratios, seed=cfg.seed, offset=7))
    u8 = torch.round(rgb).to(torch.uint8)
    _, noisy_u8 = trainer._images(u8, 7, None)
    assert torch.equal(noisy_u8, nk.fused_noise_blend_plain(
        normalise_batch(u8, cfg.mean, cfg.std), ratios, seed=cfg.seed,
        offset=7))


# ---------------------------------------------------------------- runners


def test_fit_denoiser_with_i420_uploads(tmp_path):
    """The runner path with packed uploads: finite losses that track an
    rgb run of the same seed (chroma subsampling is the only difference),
    as ``tests/test_upload_format.py:94`` holds the JAX runner."""
    manifest = make_image_dataset(tmp_path, n=8, size=32)
    losses = {}
    for fmt in ("rgb", "i420"):
        cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
            input_image_list_path=str(manifest), batch_size=4,
            learning_rate=1e-3, max_epochs=1, encoder_name=ENCODER,
            compute_dtype="float32", image_size=32, upload_format=fmt,
            noise_exponential_sampling_lambda=3.0,
            log_dir=str(tmp_path / f"runs_{fmt}"),
            checkpoint_dir=str(tmp_path / f"ckpt_{fmt}")))
        seen = []
        _, _, ctx = fit_denoiser(cfg, max_steps=2, verbose=False,
                                 device="cpu",
                                 step_callback=lambda s, st, m: seen.append(
                                     float(m["loss"])))
        assert ctx.global_step == 2
        assert all(np.isfinite(v) for v in seen)
        losses[fmt] = seen
    np.testing.assert_allclose(losses["i420"], losses["rgb"], rtol=0.1)
    shutil.rmtree(tmp_path, ignore_errors=True)


# ---------------------------------------------------------- engine, server

SIZE = 32


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("i420_serving")
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        mode="denoise", data_path_a="a", data_path_b="b", batch_size=2,
        encoder_name=ENCODER, compute_dtype="float32", image_size=SIZE))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=SIZE,
                              device="cpu")
    CheckpointManager(tmp / "ckpt").save(1, trainer.init_states(seed=0),
                                         dataclasses.asdict(cfg))
    yield tmp / "ckpt"
    shutil.rmtree(tmp, ignore_errors=True)


def _engine(checkpoint, transfer):
    eng = SwapEngine(checkpoint, "a", height=SIZE, width=SIZE, batch_size=4,
                     max_wait_ms=20.0, transfer=transfer, device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def servers(checkpoint):
    engines = {t: _engine(checkpoint, t) for t in ("rgb", "i420")}
    with SwapServer(engines["rgb"], port=0) as rgb, \
            SwapServer(engines["i420"], port=0) as i420:
        yield {"rgb": (rgb, engines["rgb"]), "i420": (i420, engines["i420"])}


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out_headers = dict(resp.getheaders())
    conn.close()
    return resp.status, data, out_headers


def _padded_pipeline(engine, frames):
    """The engine's pipeline on ``frames`` padded with zeros to its batch,
    as the dispatcher sends a lone request."""
    pad = np.zeros((engine.batch_size,) + frames.shape[1:], np.uint8)
    pad[:len(frames)] = frames
    pipe = inference.make_device_pipeline(engine.model,
                                          transfer=engine.transfer)
    return pipe(torch.from_numpy(pad), 0)[:len(frames)].numpy()


def test_i420_engine_swap_matches_rgb_engine_closely(servers):
    """Same checkpoint, rgb against i420 device wire: the outputs differ by
    chroma subsampling only (JAX's bound), and the i420 engine's ``swap``
    is the host pack, the pipeline and the host unpack."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    smooth = np.clip(255 * (0.5 + 0.4 * np.sin(
        2 * np.pi * (0.25 * np.stack([yy, xx, yy * xx], -1)))), 0,
        255).astype(np.uint8)
    out_rgb = servers["rgb"][1].swap(smooth)
    engine = servers["i420"][1]
    out_i420 = engine.swap(smooth)
    assert out_i420.shape == out_rgb.shape == (SIZE, SIZE, 3)
    assert out_i420.dtype == np.uint8
    err = np.abs(out_i420.astype(np.int32) - out_rgb.astype(np.int32))
    assert err.mean() < 48.0
    want = image.unpack_i420_batch_to_rgb_np(_padded_pipeline(
        engine, image.pack_rgb_batch_to_i420_np(smooth[None])))[0]
    np.testing.assert_array_equal(out_i420, want)


def test_i420_engine_wire_shapes(servers):
    engine = servers["i420"][1]
    assert engine.wire_frame_shape == (SIZE * 3 // 2, SIZE)
    packed = image.pack_rgb_batch_to_i420_np(_u8((2, SIZE, SIZE, 3), 1))
    out = engine.swap_wire(packed)
    assert out.shape == packed.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _padded_pipeline(engine, packed))
    with pytest.raises(ValueError, match="wire frames"):
        engine.swap_wire(np.zeros((2, SIZE, SIZE, 3), np.uint8))
    assert engine.stats()["transfer"] == "i420"


def test_engine_rejects_odd_i420_geometry(checkpoint):
    with pytest.raises(ValueError, match="height % 4"):
        SwapEngine(checkpoint, "a", height=30, width=SIZE, transfer="i420",
                   device="cpu")


def test_healthz_formats_follow_engine_geometry():
    for h, w in ((SIZE, SIZE), (30, SIZE), (SIZE, 31)):
        engine = types.SimpleNamespace(height=h, width=w)
        assert _supported_formats(engine) == jax_supported_formats(engine)
    assert _supported_formats(types.SimpleNamespace(
        height=SIZE, width=SIZE)) == ["rgb", "i420"]


def test_swap_raw_i420_passthrough(servers):
    """i420 client and i420 engine: no conversion, half the bytes both
    ways, the reply the pipeline's output on the padded batch."""
    server, engine = servers["i420"]
    packed = image.pack_rgb_batch_to_i420_np(_u8((2, SIZE, SIZE, 3), 7))
    status, data, headers = _request(
        server.port, "POST", "/v1/swap_raw", body=packed.tobytes(),
        headers={"X-Shape": f"2,{SIZE},{SIZE}", "X-Format": "i420"})
    assert status == 200, data
    assert headers["X-Format"] == "i420"
    assert headers["X-Shape"] == f"2,{SIZE},{SIZE}"
    out = np.frombuffer(data, np.uint8).reshape(packed.shape)
    np.testing.assert_array_equal(out, _padded_pipeline(engine, packed))


def test_swap_raw_i420_client_on_rgb_engine(servers):
    """i420 on the HTTP wire, rgb on the device wire: the server unpacks,
    the engine swaps, the server packs."""
    server, engine = servers["rgb"]
    packed = image.pack_rgb_batch_to_i420_np(_u8((1, SIZE, SIZE, 3), 8))[0]
    status, data, headers = _request(
        server.port, "POST", "/v1/swap_raw", body=packed.tobytes(),
        headers={"X-Shape": f"{SIZE},{SIZE}", "X-Format": "i420"})
    assert status == 200, data
    assert headers["X-Shape"] == f"{SIZE},{SIZE}"
    out = np.frombuffer(data, np.uint8).reshape(SIZE * 3 // 2, SIZE)
    want = image.pack_rgb_batch_to_i420_np(_padded_pipeline(
        engine, image.unpack_i420_batch_to_rgb_np(packed[None])))[0]
    np.testing.assert_array_equal(out, want)


def test_swap_raw_rgb_client_on_i420_engine(servers):
    server, engine = servers["i420"]
    frames = _u8((1, SIZE, SIZE, 3), 9)
    status, data, headers = _request(
        server.port, "POST", "/v1/swap_raw", body=frames.tobytes(),
        headers={"X-Shape": f"1,{SIZE},{SIZE},3"})
    assert status == 200, data
    out = np.frombuffer(data, np.uint8).reshape(
        tuple(int(s) for s in headers["X-Shape"].split(",")))
    assert out.shape == frames.shape
    want = image.unpack_i420_batch_to_rgb_np(_padded_pipeline(
        engine, image.pack_rgb_batch_to_i420_np(frames)))
    np.testing.assert_array_equal(out, want)


def test_swap_raw_i420_rejects_bad_geometry(servers):
    server, _ = servers["i420"]
    status, data, _ = _request(
        server.port, "POST", "/v1/swap_raw", body=b"x",
        headers={"X-Shape": "30,31", "X-Format": "i420"})
    assert status == 400 and b"height % 4" in data
    status, _, _ = _request(server.port, "GET", "/healthz")
    assert status == 200


def test_healthz_reports_transfer(servers):
    for transfer, (server, _) in servers.items():
        status, data, _ = _request(server.port, "GET", "/healthz")
        info = json.loads(data)
        assert status == 200 and info["transfer"] == transfer
        assert info["formats"] == ["rgb", "i420"]
