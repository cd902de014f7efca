"""The port's balancer (``training/balance.py``) vs the JAX package's.

One fp32 balancer train step and one scoring batch of the port, at 64²
with batch 2 and resnet18, against the same computations composed from the
JAX package: ``normalise_batch``, ``blend_noise`` at the fixed ratio,
``model.apply``, ``mse_ssim_loss`` (train) or ``l1_difficulty_loss``
(eval-mode BN), ``value_and_grad`` and constant-LR optax Adam
(``make_adam_with_cosine(cosine_t_max=None)``). Both start from the same
weights (flax variables filled from a numpy seed, carried over with
``utils/jax_weights.py``) and get the same numpy noise.

Tolerances, those of ``tests/test_torch_port_step.py`` and for the same
causes (XLA and PyTorch sum convolutions in other orders): loss 1e-5
relative; gradients 1e-4 and Adam moments 2e-4 of each tensor's largest
magnitude; new BN stats 1e-5 relative; params 1e-6 where the gradient is
clear of zero (above 2% of the tensor's largest and 1e-6), else 2 lr + 1e-6
(Adam's first step moves each param by about +-lr, so a tiny gradient whose
sign differs between the frameworks moves it the other way). The eval-mode
L1 scores: 1e-5 relative (an fp32 forward, summed in other orders). The
rest is exact: config values, difficulty classes, the manifest's bytes,
and the port's own stream bookkeeping.

The gradient tolerance needs a test point where the step's gradient is a
smooth function of its input. At most random inputs of this size it is
not: a ReLU input within rounding distance of zero switches its gradient on
or off, and at 8x8 maps with batch 2 one switch moves a channel's gradient
by about 1/128 of it. Across ten numpy seeds for the data and two for the
weights, the port's own gradients moved by 0.05-19% of a tensor's largest
entry when the noisy input was scaled by 1 +- 1e-7, and the JAX and port
gradients differed by as much. The data and weight seeds here give a point
where that self-perturbation moves them by 2e-5;
``test_gradient_is_smooth_at_the_test_point`` keeps that precondition
checked.
"""

import dataclasses
import shutil
import types
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.data.manifest import (
    read_image_manifest_with_classes as jax_read_manifest,
)
from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.ops.augment import normalise_batch
from denoising_diffusion_deep_fake_tpu.ops.losses import (
    l1_difficulty_loss as jax_l1,
    mse_ssim_loss,
)
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu.training.balance import (
    compute_difficulty_index as jax_difficulty,
)
from denoising_diffusion_deep_fake_tpu.training.optim import (
    make_adam_with_cosine,
)
from denoising_diffusion_deep_fake_tpu.training.runners import (
    write_balanced_manifest as jax_write_balanced,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
)
from denoising_diffusion_deep_fake_tpu_torch.data.loader import ImageLoader
from denoising_diffusion_deep_fake_tpu_torch.data.manifest import (
    read_image_manifest,
    read_image_manifest_with_classes,
)
from denoising_diffusion_deep_fake_tpu_torch.ops import image
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.noise_kernel import (
    normal_plain,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.losses import (
    l1_difficulty_loss,
    mse_ssim_loss as port_mse_ssim_loss,
)
from denoising_diffusion_deep_fake_tpu_torch.training import balance, runners
from denoising_diffusion_deep_fake_tpu_torch.training.cached import (
    cached_steps_for,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)

from helpers import make_image_dataset
from test_torch_port_model import random_flax_variables

ROOT = Path(__file__).resolve().parent.parent
ENCODER, B, S = "resnet18", 2, 64
LR, RATIO, SEED = 0.01, 0.7, 21
MEAN = STD = (0.5, 0.5, 0.5)


def _cfg(**overrides):
    base = dict(data_path="unused", batch_size=B, learning_rate=LR,
                encoder_name=ENCODER, compute_dtype="float32", mean=MEAN,
                std=STD, ratio_of_noise=RATIO, seed=SEED)
    return port_config.config_from_dict(port_config.BalanceConfig,
                                        dict(base, **overrides))


def _trainer():
    return balance.BalanceTrainer(_cfg(), steps_per_epoch=10, image_size=S,
                                  device="cpu")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the balancer's checkpoints and
    event files would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    u8 = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    noise = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    model = jax_unet(ENCODER, dtype=jnp.float32)
    variables = random_flax_variables(model, S, seed=12)
    # Predictions inside the loss's (-1, 1) clamp, as in
    # test_torch_port_step.py.
    head = variables["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])

    def port_state(trainer):
        state = trainer.init_state(seed=0)
        state.model.load_state_dict(sd)
        return state

    return dict(u8=u8, noise=noise, model=model, variables=variables,
                port_state=port_state)


@pytest.fixture(scope="module")
def both_steps(setup):
    u8, noise, model = setup["u8"], setup["noise"], setup["model"]
    variables = setup["variables"]
    tx = make_adam_with_cosine(LR, cosine_t_max=None, flatten=False)
    opt_state = tx.init(variables["params"])
    image = normalise_batch(jnp.asarray(u8), MEAN, STD)
    noisy = blend_noise(image, jnp.asarray(noise),
                        jnp.full((B, 1, 1, 1), RATIO, jnp.float32))

    def loss_fn(p):
        pred, mutated = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, noisy,
            train=True, mutable=["batch_stats"])
        return mse_ssim_loss(pred, image), mutated["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    updates, new_opt = tx.update(grads, opt_state, variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    adam = new_opt[0]
    jax_side = dict(loss=float(loss), grads=grads, batch_stats=new_bs,
                    mu=adam.mu, nu=adam.nu, params=new_params)

    trainer = _trainer()
    state = setup["port_state"](trainer)
    metrics = trainer.train_step(state, torch.from_numpy(u8),
                                 noise=torch.from_numpy(noise))
    return jax_side, state, metrics


def _named(tree, stats=None):
    return state_dict_from_jax(tree, {} if stats is None else stats)


def test_balance_yaml_loads_like_the_jax_package():
    path = ROOT / "configs" / "balance.yml"
    port = port_config.load_config(port_config.BalanceConfig, path,
                                   {"data_path": "x"})
    ref = jax_config.load_config(jax_config.BalanceConfig, path,
                                 {"data_path": "x"})
    names = [f.name for f in dataclasses.fields(port)]
    assert {"ratio_of_noise", "number_of_classes", "data_path",
            "output_image_list_path"} <= set(names)
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.batch_size, port.encoder_name, port.compute_dtype,
            port.ratio_of_noise, port.number_of_classes) == (
        12, "resnet34", "bfloat16", 0.7, 10)


def test_balance_config_validation():
    with pytest.raises(ValueError, match="data_path"):
        _cfg(data_path="")
    with pytest.raises(ValueError, match="ratio_of_noise"):
        _cfg(ratio_of_noise=1.5)
    with pytest.raises(ValueError, match="number_of_classes"):
        _cfg(number_of_classes=0)
    with pytest.warns(UserWarning, match="0-255"):
        assert _cfg(mean=(128,) * 3, std=(64,) * 3).std == pytest.approx(
            (64 / 255,) * 3)


@pytest.mark.parametrize("knob", [dict(upload_format="i420"),
                                  dict(data_cache="device"),
                                  dict(patchify_stem=2)])
def test_balancer_refuses_unported_knobs(knob, tmp_path):
    """Each knob without its feature in the port is refused. ``knob0``,
    ``upload_format: i420``, has been ported since: that case checks that
    the balancer takes it and trains a step on a packed batch, while its
    scoring pass reads RGB (parity with JAX:
    ``tests/test_torch_port_i420.py``). ``knob1``, ``data_cache: device``,
    too: that case builds a cache, trains a step on a batch gathered from
    it and scores from it (against the host runs:
    ``tests/test_torch_port_device_cache.py``). ``knob2``,
    ``patchify_stem: 2``, too: that case trains a step of the patchified
    U-Net at 64^2 and scores with it (its parity with JAX:
    ``tests/test_torch_port_patchify.py``)."""
    if knob == dict(data_cache="device"):
        manifest = make_image_dataset(tmp_path, n=3, size=S)
        trainer = balance.BalanceTrainer(_cfg(**knob), steps_per_epoch=1,
                                         image_size=S, device="cpu")
        state = trainer.init_state(seed=0)
        cache = DeviceDatasetCache(ImageLoader(manifest, B, image_size=S),
                                   device="cpu")
        plain, _ = cached_steps_for(trainer, [cache], cache.steps_per_epoch)
        cache.order_for_epoch(0)
        loss = plain(state)["loss"]
        indices, losses = trainer.score_dataset_from_cache(state, cache)
        assert state.step == 1 and torch.isfinite(loss)
        assert indices.tolist() == [0, 1, 2] and np.isfinite(losses).all()
        return
    if knob == dict(upload_format="i420"):
        trainer = balance.BalanceTrainer(_cfg(**knob), steps_per_epoch=1,
                                         image_size=32, device="cpu")
        state = trainer.init_state(seed=0)
        rgb = torch.zeros((B, 32, 32, 3), dtype=torch.uint8)
        loss = trainer.train_step(state, image.rgb_to_i420(rgb))["loss"]
        _, losses = trainer.score_dataset(state, [(rgb, np.arange(B))])
        assert torch.isfinite(loss) and np.isfinite(losses).all()
        return
    assert knob == dict(patchify_stem=2)
    trainer = balance.BalanceTrainer(_cfg(**knob), steps_per_epoch=1,
                                     image_size=64, device="cpu")
    state = trainer.init_state(seed=0)
    u8 = torch.zeros((B, 64, 64, 3), dtype=torch.uint8)
    loss = trainer.train_step(state, u8)["loss"]
    _, losses = trainer.score_dataset(state, [(u8, np.arange(B))])
    assert state.model.patch == 2 and trainer.generator is None
    assert torch.isfinite(loss) and np.isfinite(losses).all()


@pytest.mark.parametrize("case", ["random", "tied", "all-equal"])
def test_difficulty_index_matches_jax(case):
    rng = np.random.default_rng(41)
    losses = {"random": rng.uniform(0.1, 0.9, 257),
              "tied": np.repeat(rng.uniform(0, 1, 7), 5),
              "all-equal": np.full(9, 0.3)}[case].astype(np.float32)
    for classes in (1, 10, 7):
        got = balance.compute_difficulty_index(losses, classes)
        want = jax_difficulty(losses, classes)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < classes


def test_l1_difficulty_loss_matches_jax():
    rng = np.random.default_rng(42)
    p = rng.standard_normal((3, 9, 11, 3)).astype(np.float32)
    t = rng.standard_normal((3, 9, 11, 3)).astype(np.float32)
    want = np.asarray(jax_l1(jnp.asarray(p), jnp.asarray(t)))
    got = l1_difficulty_loss(torch.from_numpy(p), torch.from_numpy(t))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bf = l1_difficulty_loss(torch.from_numpy(p).bfloat16(),
                            torch.from_numpy(t))
    assert bf.dtype == torch.float32


def test_step_loss_and_bn_stats_match(both_steps):
    jax_side, state, metrics = both_steps
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_side["loss"],
                               rtol=1e-5)
    want = _named({}, jax_side["batch_stats"])
    sd = state.model.state_dict()
    assert want
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_step_grads_and_adam_moments_match(both_steps):
    jax_side, state, _ = both_steps
    grads = _named(jax_side["grads"])
    mu, nu = _named(jax_side["mu"]), _named(jax_side["nu"])
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        assert opt.param_groups[0]["lr"] == LR
        checks = ((p.grad, grads[name], 1e-4),
                  (opt.state[p]["exp_avg"], mu[name], 2e-4),
                  (opt.state[p]["exp_avg_sq"], nu[name], 2e-4))
        for got, want, tol in checks:
            want = want.numpy()
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=tol * np.abs(want).max() + 1e-20, err_msg=name)


def test_gradient_is_smooth_at_the_test_point(setup):
    """The precondition of the gradient tolerance (see the module notes)."""
    u8, noise = torch.from_numpy(setup["u8"]), torch.from_numpy(
        setup["noise"])
    trainer = _trainer()
    model = setup["port_state"](trainer).model
    image, noisy = trainer._images(u8, 0, noise)

    def grads(x):
        model.zero_grad()
        port_mse_ssim_loss(model(x), image).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    g0 = grads(noisy)
    for scale in (1 + 1e-7, 1 - 1e-7):
        for name, g in grads(noisy * scale).items():
            tol = 1e-4 * float(g0[name].abs().max())
            assert float((g - g0[name]).abs().max()) <= tol, name


def test_step_params_match(both_steps):
    jax_side, state, _ = both_steps
    want = _named(jax_side["params"])
    grads = _named(jax_side["grads"])
    for name, p in state.model.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), grads[name].numpy()
        diff = np.abs(got - w)
        assert diff.max() <= 2 * LR + 1e-6, name
        clear = (np.abs(g) > 2e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        assert diff[clear].max(initial=0.0) <= 1e-6, name


def test_validation_losses_match_jax(setup):
    u8, model, variables = setup["u8"], setup["model"], setup["variables"]
    noise = np.random.default_rng(43).standard_normal(u8.shape).astype(
        np.float32)
    image = normalise_batch(jnp.asarray(u8), MEAN, STD)
    noisy = blend_noise(image, jnp.asarray(noise),
                        jnp.full((B, 1, 1, 1), RATIO, jnp.float32))
    pred = model.apply(variables, noisy, train=False)
    want = np.asarray(jax_l1(pred, image))

    trainer = _trainer()
    state = setup["port_state"](trainer)
    got = trainer.make_validation_step()(state, torch.from_numpy(u8),
                                         offset=0,
                                         noise=torch.from_numpy(noise))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert not state.model.training


def test_steps_draw_the_kernel_stream(setup):
    """Without injected noise, the train step draws the kernel's stream at
    offset ``state.step`` and scoring batch k of epoch e at
    ``score_offset(e, k)``: the same numbers as handing that noise in."""
    u8 = torch.from_numpy(setup["u8"])
    n = u8.numel()
    trainer = _trainer()
    val_step = trainer.make_validation_step()
    state = setup["port_state"](trainer)
    for offset in (0, balance.score_offset(3, 1)):
        eps = normal_plain(n, seed=SEED, offset=offset,
                           device="cpu").reshape(u8.shape)
        assert torch.equal(val_step(state, u8, offset=offset),
                           val_step(state, u8, offset=offset, noise=eps))
    losses = []
    for noise in (None, normal_plain(n, seed=SEED, offset=0,
                                     device="cpu").reshape(u8.shape)):
        state = setup["port_state"](trainer)
        losses.append(float(trainer.train_step(state, u8,
                                               noise=noise)["loss"]))
    assert losses[0] == losses[1]
    assert balance.score_offset(0, 0) > 2 ** 32 - 1
    assert balance.score_offset(1, 0) - balance.score_offset(0, 0) \
        == balance.SCORE_STREAM


def test_score_dataset_pads_the_tail(setup):
    rng = np.random.default_rng(44)
    data = rng.integers(0, 256, (5, S, S, 3), np.uint8)
    batches = [(data[0:2], np.array([0, 1])), (data[2:4], np.array([2, 3])),
               (data[4:5], np.array([4]))]
    trainer = _trainer()
    state = setup["port_state"](trainer)
    indices, losses = trainer.score_dataset(state, batches, epoch=2)
    np.testing.assert_array_equal(indices, np.arange(5))
    assert losses.shape == (5,) and losses.dtype == np.float32
    assert np.isfinite(losses).all()
    val_step = trainer.make_validation_step()
    tail = torch.from_numpy(np.concatenate([data[4:5], data[4:5]]))
    want_tail = val_step(state, tail, offset=balance.score_offset(2, 2))
    assert losses[4] == float(want_tail[0])
    want_head = val_step(state, torch.from_numpy(data[0:2]),
                         offset=balance.score_offset(2, 0))
    np.testing.assert_array_equal(losses[:2], want_head.numpy())
    with pytest.raises(ValueError, match="exceeds"):
        trainer.score_dataset(state, [(data[:3], np.arange(3))])


def test_balanced_manifest_matches_jax(tmp_path):
    paths = [tmp_path / "imgs" / f"{i:03d}.jpg" for i in range(6)]
    indices = np.array([3, 0, 5, 1, 4, 2])
    classes = np.array([9, 0, 4, 4, 7, 2])
    mine, ref = tmp_path / "port.txt", tmp_path / "jax.txt"
    runners.write_balanced_manifest(
        types.SimpleNamespace(output_image_list_path=mine),
        types.SimpleNamespace(paths=paths), indices, classes)
    jax_write_balanced(types.SimpleNamespace(output_image_list_path=ref),
                       types.SimpleNamespace(paths=paths), indices, classes)
    assert mine.read_bytes() == ref.read_bytes()
    got_paths, got_classes = read_image_manifest_with_classes(mine)
    assert (got_paths, got_classes) == jax_read_manifest(ref)
    assert got_paths == paths
    assert got_classes == [0, 4, 2, 9, 7, 4]
    assert read_image_manifest(mine) == paths
