"""The port's deep-fake trainer vs the JAX package's pieces, composed.

The JAX side composes each step from the JAX package's own pieces with the
randomness injected: ``affine_warp_pallas_fused(interpret=True)`` with the
uint8 fold, ``blend_noise``, ``DeepFakeTrainer._ema_forward``,
``_train_one_model`` (with the optax Adam of ``make_adam_with_cosine``),
``ModelState.update_ema`` and ``mse_loss``, each jitted once and reused for
both models and both modes. The port runs ``DeepFakeTrainer.train_step`` on
the CPU from the same weights, carried across whole with
``utils/jax_weights.load_jax_state``. 64^2, batch 2, resnet18, fp32; each
identity has its own mean and std, and identity b's second sample is not
warped (``apply`` False, as p = 0.7 leaves about 30% of samples).

Tolerances and their causes:

* losses and swap differences 1e-5 relative; gradients 1e-4 of each
  tensor's largest magnitude; BN running stats as below; Adam moments
  2e-4 of each tensor's largest magnitude; params 1e-6 where |g| is above
  2% of the tensor's largest gradient and above 1e-6, and 2 lr + 1e-6
  everywhere (``test_torch_port_step.py``: XLA and PyTorch sum
  convolutions in other orders, cos/sin of the affine coefficients may
  differ by an ulp, and Adam's first step moves a param by about +-lr
  whatever |g|, so a tiny gradient's sign may differ). The gradients are
  read from the first Adam moment, ``m = (1 - b1) g`` after one step from
  zero. That gradient tolerance needs test points where each step's
  gradient is a smooth function of the model's input, which at 64^2 with
  batch 2 most random points are not (``test_torch_port_balance.py``: a
  ReLU input near zero switches its gradient on or off, and at 2x2 maps
  with batch 2 one switch moves a channel's gradient by up to an eighth).
  The swap step needs more margin than the denoise step: each framework
  makes its own fake, and the two fakes differ by about 1e-5 of their
  largest magnitude (train-mode BN over 8 values a channel in the
  deepest layers). With the flax-style random weights of the other port
  tests, a 1e-6 perturbation of the input moved the port's gradients by
  about 1% even in float64, and at 40 candidate points of model a's swap
  update none came within 4e-3 of JAX's. So the weights here raise every
  BN bias by ``BN_SHIFT`` = 1 (most ReLU inputs then lie clear of zero),
  and each identity's data, weight and shadow seeds were picked, out of 16
  candidates each, by running these steps: at the picks JAX's and the
  port's gradients came within 1.4e-5-2.6e-5 of each tensor's largest
  entry, where other candidates differed by up to 42% (against a float64
  run of the denoiser's step, both fp32 gradients lie within 3e-5:
  ``test_torch_port_step.py``). The raised biases give the convolutions'
  inputs positive means, so the flax-style batch variance
  ``E[x^2] - E[x]^2`` cancels more: the new BN running stats are held to
  3e-5 relative (measured up to 1.6e-5 over the candidates; 1e-5 in
  ``test_torch_port_step.py``);
* the shadows after a blending swap step: 1e-6 relative, plus, for model
  a's shadow weights, (1 - beta) (2 lr) absolute: ``ema_a`` blends a's
  post-step params, which carry the 2 lr sign-flip differences above,
  damped by 1 - beta = 1e-4. ``ema_step`` is set so that the decay is
  ``ema_beta``. A shadow forward that wrote its BN statistics would move
  its buffers by 10% of the batch statistics' distance from them;
* ``ema_decay`` equal as fp32; ``ema_update`` within one ulp (XLA may
  contract the blend into a multiply-add);
* eval-mode forwards (``make_predict_fake``, the carried weights) 1e-5 of
  the output's largest magnitude.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu import config as jax_config
from denoising_diffusion_deep_fake_tpu.ops.losses import mse_loss
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu.ops.pallas.warp_fused import (
    affine_warp_pallas_fused,
)
from denoising_diffusion_deep_fake_tpu.training import ema as jax_ema
from denoising_diffusion_deep_fake_tpu.training.deep_fake import (
    DeepFakeTrainer as JaxDeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu.training.optim import (
    make_adam_with_cosine,
)
from denoising_diffusion_deep_fake_tpu.training.state import (
    ModelState as JaxModelState,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.training import ema as port_ema
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
    noise_offset,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    shadow_tensors,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    load_jax_state,
    state_dict_from_jax,
)

from test_torch_port_model import random_flax_variables

ROOT = Path(__file__).resolve().parent.parent
ENCODER, B, S = "resnet18", 2, 64
LR, B1, SPE, T_MAX = 0.02, 0.5, 10, 100
BETA = 0.9999
STATS = {"a": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
         "b": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))}
APPLY = {"a": (True, True), "b": (True, False)}
# Past update_after_step far enough that the decay is clipped to beta.
BLENDING_EMA_STEP = 10 ** 7
BN_SHIFT = 1.0
# Data seeds and weight seeds (model, and shadow in swap mode) of each
# identity: points where the step's gradients are smooth functions of the
# model's input (see the module notes).
SEEDS = {
    "denoise": {"data": {"a": 114, "b": 200},
                "weights": {"a": 100, "b": 201}},
    "swap": {"data": {"a": 302, "b": 503}, "weights": {"a": 300, "b": 500},
             "shadow": {"a": 601, "b": 400}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the test run's workers share the cores, and
    torch's own pool on each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(mode):
    return dict(mode=mode, data_path_a="a.txt", data_path_b="b.txt",
                batch_size=B, learning_rate=LR, adam_b1=B1,
                max_epochs=T_MAX, encoder_name=ENCODER,
                compute_dtype="float32", mean_a=STATS["a"][0],
                std_a=STATS["a"][1], mean_b=STATS["b"][0],
                std_b=STATS["b"][1], ema_beta=BETA,
                noise_exponential_sampling_lambda=8,
                warp_method="pallas_fused")


def _port_trainer(mode):
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig,
                                       _cfg_dict(mode))
    return DeepFakeTrainer(cfg, steps_per_epoch=SPE, image_size=S,
                           device="cpu")


def _variables(model, seed):
    v = random_flax_variables(model, S, seed=seed)
    # Predictions inside the loss's clamp, as in test_torch_port_step.py.
    head = v["params"]["segmentation_head"]
    head["kernel"] = head["kernel"] * 0.1

    # BN biases raised by BN_SHIFT: fewer ReLU inputs near zero (module
    # notes).
    def shift(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] == "bias" and "segmentation_head" not in keys:
            return leaf + BN_SHIFT
        return leaf

    v["params"] = jax.tree_util.tree_map_with_path(shift, v["params"])
    return v


class _Jax:
    """The JAX trainer and its pieces, each jitted once."""

    def __init__(self):
        cfg = jax_config.config_from_dict(jax_config.DeepFakeConfig,
                                          _cfg_dict("swap"))
        self.trainer = JaxDeepFakeTrainer(cfg, steps_per_epoch=SPE,
                                          image_size=S)
        # Unflattened moments, so each can be compared by name.
        self.trainer.tx = make_adam_with_cosine(
            LR, b1=B1, cosine_t_max=T_MAX, steps_per_epoch=SPE,
            flatten=False)
        self.model = self.trainer.model
        tr = self.trainer

        def train_one(state, noisy, target):
            new, loss, _ = tr._train_one_model(state, noisy, target)
            return new, loss

        self._train_one = jax.jit(train_one)
        self.ema_forward = jax.jit(tr._ema_forward)
        self.update_ema = jax.jit(lambda s: s.update_ema(tr.ema_cfg))

    def train_one(self, state, noisy, target):
        """``_train_one_model`` on the state without its shadow (one
        compiled program for both modes), the shadow carried over."""
        bare = state.replace(ema_params=None, ema_batch_stats=None,
                             ema_step=None)
        new, loss = self._train_one(bare, noisy, target)
        return new.replace(ema_params=state.ema_params,
                           ema_batch_stats=state.ema_batch_stats,
                           ema_step=state.ema_step), float(loss)

    def state(self, seed, ema_seed=None, ema_step=0, step=0):
        v = _variables(self.model, seed)
        s = JaxModelState(step=jnp.int32(step), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=self.trainer.tx.init(v["params"]))
        if ema_seed is not None:
            e = _variables(self.model, ema_seed)
            s = s.replace(ema_params=e["params"],
                          ema_batch_stats=e["batch_stats"],
                          ema_step=jnp.int32(ema_step))
        return s


@pytest.fixture(scope="module")
def jx():
    return _Jax()


def _identity_inputs(name, seed):
    """uint8 batch, affine params, ratios and noise of one identity."""
    rng = np.random.default_rng(seed)
    return dict(
        u8=rng.integers(0, 256, (B, S, S, 3), np.uint8),
        params={
            "angle": rng.uniform(-15, 15, B).astype(np.float32),
            "scale": rng.uniform(0.9, 1.1, B).astype(np.float32),
            "tx": rng.uniform(-0.2, 0.2, B).astype(np.float32),
            "ty": rng.uniform(-0.2, 0.2, B).astype(np.float32),
            "apply": np.asarray(APPLY[name]),
        },
        ratios=rng.uniform(0.0, 0.6, B).astype(np.float32),
        noise=rng.standard_normal((B, S, S, 3)).astype(np.float32))


def _inputs(seeds):
    return {name: _identity_inputs(name, seeds[name]) for name in ("a", "b")}


def _jax_real(inputs, name):
    mean, std = STATS[name]
    x = inputs[name]
    return affine_warp_pallas_fused(
        jnp.asarray(x["u8"]),
        {k: jnp.asarray(v) for k, v in x["params"].items()},
        mean=mean, std=std, interpret=True)


def _jax_noisy(inputs, name, image):
    x = inputs[name]
    return blend_noise(image, jnp.asarray(x["noise"]),
                       jnp.asarray(x["ratios"]).reshape(B, 1, 1, 1))


def _port_step(trainer, states, inputs):
    def per(key, conv):
        return {n: conv(inputs[n][key]) for n in ("a", "b")}

    return trainer.train_step(
        states, torch.from_numpy(inputs["a"]["u8"]),
        torch.from_numpy(inputs["b"]["u8"]),
        affine_params=per("params", lambda p: {
            k: torch.from_numpy(v) for k, v in p.items()}),
        ratios=per("ratios", torch.from_numpy),
        noise=per("noise", torch.from_numpy))


def _load(trainer, jax_states, with_ema):
    states = trainer.init_states(seed=0, with_ema=with_ema)
    for name, s in jax_states.items():
        load_jax_state(states[name], jax.device_get(s))
    return states


def _jax_states(jx, mode):
    seeds = SEEDS[mode]
    return {name: jx.state(seeds["weights"][name],
                           ema_seed=seeds.get("shadow", {}).get(name),
                           ema_step=BLENDING_EMA_STEP)
            for name in ("a", "b")}


@pytest.fixture(scope="module")
def swap_step(jx):
    inputs = _inputs(SEEDS["swap"]["data"])
    js = _jax_states(jx, "swap")
    port_states = _load(_port_trainer("swap"), js, with_ema=False)
    metrics = _port_step(_port_trainer("swap"), port_states, inputs)

    real = {n: _jax_real(inputs, n) for n in ("a", "b")}
    want, before = {}, dict(js)
    for name, other in (("a", "b"), ("b", "a")):
        js[other] = jx.update_ema(js[other])
        fake = jx.ema_forward(js[other], real[name])
        want[f"swap_difference/{name}"] = float(mse_loss(real[name], fake))
        js[name], want[f"loss_swap/train_{name}"] = jx.train_one(
            js[name], _jax_noisy(inputs, name, fake), real[name])
    return port_states, metrics, js, want, before


@pytest.fixture(scope="module")
def denoise_step(jx):
    inputs = _inputs(SEEDS["denoise"]["data"])
    js = _jax_states(jx, "denoise")
    port_states = _load(_port_trainer("denoise"), js, with_ema=False)
    metrics = _port_step(_port_trainer("denoise"), port_states, inputs)
    want, before = {}, dict(js)
    for name in ("a", "b"):
        real = _jax_real(inputs, name)
        js[name], want[f"loss_denoise/train_{name}"] = jx.train_one(
            js[name], _jax_noisy(inputs, name, real), real)
    return port_states, metrics, js, want, before


def _named(tree, stats=None):
    return {k: v.numpy() for k, v in
            state_dict_from_jax(tree, {} if stats is None else stats).items()}


def _check_model(port_state, jax_state):
    """Gradients, BN stats, Adam moments and params after one update, at
    the tolerances of test_torch_port_step.py."""
    adam = jax_state.opt_state[0]
    mu, nu = _named(adam.mu), _named(adam.nu)
    want_params = _named(jax_state.params)
    want_stats = _named({}, jax_state.batch_stats)
    opt = port_state.optimizer
    assert port_state.step == int(jax_state.step) == 1
    for name, p in port_state.model.named_parameters():
        g = mu[name] / (1.0 - B1)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=name)
        st = opt.state[p]
        for got, want in ((st["exp_avg"], mu[name]),
                          (st["exp_avg_sq"], nu[name])):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=2e-4 * np.abs(want).max() + 1e-20, err_msg=name)
        diff = np.abs(p.detach().numpy() - want_params[name])
        assert diff.max() <= 2 * LR + 1e-6, name
        clear = (np.abs(g) > 2e-2 * np.abs(g).max()) & (np.abs(g) > 1e-6)
        assert diff[clear].max(initial=0.0) <= 1e-6, name
    sd = port_state.model.state_dict()
    assert want_stats
    for name, w in want_stats.items():
        np.testing.assert_allclose(sd[name].numpy(), w, rtol=3e-5,
                                   atol=1e-6, err_msg=name)


def test_swap_step_losses_and_differences_match(swap_step):
    _, metrics, _, want, _ = swap_step
    assert set(metrics) == set(want) | {"lr"} and metrics["lr"] == LR
    for key, value in want.items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["a", "b"])
def test_swap_step_models_match(swap_step, name):
    port_states, _, js, _, _ = swap_step
    _check_model(port_states[name], js[name])


@pytest.mark.parametrize("name", ["a", "b"])
def test_swap_step_shadows_match(swap_step, name):
    port_states, _, js, _, before = swap_step
    state, jstate = port_states[name], js[name]
    assert state.ema_step == int(jstate.ema_step) == BLENDING_EMA_STEP + 1
    weights = _named(jstate.ema_params)
    stats = _named({}, jstate.ema_batch_stats)
    old_stats = _named({}, before[name].ema_batch_stats)
    # a's shadow blends a's post-step params (see the module docstring).
    slack = (1 - BETA) * 2 * LR if name == "a" else 0.0
    for key, value in state.ema_model.state_dict().items():
        got = value.numpy()
        if key in stats:
            np.testing.assert_allclose(got, stats[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
            # The blend moved the buffers off their old values.
            assert not np.array_equal(got, old_stats[key]), key
        else:
            np.testing.assert_allclose(got, weights[key], rtol=1e-6,
                                       atol=slack + 1e-7, err_msg=key)


def test_swap_step_order_copies_at_ema_step_zero():
    trainer = _port_trainer("swap")
    states = trainer.init_states(seed=3)
    # Shadows apart from their models, so a copy shows.
    for i, s in enumerate(states.values()):
        other = trainer.init_states(seed=10 + 2 * i, with_ema=False)["a"]
        s.ema_model.load_state_dict(other.model.state_dict())
    b_before = [t.clone() for t in shadow_tensors(states["b"].model)]
    _port_step(trainer, states, _inputs(SEEDS["swap"]["data"]))
    for got, want in zip(shadow_tensors(states["b"].ema_model), b_before):
        assert torch.equal(got, want)
    for got, want in zip(shadow_tensors(states["a"].ema_model),
                         shadow_tensors(states["a"].model)):
        assert torch.equal(got, want)
    assert states["a"].ema_step == states["b"].ema_step == 1
    # b's model moved, so its shadow holds the pre-step weights.
    assert not all(torch.equal(x, y) for x, y in zip(
        b_before, shadow_tensors(states["b"].model)))


def test_denoise_step_losses_match(denoise_step):
    port_states, metrics, _, want, _ = denoise_step
    assert set(metrics) == set(want) | {"lr"}
    for key, value in want.items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=1e-5,
                                   err_msg=key)
    assert not any(s.has_ema for s in port_states.values())


@pytest.mark.parametrize("name", ["a", "b"])
def test_denoise_step_models_match(denoise_step, name):
    port_states, _, js, _, _ = denoise_step
    _check_model(port_states[name], js[name])


STEPS = (0, 99, 100, 101, 102, 1000, 10 ** 6)


@pytest.mark.parametrize("update_every", [1, 3])
def test_ema_decay_and_update_match_jax(update_every):
    cfg_kw = dict(beta=BETA, update_every=update_every, update_after_step=100)
    jcfg, pcfg = jax_ema.EmaConfig(**cfg_kw), port_ema.EmaConfig(**cfg_kw)
    rng = np.random.default_rng(5)
    for step in STEPS:
        want = np.float32(jax_ema.ema_decay(step, jcfg))
        got = port_ema.ema_decay(step, pcfg)
        assert got.dtype == np.float32 and got == want, step
        ema = [rng.standard_normal((3, 5)).astype(np.float32),
               rng.standard_normal(7).astype(np.float32)]
        online = [rng.standard_normal(e.shape).astype(np.float32)
                  for e in ema]
        want_t, want_step = jax_ema.ema_update(
            [jnp.asarray(e) for e in ema], [jnp.asarray(p) for p in online],
            jnp.int32(step), jcfg)
        got_t = [torch.from_numpy(e.copy()) for e in ema]
        got_step = port_ema.ema_update(
            got_t, [torch.from_numpy(p) for p in online], step, pcfg)
        assert got_step == int(want_step) == step + 1
        for g, w, e in zip(got_t, want_t, ema):
            w = np.asarray(w)
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert (np.abs(g.numpy() - w) <= ulp).all(), step
            if step % update_every:
                assert np.array_equal(g.numpy(), e), step


def test_init_states_and_ensure_ema():
    denoise, swap = _port_trainer("denoise"), _port_trainer("swap")
    assert not any(s.has_ema for s in denoise.init_states(0).values())
    assert all(s.has_ema for s in swap.init_states(0).values())
    assert all(s.has_ema for s in
               denoise.init_states(0, with_ema=True).values())
    assert not any(s.has_ema for s in
                   swap.init_states(0, with_ema=False).values())

    states = denoise.init_states(1)
    a, b = states["a"].model.state_dict(), states["b"].model.state_dict()
    assert not torch.equal(a["segmentation_head.0.weight"],
                           b["segmentation_head.0.weight"])
    states["a"].ema_step = 5
    states["a"].attach_ema()
    kept = states["a"].ema_model
    swap.ensure_ema(states)
    assert states["a"].ema_model is kept
    for s in states.values():
        assert s.ema_step == 0
        for e, p in zip(shadow_tensors(s.ema_model), shadow_tensors(s.model)):
            assert torch.equal(e, p) and e.data_ptr() != p.data_ptr()
            assert not e.requires_grad
    # Copies, not aliases: moving the model leaves the shadow.
    with torch.no_grad():
        next(states["b"].model.parameters()).add_(1.0)
    assert not torch.equal(next(states["b"].model.parameters()),
                           next(states["b"].ema_model.parameters()))


def test_shadow_forward_writes_no_bn_stats():
    trainer = _port_trainer("swap")
    state = trainer.init_states(seed=2)["a"]
    before = [t.clone() for t in state.ema_model.buffers()]
    x = torch.randn((B, S, S, 3), generator=torch.Generator().manual_seed(1))
    fake = trainer._ema_forward(state, x)
    assert not fake.requires_grad
    for got, want in zip(state.ema_model.buffers(), before):
        assert torch.equal(got, want)
    # The online model (same weights) in train mode normalises alike.
    with torch.no_grad():
        torch.testing.assert_close(state.model.train()(x), fake)
    assert not all(torch.equal(got, want)
                   for got, want in zip(state.model.buffers(), before))


def test_noise_offsets_are_distinct():
    offsets = [noise_offset(step, name) for step in range(1001)
               for name in ("a", "b")]
    assert len(set(offsets)) == len(offsets)
    assert noise_offset(7, "a") != noise_offset(7, "b")


@pytest.mark.parametrize("use_ema", [False, True])
def test_whole_state_carry_and_predict_fake(jx, use_ema):
    """A JAX swap-mode state with distinct online and shadow weights
    crosses whole: step, ema_step, and both eval-mode forwards."""
    js = jx.state(51, ema_seed=52, ema_step=123, step=45)
    trainer = _port_trainer("swap")
    state = trainer.init_states(seed=0, with_ema=False)["a"]
    load_jax_state(state, jax.device_get(js))
    assert (state.step, state.ema_step) == (45, 123) and state.has_ema
    x = np.random.default_rng(6).uniform(-1, 1, (B, S, S, 3)).astype(
        np.float32)
    want = np.asarray(jx.trainer.make_predict_fake(use_ema=use_ema)(
        js, jnp.asarray(x)))
    other = np.asarray(jx.trainer.make_predict_fake(use_ema=not use_ema)(
        js, jnp.asarray(x)))
    got = trainer.make_predict_fake(use_ema=use_ema)(state,
                                                     torch.from_numpy(x))
    assert got.shape == (B, S, S, 3) and got.dtype == torch.float32
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert np.abs(want - other).max() > 1e3 * tol


def test_deep_fake_yamls_load_like_the_jax_package():
    denoise_path = ROOT / "configs" / "denoise.yml"
    port = port_config.load_config(port_config.DeepFakeConfig, denoise_path)
    ref = jax_config.load_config(jax_config.DeepFakeConfig, denoise_path)
    with open(ROOT / "configs" / "swap.yml") as f:
        swap = yaml.safe_load(f)
    port_swap = port_config.overlay_config(
        port_config.DeepFakeConfig, dataclasses.asdict(port), swap)
    ref_swap = jax_config.overlay_config(
        jax_config.DeepFakeConfig, jax_config.config_to_dict(ref), swap)
    jax_fields = {f.name for f in dataclasses.fields(ref)}
    fields = [f.name for f in dataclasses.fields(port)
              if f.name in jax_fields]
    assert {"mode", "mean_a", "std_b", "ema_beta", "aug_probability",
            "noise_exponential_sampling_lambda"} <= set(fields)
    for p, r in ((port, ref), (port_swap, ref_swap)):
        for field in fields:
            assert getattr(p, field) == getattr(r, field), field
    assert (port.mode, port_swap.mode) == ("denoise", "swap")
    assert port_swap.cosine_t_max == 200 and port_swap.data_path_a
