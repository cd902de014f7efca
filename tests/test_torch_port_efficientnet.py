"""EfficientNet-b0..b7 in the port against the JAX package's, on the CPU.

* Structure, all eight names: the tables, the U-Net's keys and shapes
  (the JAX package's torch replica under smp's names, on the meta device),
  parameter counts (``tests/test_models.py``'s pins for b0, b4 and b7,
  ``jax.eval_shape`` for the rest), ``out_channels``, the stage taps and
  the blocks that drop.
* Forward: b0's U-Net from the same weights (flax variables filled from a
  numpy seed, carried by ``utils/jax_weights.py``) in train mode without
  drop and in eval mode; 2e-4 of the output's largest magnitude, the BN
  running statistics 1e-5 relative (``test_torch_port_model.py`` says why).
* Stochastic depth: JAX's encoder draws its masks with
  ``jax.random.bernoulli``; the module's ``jax`` is replaced for the test
  (``monkeypatch``, no file of the JAX package changes) by a proxy whose
  ``random.bernoulli`` returns the test's masks and records its ``p``. The
  same masks go to the port: outputs and BN statistics agree, and the
  port's keep probabilities are the recorded ``p``s. In bf16 the scale
  ``1 / keep`` rounds as JAX's weakly typed division rounds it.
* A b0 denoiser step with drop on against JAX's composed step, on injected
  affine params, ratios, noise and masks: the loss 1e-5 relative, every
  gradient 1e-5 of its tensor's largest, the new BN statistics 1e-5
  relative. The U-Net runs in float64 on both sides (the warp, the noise
  and the loss stay fp32): in fp32 b0's gradients at batch 2 differ
  between the frameworks by up to ~1% of a tensor's largest at any point
  tried (its BNs at the 2x2 level normalise 8 values), where in float64
  they agree to ~5e-8, as ``test_torch_port_encoder_steps.py`` holds the
  other families' steps.
* The trainers: masks go to the gradient forwards only (the balancer's
  scoring, the deep-fake shadows' fakes and every eval forward get none
  and draw nothing); ``remat`` none / dots / full are bit-equal with drop
  on; a K = 3 call equals 3 single steps, the generator included.
* A b0 reference ``.ckpt`` imported (as JAX's importer reads it),
  exported and imported again bit-equal; a file that carries
  efficientnet-pytorch's classifier head is refused, as JAX refuses it.

64^2 (the trainers' checks 32^2), batch 2, torch on one thread.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from denoising_diffusion_deep_fake_tpu.models import create_unet as jax_unet
from denoising_diffusion_deep_fake_tpu.models import efficientnet as jax_eff
from denoising_diffusion_deep_fake_tpu.models import unet as jax_unet_mod
from denoising_diffusion_deep_fake_tpu.ops.losses import mse_ssim_loss
from denoising_diffusion_deep_fake_tpu.ops.noise import blend_noise
from denoising_diffusion_deep_fake_tpu.ops.pallas.warp_fused import (
    affine_warp_pallas_fused,
)
from denoising_diffusion_deep_fake_tpu.utils import torch_import as jax_import
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.models import efficientnet
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    EFFICIENTNET_NAMES,
    Unet,
    create_unet,
)
from denoising_diffusion_deep_fake_tpu_torch.training import state as tstate
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.utils import jax_weights
from denoising_diffusion_deep_fake_tpu_torch.utils.jax_weights import (
    state_dict_from_jax,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_export import (
    export_reference_checkpoint,
)
from denoising_diffusion_deep_fake_tpu_torch.utils.torch_import import (
    import_reference_checkpoint,
)

from test_torch_port_checkpoint_io import write_reference_ckpt
from test_torch_port_encoder_families import _replica_shapes
from test_torch_port_model import random_flax_variables

B0, B, S = "efficientnet-b0", 2, 64
# tests/test_models.py::test_vgg_mobilenet_param_count's pins.
PINNED = {"efficientnet-b0": 5_839_599, "efficientnet-b4": 19_419_579,
          "efficientnet-b7": 65_452_099}
LR, SPE, T_MAX = 0.02, 10, 100
MEAN = STD = (0.5, 0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: a b0 pair's reference
    checkpoint and its conversions weigh ~370 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------- structure


def test_tables_are_jax_tables():
    assert efficientnet._BASE_BLOCKS == jax_eff._BASE_BLOCKS
    assert efficientnet.EFFICIENTNET_SPECS == jax_eff.EFFICIENTNET_SPECS
    assert efficientnet._SMP_STAGE_IDXS == jax_eff._SMP_STAGE_IDXS
    assert efficientnet._DROP_CONNECT_RATE == jax_eff._DROP_CONNECT_RATE
    assert EFFICIENTNET_NAMES == tuple(jax_eff.EFFICIENTNET_SPECS)
    for name in EFFICIENTNET_NAMES:
        assert efficientnet.block_layout(name) == jax_eff.block_layout(name)
    for n in (3, 32, 33, 64, 100, 448):
        for k, s in ((3, 1), (3, 2), (5, 1), (5, 2)):
            assert (efficientnet._same_pads(n, k, s),
                    efficientnet._same_pads(n + 1, k, s)) == \
                jax_eff._same_padding(n, n + 1, k, s)


@pytest.mark.parametrize("name", EFFICIENTNET_NAMES)
def test_unet_keys_counts_channels_and_taps(name):
    with torch.device("meta"):
        port = create_unet(name)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == _replica_shapes(name)
    n = tstate.param_count(port)
    if name in PINNED:
        assert n == PINNED[name]
    else:
        shapes = jax.eval_shape(lambda: jax_unet(name).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
        assert n == sum(int(np.prod(v.shape))
                        for v in jax.tree.leaves(shapes["params"]))
    jax_encoder = jax_unet_mod.make_encoder(name)
    assert tuple(port.encoder.out_channels) == tuple(jax_encoder.out_channels)
    assert port.encoder.taps == jax_eff.stage_idxs(name)
    # The blocks that drop: the residual ones past the first.
    layout = jax_eff.block_layout(name)
    want = [i for i, b in enumerate(layout) if i > 0 and b["stride"] == 1
            and b["cin"] == b["cout"]]
    assert [i for i, _ in port.encoder.drops] == want
    assert port.drop_keep_probs() == tuple(
        1.0 - 0.2 * i / len(layout) for i in want)
    assert port.encoder.conv_init == "torch"


# ---------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def b0():
    flax_model = jax_unet(B0)
    variables = random_flax_variables(flax_model, S, seed=0)
    x = np.random.default_rng(1).standard_normal((B, S, S, 3)).astype(
        np.float32)
    return flax_model, variables, x


def _port(variables):
    port = create_unet(B0)
    port.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], B0))
    return port


def _train_forward(flax_model, variables, x, rngs=None):
    fn = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=True, mutable=["batch_stats"], rngs=rngs))
    out, mutated = fn(variables, x)
    return np.asarray(out), mutated["batch_stats"]


def _stats_close(port, stats):
    want = state_dict_from_jax({}, stats, B0)
    sd = port.state_dict()
    assert want
    for key, w in want.items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_b0_forward_matches_jax_in_train_and_eval_mode(b0):
    flax_model, variables, x = b0
    port = _port(variables).eval()
    want_eval, (want, mutated) = jax.jit(lambda v, x: (
        flax_model.apply(v, x, train=False),
        flax_model.apply(v, x, train=True, mutable=["batch_stats"])))(
            variables, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want_eval, 2e-4, "eval")
    stats = mutated["batch_stats"]
    port.train()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, 2e-4, "train")
    _stats_close(port, stats)


# -------------------------------------------------------- stochastic depth


class _Random:
    """``jax.random`` whose ``bernoulli`` returns the given masks in call
    order and records each ``p``."""

    def __init__(self, masks):
        self.masks, self.ps = masks, []

    def bernoulli(self, key, p, shape):
        self.ps.append(p)
        return jnp.asarray(self.masks[len(self.ps) - 1]).reshape(shape)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    """``jax`` with ``random`` replaced."""

    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def jax_masks(monkeypatch):
    """``install(masks)``: JAX's EfficientNet draws ``masks`` (one row a
    dropping block, in block order); returns the recorder."""
    def install(masks):
        random = _Random(masks)
        monkeypatch.setattr(jax_eff, "jax", _Jax(random))
        return random

    return install


def _masks(name, seed):
    """Masks with drops in both samples: one row a dropping block."""
    n = len(efficientnet.drop_blocks(name))
    masks = np.random.default_rng(seed).random((n, B)) < 0.6
    assert not masks.all(axis=0).any()
    return masks


def test_stochastic_depth_matches_jax(b0, jax_masks):
    flax_model, variables, x = b0
    masks = _masks(B0, seed=3)
    recorder = jax_masks(masks)
    want, stats = _train_forward(flax_model, variables, x,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
    port = _port(variables).train()
    assert recorder.ps == list(port.drop_keep_probs())
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(masks))
        plain = _port(variables).train()(torch.from_numpy(x))
    _close(got, want, 2e-4, "dropped")
    _stats_close(port, stats)
    # The masks moved the output.
    assert np.abs(plain.numpy() - want).max() > 1e-2 * np.abs(want).max()


def test_drop_scale_rounds_as_jax_in_each_dtype():
    for _, keep in efficientnet.drop_blocks(EFFICIENTNET_NAMES[-1]):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            want = float(jnp.ones((), jdt) / keep)
            assert efficientnet._drop_scale(keep, tdt) == want, (keep, jdt)


def test_masks_only_for_a_family_that_drops():
    with torch.device("meta"):
        model = create_unet("resnet18")
    assert model.drop_keep_probs() == ()
    with pytest.raises(ValueError, match="no block that drops"):
        model(torch.zeros((B, 32, 32, 3)), torch.ones((1, B), dtype=bool))
    port = create_unet(B0)
    with pytest.raises(ValueError, match="9 blocks that drop"):
        port(torch.zeros((B, 32, 32, 3)), torch.ones((3, B), dtype=bool))


# ---------------------------------------------------------- the train step


def composed_steps(encoder, *, patchify=1, masks=None):
    """The composed JAX step and ``DenoiserTrainer.train_step`` on the
    same weights and draws (``test_torch_port_step.py``'s composition;
    ``masks``, when given, injected into JAX's bernoulli and given to the
    port), the U-Net in float64 on both sides between the fp32 warp and
    noise and the fp32 loss. Returns JAX's loss, gradients and new BN
    statistics, the port's state after its step, its metrics and its
    parameters before the step."""
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    params = {
        "angle": rng.uniform(-15, 15, B).astype(np.float32),
        "scale": rng.uniform(0.8, 1.2, B).astype(np.float32),
        "tx": rng.uniform(-0.2, 0.2, B).astype(np.float32),
        "ty": rng.uniform(-0.2, 0.2, B).astype(np.float32),
        "apply": np.ones(B, bool),
    }
    ratios = rng.uniform(0.0, 0.6, B).astype(np.float32)
    noise = rng.standard_normal((B, S, S, 3)).astype(np.float32)

    variables = random_flax_variables(jax_unet(encoder, patchify=patchify),
                                      S, seed=12)
    image = affine_warp_pallas_fused(
        jnp.asarray(u8), {k: jnp.asarray(v) for k, v in params.items()},
        mean=MEAN, std=STD, interpret=True)
    noisy = blend_noise(image, jnp.asarray(noise),
                        jnp.asarray(ratios).reshape(B, 1, 1, 1))
    saved = jax_eff.jax
    if masks is not None:
        jax_eff.jax = _Jax(_Random(masks))
    try:
        with jax.enable_x64(True):
            model = jax_unet(encoder, dtype=jnp.float64, patchify=patchify)
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)

            def loss_fn(p):
                pred, mutated = model.apply(
                    {"params": p, "batch_stats": v64["batch_stats"]},
                    noisy, train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(5)})
                return mse_ssim_loss(pred, image), mutated["batch_stats"]

            (loss, new_bs), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(v64["params"])
            grads, new_bs = jax.tree.map(np.asarray, (grads, new_bs))
    finally:
        jax_eff.jax = saved
    jax_side = dict(loss=float(loss), grads=grads, batch_stats=new_bs)

    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="unused", batch_size=B, learning_rate=LR,
        max_epochs=T_MAX, encoder_name=encoder, compute_dtype="float32",
        mean=MEAN, std=STD, warp_method="pallas_fused",
        patchify_stem=patchify))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=SPE, image_size=S,
                              device="cpu")
    state = trainer.init_state(seed=0)
    state.model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], encoder, patchify))
    state.model.double().dtype = torch.float64
    if patchify > 1:
        state.model.unet.dtype = torch.float64
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    metrics = trainer.train_step(
        state, torch.from_numpy(u8),
        affine_params={k: torch.from_numpy(v) for k, v in params.items()},
        ratios=torch.from_numpy(ratios), noise=torch.from_numpy(noise),
        drop_masks=None if masks is None else torch.from_numpy(masks))
    return jax_side, state, metrics, before


def _carry(tree, stats, encoder, patchify):
    """flax float64 trees under the port's keys, in float64."""
    plan, _ = jax_weights._inversion_plan(encoder, patchify)
    prefix = "unet." if patchify > 1 else ""
    out = {}
    for tree_name, t in (("params", tree), ("batch_stats", stats)):
        if patchify > 1:
            t = t.get("unet", {})
        for path, value in jax_weights._flatten(t).items():
            _, key, how = plan[(tree_name,) + path]
            value = np.array(value, np.float64)
            out[prefix + key] = torch.from_numpy(np.ascontiguousarray(
                value.transpose(3, 2, 0, 1) if how == "kernel" else value))
    return out


def check_composed_steps(steps, encoder, patchify=1):
    """The loss 1e-5 relative, every gradient 1e-5 of its tensor's
    largest, the new BN statistics 1e-5 relative, each parameter moved by
    at most lr (Adam's first step)."""
    jax_side, state, metrics, before = steps
    assert state.step == 1 and metrics["lr"] == LR
    np.testing.assert_allclose(float(metrics["loss"]), jax_side["loss"],
                               rtol=1e-5)
    grads = _carry(jax_side["grads"], {}, encoder, patchify)
    params = dict(state.model.named_parameters())
    assert set(grads) == set(params)
    # A BN bias that feeds only train-mode BNs (EfficientNet's project
    # convs', directly or through the residual) has a zero gradient but
    # for rounding: both sides below 1e-9 of the model's largest there.
    floor = 1e-9 * max(np.abs(w.numpy()).max() for w in grads.values())
    for name, w in grads.items():
        got = params[name].grad
        if w.abs().max() < floor:
            assert got.abs().max() < floor, name
        else:
            _close(got, w.numpy(), 1e-5, name)
    stats = _carry({}, jax_side["batch_stats"], encoder, patchify)
    sd = state.model.state_dict()
    assert stats
    for key, w in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for name, p in params.items():
        assert (p.detach() - before[name]).abs().max() <= LR * (1 + 1e-6)


def test_b0_denoiser_step_with_drop_matches_jax():
    check_composed_steps(composed_steps(B0, masks=_masks(B0, seed=4)), B0)


# ------------------------------------------------------------ the trainers

T = 32  # the trainers' checks: 32^2, where b0's deepest level is 1x1


def _cfg(kind, **overrides):
    base = dict(batch_size=B, encoder_name=B0, compute_dtype="float32")
    if kind == "denoiser":
        return port_config.config_from_dict(port_config.DenoiserConfig, dict(
            base, input_image_list_path="x", **overrides))
    if kind == "balancer":
        return port_config.config_from_dict(port_config.BalanceConfig, dict(
            base, data_path="x", **overrides))
    return port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        base, data_path_a="a", data_path_b="b", mode="swap",
        ema_update_after_step=0, **overrides))


TRAINERS = {"denoiser": DenoiserTrainer, "balancer": BalanceTrainer,
            "swap": DeepFakeTrainer}


def _trainer(kind, **overrides):
    return TRAINERS[kind](_cfg(kind, **overrides), steps_per_epoch=10,
                          image_size=T, device="cpu")


def _batches(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (B, T, T, 3), dtype=torch.uint8,
                          generator=gen) for _ in range(n)]


def _init(trainer, kind):
    return (trainer.init_states(seed=0) if kind == "swap"
            else trainer.init_state(seed=0))


def _states(states):
    return list(states.values()) if isinstance(states, dict) else [states]


def _tensors(states) -> list:
    out = []
    for state in _states(states):
        out += list(state.model.state_dict().values())
        if state.has_ema:
            out += list(state.ema_model.state_dict().values())
        for st in state.optimizer.state_dict()["state"].values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


@pytest.fixture
def forwards(monkeypatch):
    """Every U-Net forward's model and masks (None or their shape)."""
    seen = []
    forward = Unet.forward

    def spy(self, x, drop_masks=None):
        seen.append((self, None if drop_masks is None
                     else tuple(drop_masks.shape)))
        return forward(self, x, drop_masks)

    monkeypatch.setattr(Unet, "forward", spy)
    return seen


def test_masks_only_in_the_gradient_forwards(forwards):
    """The denoiser's and balancer's step forwards and the swap pair's
    online forwards get masks; the shadows' fakes, the balancer's scoring
    and the eval forwards get none, and draw nothing."""
    n = (len(efficientnet.drop_blocks(B0)), B)
    for kind in ("denoiser", "balancer"):
        trainer = _trainer(kind)
        state = _init(trainer, kind)
        batch, = _batches(1)
        forwards.clear()
        trainer.train_step(state, batch)
        assert forwards == [(state.model, n)], kind
        forwards.clear()
        before = trainer.generator.get_state()
        if kind == "balancer":
            trainer.score_dataset(state, [(batch, np.arange(B))])
        else:
            trainer.make_denoise_fn()(state, torch.zeros((B, T, T, 3)))
        assert forwards == [(state.model, None)], kind
        assert torch.equal(trainer.generator.get_state(), before)
    trainer = _trainer("swap")
    states = _init(trainer, "swap")
    forwards.clear()
    trainer.train_step(states, *_batches(2))
    assert forwards == [(states["b"].ema_model, None), (states["a"].model, n),
                        (states["a"].ema_model, None), (states["b"].model, n)]
    forwards.clear()
    before = trainer.generator.get_state()
    for use_ema in (False, True):
        trainer.make_predict_fake(use_ema=use_ema)(
            states["a"], torch.zeros((B, T, T, 3)))
    assert [m for m, masks in forwards if masks is None] == [
        states["a"].model, states["a"].ema_model]
    assert torch.equal(trainer.generator.get_state(), before)


@pytest.mark.parametrize("kind", ["denoiser"])
def test_remat_policies_bit_equal_with_drop_on(kind, monkeypatch):
    drawn = []
    draw = tstate.draw_drop_masks

    def record(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    for module in ("denoiser", "deep_fake"):
        monkeypatch.setattr(
            f"denoising_diffusion_deep_fake_tpu_torch.training.{module}."
            "draw_drop_masks", record)
    runs = {}
    for policy in ("none", "dots", "full"):
        trainer = _trainer(kind, remat=policy)
        states = _init(trainer, kind)
        batches = _batches(2 if kind == "swap" else 1)
        metrics = trainer.train_step(states, *batches)
        runs[policy] = ([float(v) for k, v in metrics.items() if k != "lr"],
                        _tensors(states), trainer.generator.get_state())
    # Some block dropped a sample.
    assert drawn and not all(bool(m.all()) for m in drawn)
    want = runs["none"]
    for policy in ("dots", "full"):
        losses, tensors, gen = runs[policy]
        assert losses == want[0], policy
        for g, w in zip(tensors, want[1], strict=True):
            assert torch.equal(g, w), policy
        assert torch.equal(gen, want[2])


@pytest.mark.parametrize("kind", ["denoiser", "balancer"])
def test_k_step_call_matches_single_steps_with_drop_on(kind):
    single = _trainer(kind, remat="dots")
    want = _init(single, kind)
    n_args = 2 if kind == "swap" else 1
    batches = _batches(3 * n_args, seed=1)
    for j in range(3):
        single.train_step(want, *batches[j * n_args:(j + 1) * n_args])
    grouped = _trainer(kind, remat="dots")
    got = _init(grouped, kind)
    # The call takes the batches grouped per position (a0 a1 a2 b0 b1 b2).
    per_position = [batches[j * n_args + i] for i in range(n_args)
                    for j in range(3)]
    grouped.make_super_step(3)(got, *per_position)
    for g, w in zip(_states(got), _states(want)):
        assert g.step == w.step == 3
    for g, w in zip(_tensors(got), _tensors(want), strict=True):
        assert torch.equal(g, w)
    assert torch.equal(grouped.generator.get_state(),
                       single.generator.get_state())


def test_non_efficientnet_trainers_draw_as_before():
    for kind in TRAINERS:
        trainer = _trainer(kind, encoder_name="resnet18")
        assert trainer.drop_keep is None
    assert _trainer("balancer", encoder_name="resnet18").generator is None


# ---------------------------------------------------- checkpoints in and out


def test_b0_reference_checkpoint_round_trip(tmp_path):
    ckpt = tmp_path / "last.ckpt"
    sd = write_reference_ckpt(ckpt, B0, with_ema=True)
    imported = import_reference_checkpoint(ckpt, tmp_path / "in").parent
    want = jax_import.load_reference_checkpoint(ckpt)
    manager = CheckpointManager(imported)
    for ident in "ab":
        parts = manager.restore_partial(ident, ["model", "ema_model"],
                                        device="cpu")
        for name in ("model", "ema_model"):
            jax_sd = state_dict_from_jax(*want[f"{name}_{ident}"], B0)
            assert parts[name].keys() == jax_sd.keys()
            for key, value in jax_sd.items():
                assert torch.equal(parts[name][key], value), key
    out = tmp_path / "exported.ckpt"
    export_reference_checkpoint(imported, out)
    exported = torch.load(out, weights_only=False)["state_dict"]
    assert set(exported) == {k for k in sd if not k.startswith("criterion.")
                             and ".online_model." not in k}
    for key, value in exported.items():
        if key.endswith("num_batches_tracked"):
            assert value.item() == 0
        elif not key.endswith(("initted", ".step")):
            assert torch.equal(value, sd[key]), key
    again = import_reference_checkpoint(out, tmp_path / "again").parent
    for ident in "ab":
        got, want_parts = (CheckpointManager(d).restore_partial(
            ident, ["model", "ema_model"], device="cpu")
            for d in (again, imported))
        for name in ("model", "ema_model"):
            for key, value in want_parts[name].items():
                assert torch.equal(got[name][key], value), key


def test_classifier_head_keys_are_refused_as_jax_refuses_them(tmp_path):
    head = {"model_a.encoder._conv_head.weight": torch.zeros(1280, 320, 1, 1),
            "model_a.encoder._bn1.weight": torch.ones(1280),
            "model_a.encoder._fc.weight": torch.zeros(1000, 1280)}
    ckpt = tmp_path / "last.ckpt"
    write_reference_ckpt(ckpt, B0, with_ema=False, extra_keys=head)
    match = r"unmapped torch keys: \[.*'encoder._conv_head.weight'"
    with pytest.raises(ValueError, match=match):
        jax_import.load_reference_checkpoint(ckpt)
    with pytest.raises(ValueError, match=match):
        import_reference_checkpoint(ckpt, tmp_path / "out")
