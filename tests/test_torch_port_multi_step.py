"""``steps_per_call``: the port's K-step call against JAX's and against K
single steps, on the CPU.

``training/multi_step.py`` runs K steps a call: one CUDA graph replay on the
card, the same step function K times eagerly here (its plain version).
Held here:

* JAX's toy step cores of ``tests/test_multi_step.py`` (an integer batch
  checksum plus a draw keyed by the step counter), through JAX's
  ``make_super_step`` and, as torch, through the port's: the port's step
  takes JAX's per-step draws from its scalar rows, as its trainers take
  their noise offsets and learning rates, so the two agree exactly;
* the K-step call bit-equal to K single steps for the denoiser, the
  balancer and the deep-fake trainer in denoise and swap mode, the swap
  group crossing the EMA warm-up (decay 0, then above 0) inside a group:
  every weight, BN buffer, Adam moment and step, shadow, loss, counter and
  the generator's state;
* the port's ``_drive_epoch`` dispatching as JAX's, both driven by
  recording stubs (no model);
* ``fit_denoiser`` with ``steps_per_call: 2`` against 1: the same losses
  bit for bit, JAX's callback steps, one TensorBoard row a step;
* ``log_step(n_steps=K)``: one row a step, a NaN reported at its step;
* the device-scalar forms (EMA blend, noise offset) equal to the numbers.

The card's side (graph against eager, the kernels' device-offset launch) is
in ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` phase 12.
"""

import copy
import shutil
import sys
import types

import numpy as np
import pytest
import torch

import jax

import test_multi_step as jax_tests
from helpers import make_image_dataset

from denoising_diffusion_deep_fake_tpu.training import runners as jax_runners
from denoising_diffusion_deep_fake_tpu.training.multi_step import (
    make_super_step as jax_make_super_step,
)
from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    reset_for_modify,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda import noise_kernel
from denoising_diffusion_deep_fake_tpu_torch.training import runners
from denoising_diffusion_deep_fake_tpu_torch.training.balance import (
    BalanceTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.ema import (
    EmaConfig,
    ema_blend,
    ema_scalars,
)
from denoising_diffusion_deep_fake_tpu_torch.training.loop import (
    LoopContext,
    TrainingDivergedError,
)
from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
    make_super_step,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import make_adam
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    ensure_adam_state,
    graph_objects,
)

S, B = 64, 2


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied after the test: the runners' checkpoints and
    event files would stay on disk until pytest drops the run's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ JAX's toy cores


class _ToyState:
    """The port's form of JAX's ``_ToyState``: the counter on the host,
    the sum on the device."""

    def __init__(self):
        self.step = 0
        self.acc = torch.zeros((), dtype=torch.int64)


def _jax_draw(rng, step: int) -> int:
    """JAX's toy draw at ``step`` (``_toy_core``: a key folded with the
    step), made on the host as the port's trainers make their offsets."""
    return int(jax.random.randint(jax.random.fold_in(rng, step), (), 0,
                                  1 << 20))


def _toy_core(state, batch, scalars, generator):
    checksum = batch.to(torch.int64).sum() + scalars["draw"]
    state.acc += checksum
    return {"checksum": checksum,
            "step": torch.tensor(scalars["step"], dtype=torch.int64)}


def _advance(states, k):
    for state in (states.values() if isinstance(states, dict) else [states]):
        state.step += k


def _toy_step(rng, k):
    return make_super_step(
        _toy_core, k, scalars=lambda state, j: {
            "step": state.step + j, "draw": _jax_draw(rng, state.step + j)},
        advance=_advance, generator=None, device="cpu")


def test_toy_core_super_step_equals_jax():
    k, rng = 3, jax.random.PRNGKey(5)
    batches = jax_tests._batches(k)
    state_j, stacked_j = jax_make_super_step(jax_tests._toy_core, k,
                                             donate=False)(
        jax_tests._toy_init(), *batches, rng)
    single = _toy_step(rng, 1)
    state_s, rows = _ToyState(), []
    for b in batches:
        rows.append(single(state_s, torch.from_numpy(b)))
    state_k = _ToyState()
    stacked = _toy_step(rng, k)(state_k, *map(torch.from_numpy, batches))
    assert state_k.step == state_s.step == int(state_j.step) == k
    assert int(state_k.acc) == int(state_s.acc) == int(state_j.acc)
    np.testing.assert_array_equal(stacked["checksum"].numpy(),
                                  np.asarray(stacked_j["checksum"]))
    np.testing.assert_array_equal(
        stacked["checksum"].numpy(),
        [int(r["checksum"][0]) for r in rows])
    np.testing.assert_array_equal(stacked["step"].numpy(), np.arange(k))
    np.testing.assert_array_equal(np.asarray(stacked_j["step"]),
                                  np.arange(k))


def test_toy_pair_core_super_step_equals_jax():
    k, rng = 2, jax.random.PRNGKey(9)
    a, b = jax_tests._batches(k, seed=1), jax_tests._batches(k, seed=2)
    states_j, stacked_j = jax_make_super_step(
        jax_tests._toy_pair_core, k, n_batch_args=2, donate=False)(
        {"a": jax_tests._toy_init(), "b": jax_tests._toy_init()}, *a, *b,
        rng)
    rng_b = jax.random.fold_in(rng, 7)

    def core(states, ba, bb, scalars, generator):
        ma = _toy_core(states["a"], ba, {"step": scalars["step"],
                                         "draw": scalars["draw_a"]}, None)
        mb = _toy_core(states["b"], bb, {"step": scalars["step"],
                                         "draw": scalars["draw_b"]}, None)
        return {"ca": ma["checksum"], "cb": mb["checksum"]}

    step = make_super_step(
        core, k, n_batch_args=2, advance=_advance, generator=None,
        device="cpu", scalars=lambda states, j: {
            "step": states["a"].step + j,
            "draw_a": _jax_draw(rng, states["a"].step + j),
            "draw_b": _jax_draw(rng_b, states["b"].step + j)})
    states = {"a": _ToyState(), "b": _ToyState()}
    stacked = step(states, *map(torch.from_numpy, a + b))
    for name, key in (("a", "ca"), ("b", "cb")):
        assert int(states[name].acc) == int(states_j[name].acc)
        assert states[name].step == int(states_j[name].step) == k
        np.testing.assert_array_equal(stacked[key].numpy(),
                                      np.asarray(stacked_j[key]))


# --------------------------------------- the trainers: K-step = K singles


def _denoiser_trainer():
    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=B, encoder_name="resnet18",
        compute_dtype="float32", image_size=S, steps_per_call=3))
    return DenoiserTrainer(cfg, steps_per_epoch=3, image_size=S,
                           device="cpu")


def _balance_trainer():
    cfg = port_config.config_from_dict(port_config.BalanceConfig, dict(
        data_path="x", batch_size=B, encoder_name="resnet18",
        compute_dtype="float32", image_size=S, steps_per_call=3))
    return BalanceTrainer(cfg, steps_per_epoch=3, image_size=S, device="cpu")


def _deep_fake_trainer(mode):
    # ema_update_after_step 0: the decay is 0 at ema_step 0 and 1 and above
    # 0 from 2, so a group of 3 from the start crosses the warm-up.
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        data_path_a="a", data_path_b="b", batch_size=B,
        encoder_name="resnet18", compute_dtype="float32", image_size=S,
        mode=mode, ema_update_after_step=0, cosine_scheduler_max_epoch=2,
        steps_per_call=3))
    return DeepFakeTrainer(cfg, steps_per_epoch=1, image_size=S,
                           device="cpu")


TRAINERS = {
    "denoiser": (_denoiser_trainer, lambda t: t.init_state(3), 1),
    "balancer": (_balance_trainer, lambda t: t.init_state(3), 1),
    "deep_fake_denoise": (lambda: _deep_fake_trainer("denoise"),
                          lambda t: t.init_states(3), 2),
    "deep_fake_swap": (lambda: _deep_fake_trainer("swap"),
                       lambda t: t.init_states(3), 2),
}


def _tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.has_ema:
        out.update({f"ema.{k}": v
                    for k, v in state.ema_model.state_dict().items()})
    for i, per in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in per.items()})
    return out


def _assert_states_equal(got, want):
    got = got if isinstance(got, dict) else {"state": got}
    want = want if isinstance(want, dict) else {"state": want}
    for name in want:
        g, w = got[name], want[name]
        assert (g.step, g.ema_step, g.has_ema) == (w.step, w.ema_step,
                                                   w.has_ema), name
        gt, wt = _tensors(g), _tensors(w)
        assert gt.keys() == wt.keys(), name
        for k in wt:
            assert torch.equal(gt[k], wt[k]), f"{name}.{k}"


@pytest.mark.parametrize("name", list(TRAINERS))
def test_k_step_call_is_k_single_steps(name):
    """A group of K = 3 against 3 single steps from the same state and
    generator: bit for bit. (Groups in a row: ``fit_denoiser`` below.)"""
    make_trainer, init, n_args = TRAINERS[name]
    rng = np.random.default_rng(11)
    batches = [[torch.from_numpy(rng.integers(0, 256, (B, S, S, 3),
                                              np.uint8))
                for _ in range(n_args)] for _ in range(3)]
    single_t, group_t = make_trainer(), make_trainer()
    singles, grouped = init(single_t), init(group_t)
    rows = [single_t.train_step(singles, *b) for b in batches]
    group = group_t.make_super_step(3)(
        grouped, *[x for pos in zip(*batches) for x in pos])
    _assert_states_equal(grouped, singles)
    if single_t.generator is not None:
        assert torch.equal(group_t.generator.get_state(),
                           single_t.generator.get_state())
    assert set(group) == set(rows[0])
    for key in rows[0]:
        assert [float(v) for v in group[key]] == [float(r[key])
                                                  for r in rows], key
    if name == "deep_fake_swap":
        # The warm-up was crossed inside the group.
        assert [ema_scalars(s, group_t.ema_cfg)["decay"] > 0
                for s in range(3)] == [False, False, True]


def test_graph_objects_change_when_state_is_replaced():
    """What a K-step graph checks before a replay: a restored optimizer
    state, ``modify``'s fresh optimizers and the flip's shadows each
    replace objects it was captured on."""
    trainer = _deep_fake_trainer("denoise")
    states = trainer.init_states(0)
    for state in states.values():
        ensure_adam_state(state.optimizer)

    def same(before):
        after = graph_objects(states)
        return len(after) == len(before) and all(
            a is b for a, b in zip(after, before))

    before = graph_objects(states)
    assert same(before)
    opt = states["a"].optimizer
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    assert not same(before)
    before = graph_objects(states)
    trainer.ensure_ema(states)
    assert not same(before)
    before = graph_objects(states)
    reset_for_modify(states, lambda p: make_adam(p, 0.01,
                                                 device=torch.device("cpu")))
    assert not same(before)


# ------------------------------------------------- grouping, as JAX's


class _Ctx:
    """Records what a ``_drive_epoch`` dispatches (JAX's or the port's)."""

    def __init__(self, image_steps):
        self.global_step = 0
        self.image_steps = set(image_steps)
        self.logged = []

    def want_images(self):
        return self.global_step in self.image_steps

    def log_step(self, metrics, images=None, states=None, rng=None,
                 generator=None, n_steps=1):
        self.logged.append((self.global_step, n_steps, images is not None))

    def maybe_checkpoint(self, *args, **kwargs):
        pass

    def preempted(self):
        return False


def _jax_steps(k, calls):
    def plain(states, *args):
        calls.append(("plain", args[:-1]))
        return states, {}

    def img(states, *args):
        calls.append(("img", args[:-1]))
        return states, {}, {}

    def super_(states, *args):
        calls.append(("super", args[:-1]))
        return states, {}

    return jax_runners._StepSet(plain, img, super_ if k > 1 else None, k,
                                True)


class _PortTrainer:
    generator = None

    def __init__(self, calls):
        self.calls = calls

    def train_step(self, states, *args, with_images=False):
        self.calls.append(("img" if with_images else "plain", args))
        return ({}, {}) if with_images else {}

    def make_super_step(self, k):
        def super_(states, *args):
            self.calls.append(("super", args))
            return {}
        return super_


def _drive(impl, epoch_len, k, max_steps, image_steps, epochs=4):
    calls, starts = [], []
    ctx = _Ctx(image_steps)
    if impl == "jax":
        steps = _jax_steps(k, calls)
    else:
        steps = runners._host_steps(_PortTrainer(calls), k)
    for epoch in range(epochs):
        batches = [(f"b{epoch}.{i}",) for i in range(epoch_len)]
        cb = lambda step, *_: starts.append(step)  # noqa: E731
        if impl == "jax":
            done = jax_runners._drive_epoch(
                ctx, None, "rng", batches, steps, step_callback=cb,
                max_steps=max_steps, verbose=False)[1]
        else:
            done = runners._drive_epoch(
                ctx, None, None, batches, steps, step_callback=cb,
                max_steps=max_steps, verbose=False)
        if done:
            break
    return calls, starts, ctx.logged


@pytest.mark.parametrize("epoch_len,k,max_steps,image_steps,callbacks", [
    (4, 4, 6, (), [4, 5, 6]),          # test_multi_step.py:196-209
    (3, 2, 5, (), [2, 3, 5]),          # test_multi_step.py:212-224
    (5, 2, None, (0, 4, 7), None),     # image steps peel singles
    (3, 4, 8, (), None),               # every epoch shorter than a group
    (6, 3, 10, (1,), None),
])
def test_drive_epoch_groups_as_jax(epoch_len, k, max_steps, image_steps,
                                   callbacks):
    jax_run = _drive("jax", epoch_len, k, max_steps, image_steps)
    port_run = _drive("port", epoch_len, k, max_steps, image_steps)
    assert port_run == jax_run
    if callbacks is not None:
        assert port_run[1] == callbacks


def _accumulate(log_dir):
    # TensorBoard's own stub of the TF API reads event files.
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing import event_accumulator as ea

    acc = ea.EventAccumulator(str(log_dir), size_guidance={ea.SCALARS: 0})
    acc.Reload()
    return acc


def test_fit_denoiser_groups_steps(tmp_path):
    """3 batches an epoch, K = 2, 5 steps: a group, the tail single, a
    group; the losses bit-equal to K = 1, one TensorBoard row a step."""
    manifest = make_image_dataset(tmp_path / "data", n=6, size=32)

    def run(sub, **over):
        losses, starts = [], []

        def cb(step, state, metrics):
            starts.append(step)
            losses.extend(torch.atleast_1d(metrics["loss"]).tolist())

        cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
            input_image_list_path=str(manifest), batch_size=2,
            image_size=32, encoder_name="resnet18", compute_dtype="float32",
            max_epochs=4, log_images=False, handle_preemption=False,
            last_checkpoint_min_interval_s=1e9,
            log_dir=str(tmp_path / sub / "runs"),
            checkpoint_dir=str(tmp_path / sub / "ckpt"), **over))
        runners.fit_denoiser(cfg, max_steps=5, verbose=False,
                             step_callback=cb, device="cpu")
        return losses, starts

    single, _ = run("k1")
    grouped, starts = run("k2", steps_per_call=2)
    assert starts == [2, 3, 5]
    assert grouped == single
    acc = _accumulate(tmp_path / "k2" / "runs" / "denoiser")
    assert [e.step for e in acc.Scalars("loss")] == list(range(5))
    assert [e.step for e in acc.Scalars("lr")] == list(range(5))
    np.testing.assert_array_equal([e.value for e in acc.Scalars("loss")],
                                  np.float32(single))


# --------------------------------------------------------------- the loop


def _ctx(tmp_path):
    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", log_dir=str(tmp_path / "runs"),
        checkpoint_dir=str(tmp_path / "ckpt"), handle_preemption=False),
        validate=False)
    return LoopContext(cfg, {}, workload="denoiser")


def test_grouped_scalars_reach_tensorboard(tmp_path):
    """Every step of a group lands as its own row (JAX's
    ``test_grouped_scalars_reach_tensorboard``), the learning rate from
    its list of host numbers."""
    ctx = _ctx(tmp_path)
    ctx.log_step({"loss": torch.tensor([0.1, 0.2, 0.3, 0.4]),
                  "lr": [0.5, 0.5, 0.25, 0.25]}, n_steps=4)
    ctx.global_step += 4
    ctx.log_step({"loss": torch.tensor(0.5), "lr": 0.125})
    ctx.drain_metrics()
    ctx.close()
    acc = _accumulate(tmp_path / "runs" / "denoiser")
    assert [r.step for r in acc.Scalars("loss")] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([r.value for r in acc.Scalars("loss")],
                               [0.1, 0.2, 0.3, 0.4, 0.5], rtol=1e-6)
    assert [r.value for r in acc.Scalars("lr")] == [0.5, 0.5, 0.25, 0.25,
                                                    0.125]


def test_nan_mid_group_reported_at_its_step(tmp_path):
    """JAX's ``test_nan_guard_reports_mid_group_step``."""
    ctx = _ctx(tmp_path)
    ctx.global_step = 10
    ctx.log_step({"loss": torch.tensor([0.1, float("nan"), 0.3])},
                 n_steps=3)
    with pytest.raises(TrainingDivergedError, match="step 11"):
        ctx.close()


def test_steps_per_call_warns_above_64():
    with pytest.warns(UserWarning, match="steps_per_call=65"):
        port_config.config_from_dict(port_config.DenoiserConfig, dict(
            input_image_list_path="x", steps_per_call=65))
    with pytest.raises(ValueError, match="steps_per_call"):
        port_config.config_from_dict(port_config.DenoiserConfig, dict(
            input_image_list_path="x", steps_per_call=0))


# -------------------------------------------- device scalars = numbers


@pytest.mark.parametrize("step,update_every", [(0, 1), (7, 1), (7, 2),
                                               (8, 2)])
def test_ema_blend_with_tensor_scalars_equals_numbers(step, update_every):
    """The blend a graph replays (decay, weight and gate as fp32 tensors,
    a skip as ``torch.where``) is the host blend's, bit for bit, skips
    included."""
    cfg = EmaConfig(beta=0.999, update_every=update_every,
                    update_after_step=2)
    scalars = ema_scalars(step, cfg)
    rng = np.random.default_rng(step)
    ema = [rng.standard_normal((3, 5)).astype(np.float32),
           rng.standard_normal(7).astype(np.float32)]
    ema[0][0, 0] = -0.0
    online = [rng.standard_normal(e.shape).astype(np.float32) for e in ema]
    by_number = [torch.from_numpy(e.copy()) for e in ema]
    by_tensor = [torch.from_numpy(e.copy()) for e in ema]
    ema_blend(by_number, [torch.from_numpy(p) for p in online], **scalars)
    ema_blend(by_tensor, [torch.from_numpy(p) for p in online],
              **{k: torch.tensor(np.float32(v))
                 for k, v in scalars.items()})
    for n, t, e in zip(by_number, by_tensor, ema):
        assert np.array_equal(n.numpy().view(np.int32),
                              t.numpy().view(np.int32))
        if scalars.get("gate", 1) == 0:
            assert np.array_equal(n.numpy().view(np.int32),
                                  e.view(np.int32))


def test_noise_offset_as_tensor_equals_int():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(
        np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, (2, 8, 8, 3), np.uint8))
    r = torch.tensor([0.25, 0.75])
    for offset in (5, 2 ** 32 + 3):
        at = torch.tensor(offset, dtype=torch.int64)
        assert torch.equal(
            noise_kernel.fused_noise_blend(x, r, seed=1, offset=at),
            noise_kernel.fused_noise_blend(x, r, seed=1, offset=offset))
        assert torch.equal(
            noise_kernel.fused_normalise_noise_blend(
                u8, r, 0.5, 0.5, seed=1, offset=at),
            noise_kernel.fused_normalise_noise_blend(
                u8, r, 0.5, 0.5, seed=1, offset=offset))
