"""The ``remat`` knob (``training/state.py``'s ``maybe_remat``) on the CPU.

JAX's ``jax.checkpoint`` changes what a step keeps for its backward pass,
not what it computes; so ``none``, ``dots`` and ``full`` are held bit-equal
to one another here (losses, weights, BN buffers, Adam's state), for the
denoiser and for the deep-fake swap step, whose shadows' forwards stay
unwrapped, and keep their running statistics frozen. The BN running
statistics equal the no-remat step's: the
recompute in the backward pass writes them no second time. ``dots``
saves the outputs of the convolutions and matmuls only: the recompute
runs every other op again and no convolution, while ``full`` runs the
convolutions again too, and outside the checkpoint the saved-tensor
hooks pack nothing of the model's forward under either but its input. In bf16 (the
port's compute dtype, and under CPU autocast) a remat step equals the
plain one.

32^2, batch 2, resnet18, torch on one thread.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from denoising_diffusion_deep_fake_tpu_torch import config as port_config
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.training.deep_fake import (
    DeepFakeTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import (
    DenoiserTrainer,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    maybe_remat,
)

B, S = 2, 32
POLICIES = ("none", "dots", "full")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8,
                          generator=gen) for _ in range(n)]


def _tensors(state) -> list:
    out = list(state.model.state_dict().values())
    if state.has_ema:
        out += list(state.ema_model.state_dict().values())
    for st in state.optimizer.state_dict()["state"].values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _denoiser_run(remat, dtype="float32", jitter=(0.0,) * 4):
    cfg = port_config.config_from_dict(port_config.DenoiserConfig, dict(
        input_image_list_path="x", batch_size=B, encoder_name="resnet18",
        compute_dtype=dtype, remat=remat, color_jitter=jitter))
    trainer = DenoiserTrainer(cfg, steps_per_epoch=10, image_size=S,
                              device="cpu")
    state = trainer.init_state(seed=0)
    losses = [float(trainer.train_step(state, u8)["loss"])
              for u8 in _batches(1)]
    return losses, [state], trainer


def _swap_run(remat):
    cfg = port_config.config_from_dict(port_config.DeepFakeConfig, dict(
        data_path_a="a", data_path_b="b", batch_size=B, mode="swap",
        encoder_name="resnet18", compute_dtype="float32", remat=remat,
        ema_update_after_step=0))
    trainer = DeepFakeTrainer(cfg, steps_per_epoch=10, image_size=S,
                              device="cpu")
    states = trainer.init_states(seed=0)
    a, b = _batches(2, seed=1)
    losses = [float(v) for v in trainer.train_step(states, a, b).values()]
    return losses, [states["a"], states["b"]], trainer


RUNS = {"denoiser": _denoiser_run, "swap": _swap_run}


@pytest.fixture(scope="module")
def plain_runs():
    return {name: run("none") for name, run in RUNS.items()}


@pytest.mark.parametrize("workload", list(RUNS))
@pytest.mark.parametrize("policy", ["dots", "full"])
def test_policies_are_bit_equal_to_no_remat(plain_runs, workload, policy):
    want_losses, want_states, _ = plain_runs[workload]
    losses, states, _ = RUNS[workload](policy)
    assert losses == want_losses
    for got, want in zip(states, want_states):
        assert got.step == want.step
        for g, w in zip(_tensors(got), _tensors(want), strict=True):
            assert torch.equal(g, w)
        # The running statistics moved once a step, as the plain step's.
        for (name, g), w in zip(got.model.named_buffers(),
                                want.model.buffers()):
            assert torch.equal(g, w), name
    if workload == "swap":
        _shadows_keep_their_statistics_frozen(states)


def _shadows_keep_their_statistics_frozen(states):
    for state in states:
        norms = [m for m in state.ema_model.modules()
                 if hasattr(m, "update_running_stats")]
        assert norms and all(m.update_running_stats is False for m in norms)
        online = [m for m in state.model.modules()
                  if hasattr(m, "update_running_stats")]
        assert all(m.update_running_stats is True for m in online)
        assert all("update_running_stats" not in m.__dict__ for m in online)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _forward_backward(policy):
    torch.manual_seed(0)
    model = create_unet("resnet18").train()
    x = torch.randn((B, S, S, 3), generator=torch.Generator().manual_seed(1))
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        y = maybe_remat(model, policy)(x)
    loss = y.square().mean()
    recomputed = _OpCount()
    with recomputed:
        loss.backward()
    return packed, recomputed.ops


def test_dots_saves_only_convolution_outputs():
    conv = torch.ops.aten.convolution.default
    packed, ops = _forward_backward("none")
    assert len(packed) > 100 and conv not in ops  # nothing recomputed
    n_conv = sum(1 for op in _forward_ops() if op is conv)
    # ``full`` runs every convolution again but the head's: no backward
    # reads its output, and the recompute stops once it has what the
    # backward reads (the BN guard must hold under that early stop too).
    for policy, convs in (("dots", 0), ("full", n_conv - 1)):
        packed, ops = _forward_backward(policy)
        # Of the model's forward, the hooks see the checkpoint's input only.
        assert [t.shape for t in packed] == [(B, S, S, 3)], policy
        assert sum(1 for op in ops if op is conv) == convs, policy
        # Batch norm runs again in both.
        assert any("batch_norm" in str(op) for op in ops), policy


def _forward_ops():
    model = create_unet("resnet18").train()
    count = _OpCount()
    with count, torch.no_grad():
        model(torch.zeros((B, S, S, 3)))
    return count.ops


def test_bf16_remat_step_equals_plain():
    want, want_states, _ = _denoiser_run("none", dtype="bfloat16")
    got, states, _ = _denoiser_run("dots", dtype="bfloat16")
    assert got == want
    for g, w in zip(_tensors(states[0]), _tensors(want_states[0]),
                    strict=True):
        assert torch.equal(g, w)


def test_recompute_runs_under_the_forwards_autocast():
    x = torch.randn((B, S, S, 3), generator=torch.Generator().manual_seed(2))
    grads = {}
    for policy in POLICIES:
        torch.manual_seed(0)
        model = create_unet("resnet18").train()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = maybe_remat(model, policy)(x)
        y.float().square().mean().backward()
        grads[policy] = [p.grad for p in model.parameters()]
    for policy in ("dots", "full"):
        for g, w in zip(grads[policy], grads["none"], strict=True):
            assert torch.equal(g, w), policy


def test_remat_and_jitter_in_a_k_step_call_match_single_steps():
    """On the CPU a K-step call loops the step: with remat and the jitter
    on, it equals the single steps, the generator included (the card's
    K-step graph: ``tests/test_torch_port_cuda.py``)."""
    jitter = (0.2, 0.2, 0.2, 0.05)
    _, (want,), single = _denoiser_run("dots", jitter=jitter)
    cfg = single.cfg
    trainer = DenoiserTrainer(cfg, steps_per_epoch=10, image_size=S,
                              device="cpu")
    state = trainer.init_state(seed=0)
    trainer.make_super_step(1)(state, *_batches(1))
    for g, w in zip(_tensors(state), _tensors(want), strict=True):
        assert torch.equal(g, w)
    assert torch.equal(trainer.generator.get_state(),
                       single.generator.get_state())


def test_maybe_remat_policies():
    model = create_unet("resnet18")
    assert maybe_remat(model, "none") is model
    with pytest.raises(ValueError, match="remat"):
        maybe_remat(model, "attention")
