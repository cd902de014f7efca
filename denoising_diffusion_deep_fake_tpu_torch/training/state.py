"""Train state for one U-Net, and its one-model update.

Port of ``denoising_diffusion_deep_fake_tpu/training/state.py:26-84``: the
flax pytree (params, BN stats, optimizer state, step, optional EMA shadow)
becomes the ``nn.Module`` (params and BN buffers), its ``torch.optim``
optimizer, the step counter and, in the deep-fake workload's swap mode, a
shadow ``nn.Module`` (the JAX ``ema_params`` + ``ema_batch_stats``) with its
own ``ema_step``. The shadow has no optimizer and no gradients, and its
train-mode BN writes no running statistics: they move only through
``update_ema``, one blend over its params and BN buffers with one step.

``train_one_model`` is the update every trainer shares (JAX
``training/deep_fake.py:150-166``): train-mode forward,
``mse_ssim_loss``, backward, the gradient average over the ranks of a
process group (``parallel/collectives.py``; nothing outside one), Adam.
It leaves the host counters alone: a
trainer advances ``step`` (and ``ema_step``) after its step, by one or, after
a K-step CUDA graph (``training/multi_step.py``), by K. Its forward goes
through ``maybe_remat`` (the ``remat`` knob, JAX ``:93-111``) and takes the
step's stochastic-depth masks as an argument (EfficientNet's; JAX passes
its drop key into the checkpointed function the same way), which the
trainers draw with ``draw_drop_masks`` after their other draws.

``graph_objects`` tells the K-step graph which tensors
a group's graph was captured on, so that it is captured again when any is
replaced (a restore, ``modify``, the shadows of the denoise -> swap flip).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    BatchNorm2d,
    freeze_running_stats_,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    drop_keep_probs,
    init_unet_,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.losses import mse_ssim_loss
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    all_reduce_grads_,
)
from denoising_diffusion_deep_fake_tpu_torch.training.ema import (
    EmaConfig,
    ema_blend,
    ema_update,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
    bind_device_lr,
    ensure_adam_state,
    make_adam,
    set_learning_rate,
)


@dataclasses.dataclass
class ModelState:
    """Module, optimizer, the number of updates applied so far and, in swap
    mode, the EMA shadow and its number of ``update_ema`` calls."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_model: nn.Module | None = None
    ema_step: int = 0

    @property
    def has_ema(self) -> bool:
        return self.ema_model is not None

    def attach_ema(self) -> None:
        """A shadow that is a copy of the model now (same device and memory
        format), with ``ema_step`` 0."""
        shadow = copy.deepcopy(self.model).requires_grad_(False)
        self.ema_model = freeze_running_stats_(shadow.train())
        self.ema_step = 0

    def update_ema(self, cfg: EmaConfig) -> None:
        """One ema_pytorch ``update()`` over the params and BN buffers."""
        self.ema_step = ema_update(
            shadow_tensors(self.ema_model), shadow_tensors(self.model),
            self.ema_step, cfg)

    def blend_ema(self, scalars: dict) -> None:
        """The blend of an ``update()`` from its ``ema_scalars`` (numbers or
        device tensors); ``ema_step`` is the caller's to advance."""
        ema_blend(shadow_tensors(self.ema_model), shadow_tensors(self.model),
                  **scalars)


def shadow_tensors(model: nn.Module) -> list[torch.Tensor]:
    """The tensors an EMA blends: the params, then the BN buffers."""
    return list(model.parameters()) + list(model.buffers())


def model_states(states) -> list[ModelState]:
    """A trainer's states (one ``ModelState`` or the identity dict) as a
    list."""
    return list(states.values()) if isinstance(states, dict) else [states]


def step_counter(states) -> int:
    """The host counter a step's batch position and randomness derive
    from: ``state.step``, or model ``a``'s for the identity pair (JAX
    ``training/cached.py:57, :71``)."""
    return states["a"].step if isinstance(states, dict) else states.step


def graph_objects(states) -> list:
    """Every object a CUDA graph of a train step captures the memory of:
    modules, optimizers, params, buffers, Adam's state tensors and learning
    rates, shadows. Whoever holds this list keeps them alive, so a
    replaced one can be told apart by identity."""
    out = []
    for state in model_states(states):
        out += [state.model, state.optimizer, state.ema_model]
        out += shadow_tensors(state.model)
        if state.has_ema:
            out += shadow_tensors(state.ema_model)
        for group in state.optimizer.param_groups:
            out.append(group["lr"])
            for p in group["params"]:
                out += list(state.optimizer.state.get(p, {}).values())
    return out


def prepare_for_capture(states) -> None:
    """What a CUDA graph of a train step needs before its capture: each
    optimizer's learning rate a device tensor, ``capturable`` set (Adam
    refuses to be captured without it; the fused update computes the same
    either way), and Adam's state made."""
    for state in model_states(states):
        bind_device_lr(state.optimizer)
        for group in state.optimizer.param_groups:
            group["capturable"] = True
        ensure_adam_state(state.optimizer)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def create_model_state(cfg, dtype: torch.dtype, device: torch.device,
                       seed: int, *, with_ema: bool = False) -> ModelState:
    """A ``cfg.encoder_name`` U-Net (patchified by ``cfg.patchify_stem``)
    with smp/torchvision init drawn from ``seed``, on ``device``
    (``channels_last`` on the GPU) in train mode, its Adam with ``cfg``'s
    betas and, ``with_ema``, its shadow."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = init_unet_(create_unet(cfg.encoder_name, dtype=dtype,
                                   patchify=cfg.patchify_stem), gen)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.train()
    optimizer = make_adam(model.parameters(), cfg.learning_rate,
                          b1=cfg.adam_b1, b2=cfg.adam_b2, device=device)
    state = ModelState(model=model, optimizer=optimizer, step=0)
    if with_ema:
        state.attach_ema()
    return state


def drop_keep_tensor(cfg, device) -> torch.Tensor | None:
    """The keep probabilities of ``cfg.encoder_name``'s stochastic-depth
    blocks, an fp32 tensor on ``device``; None for a family without (every
    one but EfficientNet), whose trainers then draw nothing more."""
    keep = drop_keep_probs(cfg.encoder_name)
    if not keep:
        return None
    return torch.tensor(keep, dtype=torch.float32, device=device)


def draw_drop_masks(keep: torch.Tensor | None, batch: int,
                    generator: torch.Generator) -> torch.Tensor | None:
    """One step's stochastic-depth masks in one draw: ``(n, batch)`` bool,
    each block's uniforms below its keep probability (JAX's ``bernoulli``);
    None when ``keep`` is."""
    if keep is None:
        return None
    u = torch.rand((keep.numel(), batch), generator=generator,
                   device=keep.device)
    return u < keep[:, None]


# The ops whose outputs JAX's ``checkpoint_dots`` saves: ``dot_general``
# and ``conv_general_dilated`` (JAX 0.9's ``dots_saveable``).
_DOTS = frozenset({torch.ops.aten.convolution.default,
                   torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _running_stats_frozen(model: nn.Module):
    """Every ``BatchNorm2d`` of ``model`` writes no running statistics
    inside; each gets its own ``update_running_stats`` back after (an EMA
    shadow's stays False)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    own = [m.__dict__.get("update_running_stats") for m in norms]
    for m in norms:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m, v in zip(norms, own):
            if v is None:
                del m.update_running_stats  # the class default again
            else:
                m.update_running_stats = v


@contextlib.contextmanager
def _recompute(model: nn.Module, inner):
    with inner, _running_stats_frozen(model):
        yield


def _remat_contexts(model: nn.Module, policy: str):
    """``checkpoint``'s ``context_fn``: the forward's context and the
    recompute's, which keeps the running statistics as the forward left
    them (the forward wrote them once, as flax's mutated ``batch_stats``
    come out of a remat forward once)."""
    if policy == "dots":
        forward, recompute = create_selective_checkpoint_contexts(
            _dots_policy)
    else:
        forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
    return forward, _recompute(model, recompute)


def maybe_remat(forward: nn.Module, policy: str):
    """The gradient-path forward ``forward`` (a module) under the ``remat``
    policy (JAX ``training/state.py:93-111``, ``jax.checkpoint``):

    * ``none``: ``forward`` itself;
    * ``full``: saves nothing but the input and recomputes the forward in
      the backward pass (JAX ``nothing_saveable``);
    * ``dots``: saves the outputs of convolutions and matmuls and
      recomputes the rest, batch norm and the elementwise chains (JAX
      ``checkpoint_dots``), by selective activation checkpointing.

    Non-reentrant ``torch.utils.checkpoint``, which records the autocast
    state of the forward and recomputes under it. The recompute writes no
    BN running statistics (``_running_stats_frozen``). The RNG state is not
    saved (``preserve_rng_state=False``): no module draws random numbers
    in its forward (EfficientNet's stochastic-depth masks are an argument,
    which the recompute gets again), and ``get_rng_state`` inside a
    CUDA-graph capture (the K-step graph) is not allowed.
    """
    if policy == "none":
        return forward
    if policy not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {policy!r}")
    contexts = functools.partial(_remat_contexts, forward, policy)

    def remat_forward(*args):
        return checkpoint(forward, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)

    return remat_forward


def train_one_model(state: ModelState, noisy: torch.Tensor,
                    target: torch.Tensor, lr=None, remat: str = "none",
                    drop_masks: torch.Tensor | None = None, mesh=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One update of ``state``'s tensors in place: ``mse_ssim_loss(
    model(noisy, drop_masks), target)`` in train mode, the forward under the
    ``remat`` policy, backward, the gradients averaged over ``mesh``'s
    ranks (``parallel/mesh.py``; none when None), Adam at ``lr`` (a float,
    or an fp32 device tensor; the optimizer's own when None). The host
    ``step`` is the caller's to advance. Returns the loss of this rank's
    rows as a device scalar and the prediction."""
    model, optimizer = state.model, state.optimizer
    model.train()
    optimizer.zero_grad(set_to_none=True)
    forward = maybe_remat(model, remat)
    pred = (forward(noisy) if drop_masks is None
            else forward(noisy, drop_masks))
    loss = mse_ssim_loss(pred, target)
    loss.backward()
    all_reduce_grads_(model, mesh)
    if lr is not None:
        set_learning_rate(optimizer, lr)
    optimizer.step()
    return loss.detach(), pred.detach()
