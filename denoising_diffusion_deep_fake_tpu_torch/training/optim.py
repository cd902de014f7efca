"""Adam + per-epoch cosine annealing with torch semantics.

Port of ``denoising_diffusion_deep_fake_tpu/training/optim.py:25-54``. The
reference trains with ``torch.optim.Adam`` (eps outside the sqrt, which is
what optax's ``eps_root=0`` reproduces) and a ``CosineAnnealingLR`` stepped
per epoch, so the learning rate is constant within an epoch:

    lr(e) = eta_min + (lr0 - eta_min) * (1 + cos(pi * e / T_max)) / 2.

optax evaluates that schedule at the optimizer's count before the update,
``e = step // steps_per_epoch``; ``learning_rate_at`` does the same and the
trainer sets it on the param groups before each ``optimizer.step()``
(``set_learning_rate``).

On CUDA the Adam is PyTorch's fused one with its learning rate an fp32
device tensor that each step overwrites in place, so that a step can be
captured in a CUDA graph (``training/multi_step.py``, which also sets
``capturable=True`` before it captures): a float set on the param groups
would be frozen into the graph at capture. The fused kernel reads the
tensor as the float it would have been given (the host value rounded to
fp32) and keeps Adam's ``step`` on the device either way, so checkpoints
read as before. On the CPU the learning rate stays a float: PyTorch's CPU
Adam takes it so.
"""

from __future__ import annotations

import math

import torch


def cosine_annealing_lr(base_lr: float, t_max: int, epoch: int,
                        eta_min: float = 0.0) -> float:
    """torch ``CosineAnnealingLR`` closed form at integer ``epoch``."""
    return eta_min + (base_lr - eta_min) * (
        1.0 + math.cos(math.pi * epoch / t_max)) / 2.0


def learning_rate_at(step: int, base_lr: float, *, cosine_t_max: int | None,
                     steps_per_epoch: int) -> float:
    """The learning rate of the update that moves ``step`` to ``step + 1``;
    constant when ``cosine_t_max`` is None (the balancer's optimizer)."""
    if cosine_t_max is None:
        return base_lr
    return cosine_annealing_lr(base_lr, cosine_t_max,
                               step // steps_per_epoch)


def make_adam(params, learning_rate: float, *, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              device: torch.device) -> torch.optim.Adam:
    """torch Adam with the given betas; on CUDA the fused update with a
    device learning rate."""
    optimizer = torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, fused=device.type == "cuda")
    bind_device_lr(optimizer)
    return optimizer


def bind_device_lr(optimizer: torch.optim.Optimizer) -> None:
    """Give every param group of a CUDA optimizer its learning rate as an
    fp32 tensor on the params' device: after construction, and after
    ``load_state_dict``, which puts back the saved groups' values (a float
    in a checkpoint written before graphs, a host tensor since). Groups on
    the CPU keep their float."""
    for group in optimizer.param_groups:
        device = group["params"][0].device
        if device.type != "cuda":
            continue
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == device
                and lr.dtype == torch.float32 and lr.dim() == 0):
            group["lr"] = torch.full((), float(lr), dtype=torch.float32,
                                     device=device)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """The next update's learning rate, a float or an fp32 tensor on the
    device, written into each group's own tensor where it has one (a CUDA
    graph replays the copy from wherever ``lr`` lives)."""
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(lr)
        elif isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(float(lr))


def ensure_adam_state(optimizer: torch.optim.Adam) -> None:
    """Create the state of every trainable param that has none, as
    ``Adam.step`` would at its first update (zero moments, step 0), without
    updating anything: a first update captured in a CUDA graph would
    otherwise zero the moments at every replay."""
    for group in optimizer.param_groups:
        if group["amsgrad"]:
            raise NotImplementedError("amsgrad is not used by the trainers")
        for p in group["params"]:
            if not p.requires_grad or optimizer.state.get(p):
                continue
            state = optimizer.state[p]
            on_device = group["capturable"] or group["fused"]
            state["step"] = torch.zeros(
                (), dtype=torch.float32 if group["fused"]
                else torch.get_default_dtype(),
                device=p.device if on_device else "cpu")
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
