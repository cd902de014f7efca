"""Train state for one U-Net.

Port of ``denoising_diffusion_deep_fake_tpu/training/state.py:26-84``: the
flax pytree (params, BN stats, optimizer state, step) becomes the
``nn.Module`` (params and BN buffers), its ``torch.optim`` optimizer and
the step counter. The EMA shadow of the swap workload is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    init_unet_,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import make_adam


@dataclasses.dataclass
class ModelState:
    """Module, optimizer and the number of updates applied so far."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def create_model_state(cfg, dtype: torch.dtype, device: torch.device,
                       seed: int) -> ModelState:
    """A ``cfg.encoder_name`` U-Net with smp/torchvision init drawn from
    ``seed``, on ``device`` (``channels_last`` on the GPU) in train mode,
    and its Adam with ``cfg``'s betas."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = init_unet_(create_unet(cfg.encoder_name, dtype=dtype), gen)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.train()
    optimizer = make_adam(model.parameters(), cfg.learning_rate,
                          b1=cfg.adam_b1, b2=cfg.adam_b2, device=device)
    return ModelState(model=model, optimizer=optimizer, step=0)
