"""Plain denoiser training steps: what a group of the timed path computes.

Works out again, from the benchmark's frames and weights and the seed
alone, everything the program derives on its way to a step:

* the epoch's order: NumPy's ``default_rng(seed * 100003 + epoch)``
  shuffle of the frame indices, trimmed to whole batches, and a step's
  batch at ``(step % steps_per_epoch) * batch`` in it;
* the step's draws from a ``torch.Generator`` seeded with the seed: the
  affine params (angle, scale, tx, ty, apply), then the noise ratios;
* the normalise and warp, the Philox noise at offset ``step`` and the
  blend (``reference/kernels.py``);
* the U-Net's train-mode forward in fp32 (``reference/unet.py``),
  ``(MSE + 1 - SSIM) / 2`` in fp32, its gradient by autograd;
* Adam as PyTorch defines it, at the per-epoch cosine learning rate.

``denoiser_group`` follows K steps from the benchmark's weights.
``first_step_losses`` gives the loss of single steps from given weights
(the program's own, at later steps): at the configuration's learning rate
of 0.02 one Adam update already parts an fp32 trajectory from a bf16 one
by percents (every weight moves by about the rate, and a rounding flips
the sign of the small gradients), so past a group's first step the
reference can only follow the program from the program's state.

Nothing of the program is imported. ``quant`` runs the control's
precision (``reference/lowp.py``). Planted faults: ``half_batch`` takes the
loss over the first half of the batch only, ``mse_only`` keeps the loss's
value but drops the SSIM term's gradient. Witnesses of rounding alone:
``bf16`` runs the forward under bfloat16 autocast (the configuration's
compute type; the loss stays fp32), ``tf32`` lets the convolutions round
their operands to TF32.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import kernels, unet


def epoch_order(seed: int, epoch: int, n_frames: int, keep: int
                ) -> np.ndarray:
    rng = np.random.default_rng(seed * 100_003 + epoch)
    order = np.arange(n_frames)
    rng.shuffle(order)
    return order[:keep]


def cosine_lr(base_lr: float, t_max: int, epoch: int) -> float:
    return base_lr * (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0


@functools.lru_cache(maxsize=None)
def _gaussian(window: int = 11, sigma: float = 1.5) -> tuple:
    half = (window - 1) / 2.0
    g = [math.exp(-((i - half) ** 2) / (2.0 * sigma * sigma))
         for i in range(window)]
    return tuple(v / sum(g) for v in g)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """piqa's SSIM of NHWC batches in [0, 1]: 11-tap Gaussian (sigma 1.5),
    valid padding, k1 0.01, k2 0.03, mean over everything."""
    c = x.shape[-1]
    k = torch.tensor(_gaussian(), dtype=torch.float32, device=x.device)
    n = k.numel()
    maps = torch.cat([x, y, x * x, y * y, x * y], dim=-1).permute(0, 3, 1, 2)
    f = F.conv2d(maps, k.reshape(1, 1, n, 1).repeat(5 * c, 1, 1, 1),
                 groups=5 * c)
    f = F.conv2d(f, k.reshape(1, 1, 1, n).repeat(5 * c, 1, 1, 1),
                 groups=5 * c)
    mu_x, mu_y, exx, eyy, exy = torch.split(f, c, dim=1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * (exy - mu_x * mu_y) + c2)
    den = ((mu_x * mu_x + mu_y * mu_y + c1)
           * (exx - mu_x * mu_x + eyy - mu_y * mu_y + c2))
    return (num / den).mean()


def mse_ssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    p = torch.clamp((pred + 1.0) / 2.0, 0.0, 1.0)
    t = torch.clamp((target + 1.0) / 2.0, 0.0, 1.0)
    return (mse + (1.0 - ssim(p, t))) / 2.0


class Adam:
    """PyTorch's Adam (no weight decay, eps outside the square root)."""

    def __init__(self, params: dict, b1: float, b2: float,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        lr32 = float(np.float32(lr))
        for n, p in params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[n], denom, value=-lr32 / bc1)


class _Inputs:
    """A step's batch, draws, warp and noise, in the trainer's order; the
    draws of steps that are not computed are made all the same, so the
    generator stands where the program's does."""

    def __init__(self, frames, hp: dict, device):
        self.frames, self.hp, self.device = frames, hp, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(hp["seed"])
        self.orders: dict = {}

    def skip(self) -> None:
        b = self.hp["batch_size"]
        kernels.affine_draws(b, *self.hp["aug"], generator=self.gen,
                             device=self.device)
        torch.rand((b, 1, 1, 1), generator=self.gen, device=self.device)

    def step(self, step: int):
        hp, b = self.hp, self.hp["batch_size"]
        spe = hp["n_frames"] // b
        epoch = step // spe
        if epoch not in self.orders:
            self.orders[epoch] = epoch_order(hp["seed"], epoch,
                                             hp["n_frames"], spe * b)
        pos = (step % spe) * b
        batch = self.frames(self.orders[epoch][pos:pos + b]).to(self.device)
        aff = kernels.affine_draws(b, *hp["aug"], generator=self.gen,
                                   device=self.device)
        image = kernels.warp_fused_plain(batch, aff, hp["mean"], hp["std"])
        ratios = kernels.truncated_exponential(
            torch.rand((b, 1, 1, 1), generator=self.gen, device=self.device),
            hp["lam"])
        noisy = kernels.noise_blend_plain(image, ratios.reshape(b),
                                          seed=hp["seed"], offset=step)
        return image, noisy


def _loss(pred, image, half_batch: bool, mse_only: bool):
    if half_batch:
        b = pred.shape[0] // 2
        pred, image = pred[:b], image[:b]
    loss = mse_ssim_loss(pred, image)
    if mse_only:
        half_mse = torch.mean((pred - image) ** 2) / 2.0
        return half_mse + (loss - half_mse).detach()
    return loss


@contextlib.contextmanager
def _precision(device, bf16: bool, tf32: bool):
    """The forward's precision: fp32 (TF32 off) unless a witness asks."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _forward(params, noisy, hp, device, quant, bf16, tf32):
    with _precision(torch.device(device), bf16, tf32):
        pred = unet.forward(params, noisy, hp["encoder_name"], quant=quant)
    return pred.to(torch.float32)


@torch.no_grad()
def first_step_losses(states: list, frames, hp: dict, device, *,
                      quant=None, half_batch: bool = False,
                      mse_only: bool = False, bf16: bool = False,
                      tf32: bool = False) -> list:
    """The loss of step ``s`` from weights ``w`` for each ``(s, w)`` of
    ``states`` (ascending steps; ``w`` name -> tensor, anywhere)."""
    inputs = _Inputs(frames, hp, device)
    todo = dict(states)
    out = []
    for step in range(max(todo) + 1):
        if step not in todo:
            inputs.skip()
            continue
        image, noisy = inputs.step(step)
        params = {k: v.to(device, torch.float32) for k, v in
                  todo[step].items()}
        pred = _forward(params, noisy, hp, device, quant, bf16, tf32)
        out.append(float(_loss(pred, image, half_batch, mse_only)))
    return out


def denoiser_group(weights: dict, frames, hp: dict, steps: int, *,
                   quant=None, half_batch: bool = False,
                   mse_only: bool = False, bf16: bool = False,
                   tf32: bool = False) -> dict:
    """``steps`` denoiser steps from ``weights`` (name -> tensor, on the
    device the reference runs on) and ``frames(indices) -> uint8 NHWC``.

    ``hp``: ``seed``, ``batch_size``, ``n_frames``, ``learning_rate``,
    ``adam_b1``, ``adam_b2``, ``t_max``, ``lam``, ``mean``, ``std``,
    ``aug`` (degrees, translate, scale_min, scale_max, probability),
    ``encoder_name``. Returns the losses, the first step's gradients, the
    final params and Adam's moments."""
    device = next(iter(weights.values())).device
    spe = hp["n_frames"] // hp["batch_size"]
    params = {k: v.detach().clone().to(torch.float32)
              for k, v in weights.items() if unet.trainable(k)}
    for p in params.values():
        p.requires_grad_(True)
    adam = Adam(params, hp["adam_b1"], hp["adam_b2"])
    inputs = _Inputs(frames, hp, device)
    losses, grad1 = [], None
    for step in range(steps):
        epoch = step // spe
        image, noisy = inputs.step(step)
        pred = _forward(params, noisy, hp, device, quant, bf16, tf32)
        loss = _loss(pred, image, half_batch, mse_only)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads, cosine_lr(hp["learning_rate"], hp["t_max"],
                                           epoch))
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()},
            "exp_avg": adam.m, "exp_avg_sq": adam.v}
