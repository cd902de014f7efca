"""Training losses, fp32 whatever the network dtype.

Port of ``denoising_diffusion_deep_fake_tpu/ops/losses.py:18-58``: the
reference's ``MseStructuralSimilarityLoss``, ``(MSE + (1 - SSIM)) / 2``,
with SSIM on the ``[0, 1]``-rescaled, clipped inputs, and the balancer's
per-image L1 difficulty score.
"""

from __future__ import annotations

import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.ssim import ssim


def mse_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared error over all elements, accumulated in fp32."""
    d = prediction.to(torch.float32) - target.to(torch.float32)
    return torch.mean(d * d)


def _normalise_between_zero_and_one(x: torch.Tensor, lo: float,
                                    hi: float) -> torch.Tensor:
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)


def mse_ssim_loss(prediction: torch.Tensor, target: torch.Tensor, *,
                  input_min: float = -1.0, input_max: float = 1.0
                  ) -> torch.Tensor:
    """``(MSE + (1 - SSIM)) / 2`` on NHWC batches: MSE on the raw values,
    SSIM on the rescaled, clipped ones (structural_similarity_loss.py)."""
    mse = mse_loss(prediction, target)
    p = _normalise_between_zero_and_one(prediction.to(torch.float32),
                                        input_min, input_max)
    t = _normalise_between_zero_and_one(target.to(torch.float32),
                                        input_min, input_max)
    return (mse + (1.0 - ssim(p, t, value_range=1.0))) / 2.0


def l1_difficulty_loss(prediction: torch.Tensor, target: torch.Tensor
                       ) -> torch.Tensor:
    """Per-image mean absolute error of NHWC batches, shape ``(B,)``, in
    fp32: the scores feed a min-max binning, where bf16 ties would merge
    difficulty classes."""
    d = prediction.to(torch.float32) - target.to(torch.float32)
    return torch.mean(torch.abs(d), dim=(1, 2, 3))
