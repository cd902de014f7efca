"""Training losses, fp32 whatever the network dtype.

Port of ``denoising_diffusion_deep_fake_tpu/ops/losses.py:18-58``: the
reference's ``MseStructuralSimilarityLoss``, ``(MSE + (1 - SSIM)) / 2``,
with SSIM on the ``[0, 1]``-rescaled, clipped inputs, and the balancer's
per-image L1 difficulty score.

On a spatial rank's H rows (``mesh`` with ``spatial > 1``,
``parallel/mesh.py``) each loss is the rank's share: sums over the rank's
rows divided by the data row's global counts (``ops/ssim.py`` for the
SSIM), so the shares of a data row add up to its loss and its gradient
(``parallel/collectives.py``'s rule); the constant 1 of ``1 - SSIM`` is
split evenly. ``l1_difficulty_loss`` sums its per-image shares over the
data row, so every rank holds every image's score.
"""

from __future__ import annotations

import torch

from denoising_diffusion_deep_fake_tpu_torch.ops.ssim import ssim
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    spatial_all_reduce_,
)


def _spatial(mesh) -> int:
    return 1 if mesh is None else mesh.spatial


def mse_loss(prediction: torch.Tensor, target: torch.Tensor, *,
             mesh=None) -> torch.Tensor:
    """Mean-squared error over all elements, accumulated in fp32 (a spatial
    rank's share on ``mesh``)."""
    d = prediction.to(torch.float32) - target.to(torch.float32)
    if _spatial(mesh) > 1:
        return torch.sum(d * d) / (d.numel() * mesh.spatial)
    return torch.mean(d * d)


def _normalise_between_zero_and_one(x: torch.Tensor, lo: float,
                                    hi: float) -> torch.Tensor:
    return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)


def mse_ssim_loss(prediction: torch.Tensor, target: torch.Tensor, *,
                  input_min: float = -1.0, input_max: float = 1.0,
                  mesh=None) -> torch.Tensor:
    """``(MSE + (1 - SSIM)) / 2`` on NHWC batches: MSE on the raw values,
    SSIM on the rescaled, clipped ones (structural_similarity_loss.py); a
    spatial rank's share on ``mesh``."""
    mse = mse_loss(prediction, target, mesh=mesh)
    p = _normalise_between_zero_and_one(prediction.to(torch.float32),
                                        input_min, input_max)
    t = _normalise_between_zero_and_one(target.to(torch.float32),
                                        input_min, input_max)
    one = 1.0 / _spatial(mesh)
    return (mse + (one - ssim(p, t, value_range=1.0, mesh=mesh))) / 2.0


def l1_difficulty_loss(prediction: torch.Tensor, target: torch.Tensor, *,
                       mesh=None) -> torch.Tensor:
    """Per-image mean absolute error of NHWC batches, shape ``(B,)``, in
    fp32: the scores feed a min-max binning, where bf16 ties would merge
    difficulty classes. On a spatial rank's rows of ``mesh`` the images'
    shares are summed over the data row: every rank gets the scores."""
    d = prediction.to(torch.float32) - target.to(torch.float32)
    if _spatial(mesh) > 1:
        shares = torch.abs(d).sum(dim=(1, 2, 3)) / (d[0].numel()
                                                     * mesh.spatial)
        return spatial_all_reduce_(shares, mesh)
    return torch.mean(torch.abs(d), dim=(1, 2, 3))
