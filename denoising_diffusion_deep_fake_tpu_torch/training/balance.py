"""Training-image difficulty balancer.

Port of ``denoising_diffusion_deep_fake_tpu/training/balance.py`` (reference:
``d3f/balance_training_images/lit_module.py``): train a denoiser at one
fixed noise ratio, then score every image by its reconstruction difficulty
(per-image L1), min-max normalise the scores over the dataset, bin them into
``number_of_classes`` classes; ``training/runners.py`` writes them as a
``<path>\\t<class>`` manifest.

One train step: uint8 NHWC batch -> the CUDA kernel ``fused_noise_for_balance``
(normalise and blend at the fixed ratio in one pass) -> U-Net forward and
backward in the compute dtype, train-mode BN -> ``mse_ssim_loss`` against
the clean normalised batch -> Adam at a constant learning rate. Scoring runs
the same noise stage, an eval-mode (running-average BN) forward and
``l1_difficulty_loss``.

With ``upload_format: i420`` a train batch arrives 4:2:0-packed and is
unpacked to fp32 RGB first (JAX ``:89-91``); the uint8 kernel cannot read
that, so the step normalises it (``normalise_batch``'s rounding, JAX
``:96``) and noises it with the fp32 kernel ``fused_noise_blend``, every
sample at ``ratio_of_noise``, from the same stream (seed and offset).
Scoring always reads RGB, as in JAX. With ``data_cache: device``
``score_dataset_from_cache`` scores the dataset on the device in manifest
order (JAX ``:137-174``): no image crosses the host link.

Random streams: the kernel's stream is keyed by ``cfg.seed``; a train step
draws at offset ``state.step`` and scoring batch ``k`` of epoch ``e`` at
``SCORE_STREAM * (e + 1) + k``, a range no train step reaches (the JAX
runner folds ``2_000_000_000 + epoch`` into its key for the same end). The
offsets are counted on the host; nothing is read back from the device.
With an encoder that has stochastic depth (EfficientNet) the gradient
forward's drop masks come from a seeded ``torch.Generator`` (``cfg.seed``),
in one draw a step (``draw_drop_masks``); for every other family the
balancer has no generator and draws nothing. Scoring never drops.
``train_step`` and the validation step accept the noise itself instead, so
a test can feed both frameworks the same numbers; given noise is blended
with ``blend_fixed_amount_of_noise`` after ``normalise_batch``, as the JAX
step composes it. ``with_images`` returns the denoiser's panels (JAX
``:113-121``).

Data parallelism (``parallel/``, as in ``training/denoiser.py``): a
rank's train batch is its rows of the global batch, its noise starts at
its first global element (``element_base``), its drop masks are its
columns of the global draw, batch norm is global, the gradients are
averaged and the loss is the global mean. Scoring is replicated, as in
JAX (``balance.py:185-226``): every rank scores the whole unsharded batch
(eval-mode BN issues no collective), so every rank gets every image's
loss.

Spatial parallelism (``spatial_parallel: S``, the resnet family): a rank
keeps its H rows of its data row's uint8 images before the uint8 noise
kernel, which runs with the rows' window (``noise_window``); the U-Net,
the loss and the backward run on the rows, the loss is the rank's share.
Scoring stays replicated over the data axis, and each rank of a data row
scores its H rows of every image: ``l1_difficulty_loss`` sums the
images' shares over the data row, so every rank still gets every
image's loss.

A train step is ``step_core`` at the offset ``step_scalars`` gives, then
``advance``; ``make_super_step`` runs K of them a call (``steps_per_call``,
one CUDA graph on the card: ``training/multi_step.py``), the uint8 (or
fp32) noise kernel reading its offset on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.config import BalanceConfig
from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device
from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
    normalise_batch,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.noise_kernel import (
    fused_noise_blend,
    fused_noise_for_balance,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import unpack_upload
from denoising_diffusion_deep_fake_tpu_torch.ops.losses import (
    l1_difficulty_loss,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.noise import (
    blend_fixed_amount_of_noise,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    mean_metrics,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel import halo
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    config_mesh,
    noise_window,
    shard_batch,
    shard_rows,
)
from denoising_diffusion_deep_fake_tpu_torch.training.denoiser import panels
from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
    make_super_step,
)
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    ModelState,
    create_model_state,
    draw_drop_masks,
    drop_keep_tensor,
    graph_objects,
    prepare_for_capture,
    train_one_model,
)

SCORE_STREAM = 1 << 32


def compute_difficulty_index(losses: np.ndarray,
                             number_of_classes: int) -> np.ndarray:
    """Min-max normalise, clamp to [0, 0.99999], floor-scale by
    ``number_of_classes`` (``lit_module.py:181-193``)."""
    lo, hi = losses.min(), losses.max()
    denom = hi - lo if hi > lo else 1.0
    normalised = np.clip((losses - lo) / denom, 0.0, 0.99999)
    return (normalised * number_of_classes).astype(np.int64)


def score_offset(epoch: int, batch_index: int) -> int:
    """Stream offset of scoring batch ``batch_index`` in ``epoch``."""
    return SCORE_STREAM * (epoch + 1) + batch_index


class BalanceTrainer:
    """The balancer's train step and scoring pass on one device."""

    # Its randomness is the noise kernel's stream, keyed by offsets, and,
    # for an encoder with stochastic depth, the drop masks: only then a
    # generator state to checkpoint.
    generator = None

    def __init__(self, cfg: BalanceConfig, *, steps_per_epoch: int,
                 image_size: int, device=None):
        cfg.validate()
        self.mesh = config_mesh(cfg)
        self.cfg = cfg
        self.image_size = image_size
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.drop_keep = drop_keep_tensor(cfg, self.device)
        if self.drop_keep is not None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(cfg.seed)
        if self.device.type == "cuda":
            # fp32 SSIM blur in full fp32 (see training/denoiser.py).
            torch.backends.cudnn.allow_tf32 = False

    def init_state(self, seed: int) -> ModelState:
        """A U-Net drawn from ``seed`` on the trainer's device, and its
        Adam (constant learning rate, as ``lit_module.py:83-88``)."""
        return create_model_state(self.cfg, self.dtype, self.device, seed)

    def _images(self, batch_u8: torch.Tensor, offset,
                noise: torch.Tensor | None, upload_format: str = "rgb",
                mesh=None, replicated: bool = False):
        """(clean normalised batch, noisy batch) of a uint8 batch in
        ``upload_format``; ``offset`` an int or a device int64, the noise
        that of the batch's place in ``mesh``'s global batch (its rows
        with ``spatial > 1``: the batch's own are cut first; a batch
        every data row holds, ``replicated``, is the global batch); the
        whole batch's when None."""
        cfg = self.cfg
        batch = unpack_upload(batch_u8.to(self.device, non_blocking=True),
                              upload_format)
        if mesh is not None:
            batch = shard_rows(batch, mesh)
        image = normalise_batch(batch, cfg.mean, cfg.std)
        window = ({"element_base": 0, "sample_stride": None}
                  if mesh is None else
                  noise_window(mesh, image, replicated=replicated))
        if noise is None and batch.dtype == torch.uint8:
            noisy = fused_noise_for_balance(batch, cfg.ratio_of_noise,
                                            cfg.mean, cfg.std, cfg.seed,
                                            offset=offset, **window)
        elif noise is None:
            ratios = torch.full((batch.shape[0],), cfg.ratio_of_noise,
                                dtype=torch.float32, device=self.device)
            noisy = fused_noise_blend(image, ratios, seed=cfg.seed,
                                      offset=offset, **window)
        else:
            noisy = blend_fixed_amount_of_noise(
                image, cfg.ratio_of_noise, noise=noise.to(self.device))
        return image, noisy

    def train_step(self, state: ModelState, batch_u8: torch.Tensor, *,
                   noise: torch.Tensor | None = None,
                   drop_masks: torch.Tensor | None = None,
                   with_images: bool = False):
        """One update of ``state`` in place from a uint8 batch in the
        config's ``upload_format``; returns ``{"loss"}`` (a device scalar:
        reading it waits for the step); ``with_images``, ``(metrics,
        panels)``. ``drop_masks`` take the place of the masks' draw."""
        out = self.step_core(state, batch_u8, self.step_scalars(state, 0),
                             self.generator, noise=noise,
                             drop_masks=drop_masks, with_images=with_images)
        self.advance(state, 1)
        return out

    @staticmethod
    def step_scalars(state: ModelState, j: int) -> dict:
        """The noise offset of the ``j``-th step from now."""
        return {"offset": state.step + j}

    @staticmethod
    def advance(state: ModelState, k: int) -> None:
        state.step += k

    def step_core(self, state: ModelState, batch_u8: torch.Tensor,
                  scalars: dict, generator=None, *,
                  noise: torch.Tensor | None = None,
                  drop_masks: torch.Tensor | None = None,
                  with_images: bool = False):
        """The update of ``train_step`` at its ``step_scalars``, the drop
        masks (if the encoder has any) from ``generator``; the host
        counter is left alone. ``noise`` and ``drop_masks`` are the global
        batch's (the module docstring)."""
        mesh = self.mesh
        lb = batch_u8.shape[0]
        image, noisy = self._images(
            batch_u8, scalars["offset"],
            shard_rows(shard_batch(noise, mesh), mesh),
            self.cfg.upload_format, mesh)
        if drop_masks is None:
            drop_masks = draw_drop_masks(self.drop_keep, lb * mesh.data,
                                         generator)
        loss, pred = train_one_model(state, noisy, image,
                                     drop_masks=shard_batch(drop_masks, mesh,
                                                            dim=1),
                                     mesh=mesh)
        metrics = mean_metrics({"loss": loss}, mesh)
        if with_images:
            return metrics, panels(image, noisy, pred, mesh)
        return metrics

    def make_super_step(self, k: int):
        """``step(state, batch_0 .. batch_{k-1})``: K train steps a call
        (``training/multi_step.py``), the losses a ``(K,)`` tensor."""
        return make_super_step(
            self.step_core, k, scalars=self.step_scalars,
            advance=self.advance, generator=self.generator,
            device=self.device, identity=graph_objects,
            prepare=prepare_for_capture)

    def make_validation_step(self):
        """Per-batch difficulty scoring: ``(state, batch_u8, *, offset,
        noise=None) -> (B,)`` fp32 L1 losses, eval-mode BN; with
        ``spatial > 1`` on the rank's H rows of every image, the scores
        summed over the data row."""
        mesh = self.mesh if self.mesh.spatial > 1 else None

        def val_step(state: ModelState, batch_u8: torch.Tensor, *,
                     offset: int, noise: torch.Tensor | None = None
                     ) -> torch.Tensor:
            image, noisy = self._images(batch_u8, offset,
                                        shard_rows(noise, self.mesh),
                                        mesh=mesh, replicated=True)
            state.model.eval()
            with torch.inference_mode(), halo.row_sharded(mesh):
                return l1_difficulty_loss(state.model(noisy), image,
                                          mesh=mesh)

        return val_step

    def score_dataset(self, state: ModelState, batches, *, epoch: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Score every image; returns ``(indices, losses)`` in the order of
        ``batches``, an iterable of ``(uint8 batch, dataset indices)``.

        A tail batch shorter than ``cfg.batch_size`` is padded by repeating
        its last image, so every batch has one shape, and the pad losses
        are dropped (``balance.py:210-227``). The losses stay on the device
        until the pass ends.
        """
        val_step = self.make_validation_step()
        batch_size = self.cfg.batch_size
        all_idx, all_loss = [], []
        for k, (batch, idx) in enumerate(batches):
            batch = torch.as_tensor(batch)
            n_valid = batch.shape[0]
            if n_valid > batch_size:
                raise ValueError(f"a batch of {n_valid} exceeds batch_size "
                                 f"{batch_size}")
            if n_valid < batch_size:
                pad = batch[-1:].expand(batch_size - n_valid,
                                        *batch.shape[1:])
                batch = torch.cat([batch, pad])
            losses = val_step(state, batch, offset=score_offset(epoch, k))
            all_idx.append(np.asarray(idx))
            all_loss.append(losses[:n_valid])
        return (np.concatenate(all_idx),
                torch.cat(all_loss).cpu().numpy())

    def score_dataset_from_cache(self, state: ModelState, cache, *,
                                 epoch: int = 0
                                 ) -> tuple[np.ndarray, np.ndarray]:
        """``score_dataset`` over a ``DeviceDatasetCache``'s dataset in
        manifest order (JAX ``balance.py:137-174``): the batches are views
        of the tensor on the device, the tail padded by its last image as
        ``score_dataset`` pads it (JAX clips the tail's indices to the
        last image: the same batch), at the same ``score_offset``s, so
        every image gets the loss the host scoring gives it."""
        n, b = cache.n_images, self.cfg.batch_size
        batches = ((cache.dataset[pos:pos + b],
                    np.arange(pos, min(pos + b, n)))
                   for pos in range(0, n, b))
        return self.score_dataset(state, batches, epoch=epoch)
