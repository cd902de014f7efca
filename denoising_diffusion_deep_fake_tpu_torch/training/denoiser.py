"""Single-model denoiser trainer.

Port of ``denoising_diffusion_deep_fake_tpu/training/denoiser.py:43-158``
(reference: ``d3f/train_denoiser/lit_module.py``). One train step:

    uint8 NHWC batch -> normalise + random affine warp (the CUDA warp kernels
    at 32-aligned sizes) -> color jitter when ``color_jitter`` is set
    (``ops/color.py``) -> truncated-exponential noise blend (the CUDA
    noise kernel) -> U-Net forward/backward in the compute dtype, under
    the ``remat`` policy (``training/state.py``'s ``maybe_remat``) ->
    (MSE + 1 - SSIM) / 2 in fp32 -> Adam with the per-epoch cosine learning
    rate.

With ``upload_format: i420`` the batch arrives 4:2:0-packed, ``(B, H*3/2,
W)`` uint8, and ``unpack_upload`` turns it into fp32 RGB in [0, 255] first
(JAX ``:85-87``); the warp then reads fp32 and normalises it (at 448^2 the
fused kernel's fp32 input with the normalise folded in).

The affine params, the jitter factors (drawn only when the jitter is on,
so with it off no draw moves), the noise ratios and, for an encoder with
stochastic depth (EfficientNet; no other family draws it, so their
streams stay as they were), the drop masks of the gradient forward come
from the trainer's seeded ``torch.Generator``, in that order, the masks in
one call (``draw_drop_masks``); the noise itself from
the noise kernel's stream keyed by ``cfg.seed`` at offset ``state.step``
(the JAX trainer folds the step into a key instead; the two streams differ
by design). ``train_step`` accepts the affine params, the jitter factors,
the noise ratios, the noise itself and the drop masks, so a test can feed
both frameworks the same numbers; given noise is blended with
``blend_noise``. ``with_images`` also returns the TensorBoard panels under
the JAX tags (``image``, ``image_noisy``, ``image_prediction``; JAX
``:139-148``), each a uint8 3x3 grid made on the device by
``panel_grid_u8``.

A step is ``step_core`` on the numbers ``step_scalars`` gives from the
host step counter (the learning rate, the noise offset), then ``advance``;
``make_super_step`` runs K of them a call (``steps_per_call``, one CUDA
graph on the card: ``training/multi_step.py``).

Data parallelism (``data_parallel: N`` as N processes, ``parallel/``): a
rank's ``batch_u8`` is its ``batch_size // N`` rows of the global batch.
Every rank's generator is seeded alike and draws the GLOBAL batch's affine
params, jitter factors, ratios and drop masks, in the order above, and
keeps its rows (``shard_batch``); the noise kernel starts at the rank's
first global element (``element_base``); batch norm takes global
statistics, the gradients are averaged and the loss is the global batch's
mean. So the step is the one-process step of the global batch. Injected
numbers are global arrays, cut the same way.

Spatial parallelism (``spatial_parallel: S``, ``data_parallel * S``
processes, every encoder family and the patchified U-Net): the warp gathers source rows from anywhere
in the image, so each rank of a data row warps (and jitters: contrast
takes a per-image mean) its data row's whole images, with the fused warp
as it is, and only then keeps its H rows (``shard_rows``; JAX's warp
followed by its ``spatial_activation_constraint`` pin). The noise kernel
runs on those rows with their row window (``noise_window``); injected
noise is cut the same way. The U-Net, the loss and the backward run on
the rows (``train_one_model``), the loss is the rank's share, and the
panels are gathered over the data row. The warp route stays
``select_warp_method``'s at any world size: a rank-local kernel launch has
none of the partitioning limits that make JAX route around Pallas with
several devices.

On the GPU the U-Net weights and activations are ``channels_last``: the
warp writes NHWC and the model takes its NCHW view as it is. cuDNN's TF32
is turned off (``torch.backends.cudnn.allow_tf32 = False``, a process-wide
flag) so the fp32 SSIM blur runs in full fp32 in the forward and backward
passes, as the JAX package pins it; in ``bfloat16`` mode the U-Net's
convolutions are bf16 and unaffected.
"""

from __future__ import annotations

import torch

from denoising_diffusion_deep_fake_tpu_torch.config import DenoiserConfig
from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device
from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
    AffineAugmentConfig,
    augment_batch,
    sample_affine_params,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.color import (
    ColorJitterConfig,
    color_jitter_normalised,
    sample_color_jitter_params,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.cuda.noise_kernel import (
    fused_noise_blend,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    panel_grid_u8,
    unpack_upload,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.noise import (
    blend_noise,
    sample_truncated_exponential,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.collectives import (
    mean_metrics,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    config_mesh,
    noise_window,
    shard_batch,
    shard_rows,
)
from denoising_diffusion_deep_fake_tpu_torch.training.multi_step import (
    make_super_step,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import (
    learning_rate_at,
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


class DenoiserTrainer:
    """The denoiser's train step and eval forward on one device (a rank's,
    in a process group)."""

    def __init__(self, cfg: DenoiserConfig, *, steps_per_epoch: int,
                 image_size: int, device=None):
        cfg.validate()
        self.mesh = config_mesh(cfg)
        self.cfg = cfg
        self.image_size = image_size
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.aug = AffineAugmentConfig.random_affine(
            degrees=cfg.aug_degrees, translate=cfg.aug_translate,
            scale_min=cfg.aug_scale_min, scale_max=cfg.aug_scale_max, p=1.0)
        self.jitter = ColorJitterConfig(*cfg.color_jitter,
                                        probability=cfg.color_jitter_p)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.drop_keep = drop_keep_tensor(cfg, self.device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False

    def init_state(self, seed: int) -> ModelState:
        """A U-Net with smp/torchvision init drawn from ``seed``, on the
        trainer's device, and its Adam."""
        return create_model_state(self.cfg, self.dtype, self.device, seed)

    def train_step(self, state: ModelState, batch_u8: torch.Tensor, *,
                   affine_params: dict | None = None,
                   jitter_params: dict | None = None,
                   ratios: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   drop_masks: torch.Tensor | None = None,
                   with_images: bool = False):
        """One update of ``state`` in place from a uint8 batch in the
        config's ``upload_format``; returns ``{"loss", "lr"}`` (the loss as
        a device scalar: reading it waits for the step); ``with_images``,
        ``(metrics, panels)``. ``jitter_params`` (from
        ``sample_color_jitter_params``) take the place of the draw when
        the jitter is on, ``drop_masks`` (``(n, B)``, see
        ``Unet.forward``) that of the masks' draw."""
        scalars = self.step_scalars(state, 0)
        out = self.step_core(state, batch_u8, scalars, self.generator,
                             affine_params=affine_params,
                             jitter_params=jitter_params, ratios=ratios,
                             noise=noise, drop_masks=drop_masks,
                             with_images=with_images)
        self.advance(state, 1)
        metrics = out[0] if with_images else out
        metrics["lr"] = scalars["lr"]
        return out

    def step_scalars(self, state: ModelState, j: int) -> dict:
        """The learning rate and noise offset of the ``j``-th step from
        now."""
        step = state.step + j
        return {"lr": learning_rate_at(step, self.cfg.learning_rate,
                                       cosine_t_max=self.cfg.cosine_t_max,
                                       steps_per_epoch=self.steps_per_epoch),
                "offset": step}

    @staticmethod
    def advance(state: ModelState, k: int) -> None:
        state.step += k

    def step_core(self, state: ModelState, batch_u8: torch.Tensor,
                  scalars: dict, generator: torch.Generator, *,
                  affine_params: dict | None = None,
                  jitter_params: dict | None = None,
                  ratios: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None,
                  drop_masks: torch.Tensor | None = None,
                  with_images: bool = False):
        """The update of ``train_step`` with its ``step_scalars`` and draws
        from ``generator``; the host counter is left alone. Returns
        ``{"loss"}`` (and the panels ``with_images``). The draws and the
        injected numbers are the global batch's, of which this rank keeps
        its rows (the module docstring)."""
        cfg, mesh = self.cfg, self.mesh
        batch = unpack_upload(batch_u8.to(self.device, non_blocking=True),
                              cfg.upload_format)
        b = batch.shape[0]
        gb = b * mesh.data
        if affine_params is None:
            affine_params = sample_affine_params(
                gb, self.aug, generator=generator, device=self.device)
        image = augment_batch(batch, cfg.mean, cfg.std, self.aug,
                              params=shard_batch(affine_params, mesh),
                              method=cfg.warp_method)
        if self.jitter.enabled:
            if jitter_params is None:
                jitter_params = sample_color_jitter_params(
                    generator, gb, self.jitter, device=self.device)
            jitter_params = {k: v.to(self.device) for k, v in
                             shard_batch(jitter_params, mesh).items()}
            image = color_jitter_normalised(image, jitter_params, cfg.mean,
                                            cfg.std)
        image = shard_rows(image, mesh)
        if ratios is None:
            ratios = sample_truncated_exponential(
                (gb, 1, 1, 1), cfg.noise_exponential_sampling_lambda,
                generator=generator, device=self.device)
        ratios = shard_batch(ratios, mesh)
        if noise is None:
            noisy = fused_noise_blend(image, ratios.reshape(b), seed=cfg.seed,
                                      offset=scalars["offset"],
                                      **noise_window(mesh, image))
        else:
            noisy = blend_noise(image,
                                shard_rows(shard_batch(noise, mesh), mesh),
                                ratios.reshape(b, 1, 1, 1))
        if drop_masks is None:
            drop_masks = draw_drop_masks(self.drop_keep, gb, generator)
        loss, pred = train_one_model(state, noisy, image, scalars["lr"],
                                     cfg.remat,
                                     shard_batch(drop_masks, mesh, dim=1),
                                     mesh)
        metrics = mean_metrics({"loss": loss}, mesh)
        if with_images:
            return metrics, panels(image, noisy, pred, mesh)
        return metrics

    def make_super_step(self, k: int):
        """``step(state, batch_0 .. batch_{k-1})``: K steps a call
        (``training/multi_step.py``); metrics ``(K,)`` tensors and ``lr`` a
        list."""
        return make_super_step(
            self.step_core, k, scalars=self.step_scalars,
            advance=self.advance, generator=self.generator,
            device=self.device, host_metrics=("lr",), identity=graph_objects,
            prepare=prepare_for_capture)

    def make_denoise_fn(self):
        """Eval-mode forward (running-average BN, no block dropped), NHWC
        in and out."""
        def denoise(state: ModelState, x: torch.Tensor) -> torch.Tensor:
            state.model.eval()
            with torch.inference_mode():
                return state.model(x.to(self.device))

        return denoise


def panels(image: torch.Tensor, noisy: torch.Tensor,
           pred: torch.Tensor, mesh=None) -> dict:
    """The single-model trainers' panels under the JAX tags (the rows
    gathered over a data row of ``mesh``)."""
    return {tag: panel_grid_u8(x, mesh=mesh) for tag, x in
            (("image", image), ("image_noisy", noisy),
             ("image_prediction", pred))}
