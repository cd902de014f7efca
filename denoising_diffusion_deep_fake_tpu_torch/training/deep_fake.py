"""Two-identity deep-fake trainer, denoise and swap modes.

Port of ``denoising_diffusion_deep_fake_tpu/training/deep_fake.py:64-311``
(reference: ``d3f/train_deep_fake/lit_module.py``). Two U-Nets, ``a`` and
``b``, one per identity. Each step augments both uint8 NHWC batches with
their own mean and std (albumentations ShiftScaleRotate on the device: the
CUDA fused warp at 448^2; ``upload_format: i420`` batches are unpacked to
fp32 RGB first, JAX ``:185-187``) and, with ``color_jitter`` set, jitters
each with its own statistics (``ops/color.py``, JAX ``:203-214``), then:

* ``denoise`` mode: each model learns to recover its own augmented image
  from a noised copy (the CUDA fp32 noise kernel);
* ``swap`` mode: each model also carries an EMA shadow, and training is
  cross-fed in the JAX (and Lightning) order

      ema_b update -> fake_a = ema_b(real_a) -> train a on noised fake_a
      -> ema_a update (a's post-step weights) -> fake_b = ema_a(real_b)
      -> train b on noised fake_b,

  where a shadow's forward runs train-mode BN with the batch's statistics,
  writes no running statistics and has no gradient (JAX ``:145-148``).

``ensure_ema`` attaches shadows to states that lack them: the ``modify``
flip from denoise to swap. ``make_predict_fake`` is the single-pass
eval-mode forward.

Each model's gradient forward runs under the ``remat`` policy
(``training/state.py``'s ``maybe_remat``, JAX ``:150-157``); the shadows'
forwards do not.

Random streams: the affine params, the jitter factors (a's, then b's,
drawn only when the jitter is on) and the noise ratios come from the
trainer's seeded ``torch.Generator``; the noise from the noise kernel's stream keyed
by ``cfg.seed``, model ``a`` at offset ``2 * step`` and model ``b`` at
``2 * step + 1``, with ``step = states["a"].step`` at the start of the
step, so no two draws of a run share an offset. The JAX trainer splits a
key folded with the step instead; the two streams differ by design (as in
``training/denoiser.py``). ``train_step`` accepts the affine params, the
jitter factors, the ratios and the noise of each identity, so a test can
feed both frameworks the same numbers; given noise is blended with
``blend_noise``.

Data parallelism (``parallel/``, as in ``training/denoiser.py``): each
rank holds its rows of both global batches; the generator draws the
global batches' affine params, jitter factors, ratios and drop masks in
the order above and the rank keeps its rows; the noise kernel starts at
the rank's first global element; batch norm, the shadows' train-mode
forwards included, is global; the gradients are averaged and every metric
is the global mean.

Spatial parallelism (``spatial_parallel: S``, as in
``training/denoiser.py``): each rank warps and jitters its data row's
whole images, then keeps its H rows of the real batches; the shadows'
fake forwards and the gradient forwards run on those rows with their
halos (``parallel/halo.py``), the noise kernel with the rows' window,
``swap_difference`` and the losses are the rank's shares, and the panels
are gathered over the data row.

``with_images`` also returns the TensorBoard panels under the JAX tags
(``:239-287`` there), each the step's own tensor through ``panel_grid_u8``:
a uint8 3x3 grid made on the device.

A step is ``step_core`` on the numbers ``step_scalars`` gives from the host
counters (each model's learning rate and noise offset; in swap mode each
shadow's ``ema_scalars`` from its ``ema_step``), then ``advance``;
``make_super_step`` runs K of them a call (``steps_per_call``, one CUDA
graph on the card: ``training/multi_step.py``).
"""

from __future__ import annotations

import torch

from denoising_diffusion_deep_fake_tpu_torch.config import DeepFakeConfig
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
from denoising_diffusion_deep_fake_tpu_torch.ops.losses import mse_loss
from denoising_diffusion_deep_fake_tpu_torch.ops.noise import (
    blend_noise,
    sample_truncated_exponential,
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
from denoising_diffusion_deep_fake_tpu_torch.training.ema import (
    EmaConfig,
    ema_scalars,
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

IDENTITIES = ("a", "b")


def noise_offset(step: int, name: str) -> int:
    """Noise-stream offset of identity ``name``'s model at ``step``."""
    return 2 * step + IDENTITIES.index(name)


class DeepFakeTrainer:
    """The two-identity train step and the swap forward on one device."""

    def __init__(self, cfg: DeepFakeConfig, *, steps_per_epoch: int,
                 image_size: int, device=None):
        cfg.validate()
        self.mesh = config_mesh(cfg)
        self.cfg = cfg
        self.image_size = image_size
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.aug = AffineAugmentConfig.shift_scale_rotate(
            shift_limit=cfg.aug_shift_limit, scale_limit=cfg.aug_scale_limit,
            rotate_limit=cfg.aug_rotate_limit, p=cfg.aug_probability)
        self.jitter = ColorJitterConfig(*cfg.color_jitter,
                                        probability=cfg.color_jitter_p)
        self.ema_cfg = EmaConfig(beta=cfg.ema_beta,
                                 update_every=cfg.ema_update_every,
                                 update_after_step=cfg.ema_update_after_step)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.drop_keep = drop_keep_tensor(cfg, self.device)
        if self.device.type == "cuda":
            # fp32 SSIM blur in full fp32 (see training/denoiser.py).
            torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- states

    def init_states(self, seed: int, with_ema: bool | None = None
                    ) -> dict[str, ModelState]:
        """Fresh states ``{"a", "b"}`` drawn from ``seed`` and ``seed + 1``;
        with shadows in swap mode, or as ``with_ema`` says."""
        if with_ema is None:
            with_ema = self.cfg.mode == "swap"
        return {name: create_model_state(self.cfg, self.dtype, self.device,
                                         seed + i, with_ema=with_ema)
                for i, name in enumerate(IDENTITIES)}

    @staticmethod
    def ensure_ema(states: dict[str, ModelState]) -> dict[str, ModelState]:
        """Attach a shadow, a copy of the model with ``ema_step`` 0, to each
        state that has none (the ``modify`` denoise -> swap flip)."""
        for state in states.values():
            if not state.has_ema:
                state.attach_ema()
        return states

    # ------------------------------------------------------------ train step

    def _ema_forward(self, state: ModelState, x: torch.Tensor
                     ) -> torch.Tensor:
        """Shadow forward: train-mode BN, no stat writes, no gradient."""
        state.ema_model.train()
        with torch.no_grad(), halo.row_sharded(self.mesh):
            return state.ema_model(x)

    def _masks(self, name: str, b: int, drop_masks: dict | None,
               generator: torch.Generator) -> torch.Tensor | None:
        """Identity ``name``'s gradient-forward drop masks, this rank's
        columns of the global draw: given, or drawn just after its noise
        ratios (None for a family without)."""
        if drop_masks is not None:
            masks = drop_masks[name].to(self.device)
        else:
            masks = draw_drop_masks(self.drop_keep, b * self.mesh.data,
                                    generator)
        return shard_batch(masks, self.mesh, dim=1)

    def _noisy(self, x: torch.Tensor, name: str, offset, ratios, noise,
               generator: torch.Generator) -> torch.Tensor:
        b, mesh = x.shape[0], self.mesh
        r = (ratios[name] if ratios is not None else
             sample_truncated_exponential(
                 (b * mesh.data, 1, 1, 1),
                 self.cfg.noise_exponential_sampling_lambda,
                 generator=generator, device=self.device))
        r = shard_batch(r, mesh).to(self.device)
        if noise is None:
            return fused_noise_blend(x, r.reshape(b), seed=self.cfg.seed,
                                     offset=offset, **noise_window(mesh, x))
        return blend_noise(
            x, shard_rows(shard_batch(noise[name], mesh), mesh).to(
                self.device), r.reshape(b, 1, 1, 1))

    def train_step(self, states: dict[str, ModelState],
                   batch_a_u8: torch.Tensor, batch_b_u8: torch.Tensor, *,
                   affine_params: dict | None = None,
                   jitter_params: dict | None = None,
                   ratios: dict | None = None, noise: dict | None = None,
                   drop_masks: dict | None = None,
                   with_images: bool = False):
        """One step of both models in place. ``affine_params``,
        ``jitter_params`` (used when the jitter is on), ``ratios``,
        ``noise`` and ``drop_masks`` (the gradient forwards' only), when
        given, map each identity to its draws. Returns
        ``lr`` and the losses (device scalars) under the JAX metric names;
        ``with_images``, ``(metrics, panels)`` with the uint8 panels under
        the JAX image tags."""
        scalars = self.step_scalars(states, 0)
        out = self.step_core(states, batch_a_u8, batch_b_u8, scalars,
                             self.generator, affine_params=affine_params,
                             jitter_params=jitter_params, ratios=ratios,
                             noise=noise, drop_masks=drop_masks,
                             with_images=with_images)
        self.advance(states, 1)
        metrics = {"lr": scalars["lr"], **(out[0] if with_images else out)}
        return (metrics, out[1]) if with_images else metrics

    def step_scalars(self, states: dict[str, ModelState], j: int) -> dict:
        """The numbers of the ``j``-th step from now: ``lr`` (model a's, the
        logged one) and ``lr_b``, ``offset_a`` and ``offset_b`` (both from
        a's step), and in swap mode each shadow's ``ema_scalars`` under
        ``<name>_<identity>``."""
        cfg = self.cfg
        step = states["a"].step + j

        def lr(name):
            return learning_rate_at(states[name].step + j, cfg.learning_rate,
                                    cosine_t_max=cfg.cosine_t_max,
                                    steps_per_epoch=self.steps_per_epoch)

        out = {"lr": lr("a"), "lr_b": lr("b")}
        out.update({f"offset_{name}": noise_offset(step, name)
                    for name in IDENTITIES})
        if cfg.mode == "swap":
            for name in IDENTITIES:
                out.update({f"{k}_{name}": v for k, v in ema_scalars(
                    states[name].ema_step + j, self.ema_cfg).items()})
        return out

    def advance(self, states: dict[str, ModelState], k: int) -> None:
        for state in states.values():
            state.step += k
            if self.cfg.mode == "swap":
                state.ema_step += k

    def step_core(self, states: dict[str, ModelState],
                  batch_a_u8: torch.Tensor, batch_b_u8: torch.Tensor,
                  scalars: dict, generator: torch.Generator, *,
                  affine_params: dict | None = None,
                  jitter_params: dict | None = None,
                  ratios: dict | None = None, noise: dict | None = None,
                  drop_masks: dict | None = None,
                  with_images: bool = False):
        """The update of ``train_step`` with its ``step_scalars`` and draws
        from ``generator``; the host counters are left alone. Returns the
        losses (and the panels ``with_images``). Each identity's drop
        masks (an encoder with stochastic depth) are drawn after its noise
        ratios, for its gradient forward only: the shadows' fake forwards
        drop nothing (JAX ``deep_fake.py:135-148``)."""
        cfg, mesh = self.cfg, self.mesh
        real = {}
        stats = {"a": (cfg.mean_a, cfg.std_a), "b": (cfg.mean_b, cfg.std_b)}
        for name, batch in (("a", batch_a_u8), ("b", batch_b_u8)):
            batch = unpack_upload(batch.to(self.device, non_blocking=True),
                                  cfg.upload_format)
            params = (sample_affine_params(
                batch.shape[0] * mesh.data, self.aug, generator=generator,
                device=self.device) if affine_params is None
                else affine_params[name])
            real[name] = augment_batch(
                batch, *stats[name], self.aug,
                params=shard_batch(params, mesh), method=cfg.warp_method)
        if self.jitter.enabled:
            # The real batches of both modes, not the shadows' fakes.
            for name in IDENTITIES:
                params = (sample_color_jitter_params(
                    generator, real[name].shape[0] * mesh.data, self.jitter,
                    device=self.device) if jitter_params is None
                    else jitter_params[name])
                real[name] = color_jitter_normalised(
                    real[name], {k: v.to(self.device) for k, v in
                                 shard_batch(params, mesh).items()},
                    *stats[name])
        real = shard_rows(real, mesh)
        lrs = {"a": scalars["lr"], "b": scalars["lr_b"]}
        metrics, panels = {}, {}
        if cfg.mode == "denoise":
            for name in IDENTITIES:
                noisy = self._noisy(real[name], name,
                                    scalars[f"offset_{name}"], ratios, noise,
                                    generator)
                masks = self._masks(name, noisy.shape[0], drop_masks,
                                    generator)
                loss, pred = train_one_model(states[name], noisy, real[name],
                                             lrs[name], cfg.remat, masks,
                                             mesh)
                metrics[f"loss_denoise/train_{name}"] = loss
                if with_images:
                    panels[f"denoise_1_model_input/{name}"] = (
                        panel_grid_u8(noisy, mesh=mesh))
                    panels[f"denoise_2_model_prediction/{name}"] = (
                        panel_grid_u8(pred, mesh=mesh))
        else:
            # Swap: a learns from b's shadow's fakes, then b from a's
            # shadow's, each shadow updated just before it makes its fake.
            for name, other in (("a", "b"), ("b", "a")):
                states[other].blend_ema({
                    k: scalars[f"{k}_{other}"]
                    for k in ("decay", "weight", "gate")
                    if f"{k}_{other}" in scalars})
                fake = self._ema_forward(states[other], real[name])
                metrics[f"swap_difference/{name}"] = mse_loss(
                    real[name], fake, mesh=mesh)
                noisy = self._noisy(fake, name, scalars[f"offset_{name}"],
                                    ratios, noise, generator)
                masks = self._masks(name, noisy.shape[0], drop_masks,
                                    generator)
                loss, pred = train_one_model(states[name], noisy, real[name],
                                             lrs[name], cfg.remat, masks,
                                             mesh)
                metrics[f"loss_swap/train_{name}"] = loss
                if with_images:
                    panels.update({
                        tag: panel_grid_u8(x, mesh=mesh) for tag, x in (
                            (f"swap_1_real/{name}", real[name]),
                            (f"swap_2_fake/{name}_to_fake", fake),
                            (f"swap_3_model_input/{name}", noisy),
                            (f"swap_4_model_prediction/{name}", pred))})
        metrics = mean_metrics(metrics, mesh)
        return (metrics, panels) if with_images else metrics

    def make_super_step(self, k: int):
        """``step(states, a_0 .. a_{k-1}, b_0 .. b_{k-1})``: K steps a call
        (``training/multi_step.py``), captured anew when the mode changes;
        the losses ``(K,)`` tensors and ``lr`` a list."""
        return make_super_step(
            self.step_core, k, scalars=self.step_scalars,
            advance=self.advance, generator=self.generator,
            device=self.device, n_batch_args=2, host_metrics=("lr",),
            identity=graph_objects, prepare=prepare_for_capture,
            key=lambda states: self.cfg.mode)

    # -------------------------------------------------------------- inference

    def make_predict_fake(self, *, use_ema: bool = False):
        """Single-forward face swap: a normalised NHWC batch -> the fp32
        NHWC fake, eval-mode BN (running averages), through the online
        model or, with ``use_ema``, its shadow (when it has one)."""
        def predict(state: ModelState, x: torch.Tensor) -> torch.Tensor:
            model = (state.ema_model if use_ema and state.has_ema
                     else state.model)
            model.eval()
            with torch.inference_mode():
                return model(x.to(self.device))

        return predict
