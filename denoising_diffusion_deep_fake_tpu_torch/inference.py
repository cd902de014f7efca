"""Checkpoint -> swap model -> the uint8 -> uint8 swap pipeline.

Port of ``denoising_diffusion_deep_fake_tpu/inference.py:32-202``, the
equivalent of the reference's ``predict_fake`` (``lit_module.py:251-300``):
load one identity's U-Net, normalise frames with the *other* identity's
statistics, swap with one eval-mode forward (or a DDIM refinement),
denormalise, truncate, clamp. Shared by the serving engine
(``serving/engine.py``) and video render (``data/video.py``).

* ``load_swap_model`` reads only the chosen identity's model or shadow
  from the checkpoint (``checkpoint.CheckpointManager.restore_partial``)
  and builds the U-Net alone, in eval mode: no optimizer, no trainer.
* ``make_device_pipeline`` returns ``f(frames_u8, batch_idx) -> fake_u8``
  on the model's device; uint8 crosses the host link both ways, NHWC RGB
  or, with ``transfer="i420"``, 4:2:0-packed ``(B, H*3/2, W)`` (half the
  bytes). Where JAX folds ``batch_idx`` into a key for the DDIM noise, the
  port passes it as the noise kernel's ``offset`` under the pipeline's
  ``seed``.
* an fp32 checkpoint promises fp32 math: on the GPU its ``SwapModel.predict``
  runs with TF32 off for cuDNN and matmuls (PyTorch turns cuDNN's on by
  default), as the JAX package traces such a pipeline at ``highest``
  precision. The flags are process-wide: ``predict`` sets them for its
  forward and puts the caller's back.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    DeepFakeConfig,
    config_from_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.data.codec import cubic_resizer
from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device
from denoising_diffusion_deep_fake_tpu_torch.models.unet import create_unet
from denoising_diffusion_deep_fake_tpu_torch.ops.augment import (
    normalise_batch,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.image import (
    center_crop,
    denormalise_to_uint8_rgb,
    i420_to_rgb,
    rgb_to_i420,
)
from denoising_diffusion_deep_fake_tpu_torch.ops.sampler import swap_refine

IDENTITIES = ("a", "b")


@contextlib.contextmanager
def _tf32_off():
    """Hold cuDNN and matmuls to fp32 math, then restore the flags."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@dataclasses.dataclass
class SwapModel:
    """An inference-ready single-identity face-swap model."""

    model: nn.Module             # eval-mode U-Net on ``device``
    mean: tuple                  # de/normalisation statistics: the other
    std: tuple                   #   identity's (lit_module.py:253-257)
    cfg: DeepFakeConfig          # from the checkpoint's hparams
    identity: str                # "a" or "b": which model swaps
    image_size: int              # the checkpoint's, else the caller's
    device: torch.device

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised NHWC batch -> the fp32 NHWC fake (eval-mode BN); an
        fp32 model's forward runs with TF32 off on the GPU."""
        fp32 = (self.device.type == "cuda"
                and self.cfg.compute_dtype == "float32")
        with torch.inference_mode(), (_tf32_off() if fp32
                                      else contextlib.nullcontext()):
            return self.model(x)


def load_swap_model(checkpoint_path, model_a_or_b: str, *,
                    use_ema: bool = False, image_size: int | None = None,
                    device=None) -> SwapModel:
    """Load one identity's swap model from the newest checkpoint.

    Model "a" swaps through model a and de/normalises with identity b's
    statistics, and vice versa. ``use_ema`` swaps through the EMA shadow,
    which only a swap-mode checkpoint has."""
    if model_a_or_b not in IDENTITIES:
        raise ValueError(f"model_a_or_b must be 'a' or 'b', got "
                         f"{model_a_or_b}")
    device = resolve_device(device)
    manager = CheckpointManager(checkpoint_path)
    meta = manager.read_meta()
    cfg = config_from_dict(DeepFakeConfig, meta["hparams"], validate=False)
    ckpt_mode = meta["hparams"].get("mode", cfg.mode)
    if use_ema and ckpt_mode != "swap":
        raise ValueError(
            f"checkpoint at {checkpoint_path} was saved in mode="
            f"{ckpt_mode!r} and has no EMA shadows — drop use_ema, or "
            "train in swap mode first")
    part = "ema_model" if use_ema else "model"
    state_dict = manager.restore_partial(model_a_or_b, [part],
                                         device=device)[part]
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    model = create_unet(cfg.encoder_name, dtype=dtype,
                        patchify=cfg.patchify_stem).to(device)
    model.load_state_dict(state_dict)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.eval().requires_grad_(False)
    if model_a_or_b == "a":
        mean, std = cfg.mean_b, cfg.std_b
    else:
        mean, std = cfg.mean_a, cfg.std_a
    return SwapModel(model=model, mean=tuple(mean), std=tuple(std), cfg=cfg,
                     identity=model_a_or_b,
                     image_size=cfg.image_size or image_size or 448,
                     device=device)


REPLICA_SHIFT = 40


def make_device_pipeline(model: SwapModel, *, sampler_steps: int = 0,
                         transfer: str = "rgb", seed: int = 0,
                         replica: int = 0
                         ) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """The uint8 -> uint8 swap of one ``SwapModel``:
    ``f(frames_u8, batch_idx) -> fake_u8`` for batches on the model's
    device in the ``transfer`` wire format, NHWC RGB or (B, H*3/2, W) i420.
    Normalise, swap (one forward, or ``sampler_steps`` DDIM steps from
    ``r_start`` 0.7 whose noise is keyed by ``(seed, batch_idx)``, in the
    stream of serving replica ``replica``: offset ``replica << 40`` on,
    as JAX folds the replica index into its key), then
    ``trunc(fake * std*255 + mean*255)`` clamped to [0, 255]: truncation,
    as the reference casts. An i420 batch is unpacked to fp32 RGB and
    normalised as ``(rgb - mean*255) / (std*255)``, and the fake packed
    back (JAX ``inference.py:160-171``)."""
    if transfer not in ("rgb", "i420"):
        raise ValueError(f"transfer must be 'rgb' or 'i420', got "
                         f"{transfer!r}")
    mean, std = model.mean, model.std
    # DDIM clips each x0 prediction to the image of [0, 1] pixels under
    # the model's own statistics.
    clip = (min((0.0 - m) / s for m, s in zip(mean, std)),
            max((1.0 - m) / s for m, s in zip(mean, std)))

    def pipeline(frames_u8: torch.Tensor, batch_idx: int) -> torch.Tensor:
        with torch.inference_mode():
            if transfer == "i420":
                frames_u8 = i420_to_rgb(frames_u8)
            x = normalise_batch(frames_u8, mean, std)
            if sampler_steps > 0:
                fake = swap_refine(
                    model.predict, x, steps=sampler_steps, clip=clip,
                    seed=seed, offset=(replica << REPLICA_SHIFT) + batch_idx)
            else:
                fake = model.predict(x)
            fake_u8 = denormalise_to_uint8_rgb(fake, mean, std)
            return rgb_to_i420(fake_u8) if transfer == "i420" else fake_u8

    return pipeline


def crop_resize(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """An HWC frame of any size -> centre-cropped to ``width:height`` and
    cubic-resized to ``(height, width)``, channels as given: the video
    prep tool's geometry. The resize is cv2's where cv2 imports, as the
    JAX package's, else ``ops.image.resize_cubic``, OpenCV's own
    ``INTER_CUBIC`` (``data.codec.cubic_resizer``)."""
    frame = center_crop(frame, width, height)
    if frame.shape[:2] != (height, width):
        frame = cubic_resizer()(frame, (width, height))
    return frame


def prepare_frame(frame_bgr: np.ndarray, width: int, height: int
                  ) -> np.ndarray:
    """BGR frame of any size -> centre-cropped, cubic-resized RGB uint8
    ``(height, width, 3)`` (``crop_resize``)."""
    return np.ascontiguousarray(crop_resize(frame_bgr, width,
                                            height)[..., ::-1])
