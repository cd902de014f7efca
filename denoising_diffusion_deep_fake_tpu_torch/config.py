"""Typed workload configs (YAML -> validated dataclass).

Own copy of the JAX package's schema (``denoising_diffusion_deep_fake_tpu/
config.py``: ``BaseConfig``, ``DeepFakeConfig``, ``DenoiserConfig``,
``BalanceConfig``, ``config_from_dict``, ``config_to_dict``,
``_rescale_mean_std``, ``read_yaml_file_into_dict``, ``load_config``,
``overlay_config``), so the port reads the same YAML files
(``configs/denoiser.yml``, ``configs/denoise.yml``, ``configs/swap.yml``,
``configs/balance.yml``) with the same key names and defaults.
``yaml`` is imported only by ``read_yaml_file_into_dict``: the GPU machine
may lack PyYAML, and ``chip_smoke.py`` builds its config from a dict.

Every knob of the schema is ported; ``spatial_parallel > 1`` runs every
encoder family's U-Net, and the patchified one, over ``data_parallel *
spatial_parallel`` processes (``parallel/``). Beyond JAX's checks it needs
``image_size / (spatial_parallel * patchify_stem)`` an even integer: a
rank's rows split into whole patches, and the stem halves them.
"""

from __future__ import annotations

import dataclasses
import warnings

WARP_METHODS = ("auto", "gather", "shear", "hybrid", "pallas",
                "pallas_fused")


@dataclasses.dataclass
class BaseConfig:
    """Knobs shared by all three workloads."""

    batch_size: int = 16
    learning_rate: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_epochs: int = 100
    cosine_scheduler_max_epoch: int | None = None
    num_workers: int = 8
    encoder_name: str = "resnet34"

    image_size: int | None = None      # None -> inferred from the first image
    compute_dtype: str = "bfloat16"    # "float32" for parity runs
    data_parallel: int = 1
    spatial_parallel: int = 1
    seed: int = 0
    log_dir: str = "runs"
    checkpoint_dir: str = "checkpoints"
    log_every_n_steps: int = 1
    log_images: bool = True
    checkpoint_every_hours: float = 2.0
    keep_checkpoints: int = 8
    last_checkpoint_min_interval_s: float = 600.0
    steps_per_epoch: int | None = None
    class_balanced_sampling: bool = False
    handle_preemption: bool = True
    upload_format: str = "rgb"
    data_cache: str = "host"
    device_cache_limit_bytes: int = 8 << 30
    # Affine-warp route (ops/augment.py augment_batch). The names are the
    # JAX package's, so configs load unchanged: "pallas" is the two-pass
    # warp kernel and "pallas_fused" the fused one, both CUDA kernels here.
    warp_method: str = "auto"
    remat: str = "none"
    color_jitter: tuple = (0.0, 0.0, 0.0, 0.0)
    color_jitter_p: float = 1.0
    # K train steps a call (training/multi_step.py: one CUDA graph replay
    # on the card). Checkpoint and SIGTERM checks run once a group, so
    # their response grows by up to K - 1 steps; validate() warns above 64.
    # Image-panel steps and epoch tails run as single steps.
    steps_per_call: int = 1
    patchify_stem: int = 1
    matmul_precision: str = "auto"

    def validate(self) -> None:
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive")
        if not 0 <= self.adam_b1 < 1 or not 0 <= self.adam_b2 < 1:
            raise ValueError("adam betas must be in [0, 1)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not supported")
        if self.data_parallel <= 0 or self.spatial_parallel <= 0:
            raise ValueError("data_parallel and spatial_parallel must be "
                             "positive")
        if self.batch_size % self.data_parallel != 0:
            raise ValueError(
                "batch_size must divide evenly across data_parallel")
        if (self.image_size is not None
                and self.image_size % self.spatial_parallel != 0):
            raise ValueError(
                "image_size must divide evenly across spatial_parallel")
        if self.upload_format not in ("rgb", "i420"):
            raise ValueError(f"upload_format must be 'rgb' or 'i420', got "
                             f"{self.upload_format!r}")
        if self.upload_format == "i420":
            if self.spatial_parallel > 1:
                # The packed (B, H*3/2, W) layout interleaves the planes
                # along dim 1: H-sharding it would split them.
                raise ValueError(
                    "upload_format='i420' is incompatible with "
                    "spatial_parallel > 1 — use upload_format='rgb'")
            if self.image_size is not None and self.image_size % 4 != 0:
                raise ValueError(
                    "upload_format='i420' needs image_size % 4 == 0, got "
                    f"{self.image_size}")
        if self.data_cache not in ("host", "device"):
            raise ValueError(f"data_cache must be 'host' or 'device', got "
                             f"{self.data_cache!r}")
        if self.data_cache == "device" and self.upload_format != "rgb":
            raise ValueError(
                "data_cache='device' already eliminates per-step uploads — "
                "use upload_format='rgb' with it")
        if self.data_cache == "device" and self.spatial_parallel > 1:
            raise ValueError(
                "data_cache='device' supports the data axis only; use "
                "data_cache='host' with spatial_parallel > 1")
        if self.warp_method not in WARP_METHODS:
            raise ValueError(f"unknown warp_method {self.warp_method!r}")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"unknown remat policy {self.remat!r}")
        if self.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        if self.steps_per_call > 64:
            warnings.warn(
                f"steps_per_call={self.steps_per_call}: checkpoint/"
                "preemption checks run once per dispatched group, so the "
                "SIGTERM response latency grows by (k-1) steps — make sure "
                "the group's wall time stays well inside the preemption "
                "grace window (see config field note)", stacklevel=2)
        if self.patchify_stem < 1:
            raise ValueError("patchify_stem must be >= 1")
        if (self.patchify_stem > 1 and self.image_size is not None
                and self.image_size % (32 * self.patchify_stem)):
            raise ValueError(
                f"patchify_stem={self.patchify_stem} needs image_size "
                f"divisible by {32 * self.patchify_stem} "
                f"(got {self.image_size})")
        split = self.spatial_parallel * self.patchify_stem
        if (self.spatial_parallel > 1 and self.image_size is not None
                and self.image_size % self.spatial_parallel == 0
                and (self.image_size % split
                     or self.image_size // split % 2)):
            raise ValueError(
                f"image_size {self.image_size} over spatial_parallel="
                f"{self.spatial_parallel} with patchify_stem="
                f"{self.patchify_stem}: image_size / (spatial_parallel * "
                f"patchify_stem) = {self.image_size / split:g} must be an "
                "even integer (a rank's rows split into whole patches, and "
                "the U-Net's stem halves them)")
        if len(tuple(self.color_jitter)) != 4:
            raise ValueError(
                "color_jitter must be (brightness, contrast, saturation, "
                f"hue), got {self.color_jitter!r}")
        from denoising_diffusion_deep_fake_tpu_torch.ops.color import (
            ColorJitterConfig)

        ColorJitterConfig(*self.color_jitter,  # range validation
                          probability=self.color_jitter_p)

    @property
    def cosine_t_max(self) -> int:
        return (self.cosine_scheduler_max_epoch
                if self.cosine_scheduler_max_epoch is not None
                else self.max_epochs)


@dataclasses.dataclass
class DeepFakeConfig(BaseConfig):
    """Two-identity trainer (reference `d3f train`, denoise + swap modes)."""

    mode: str = "denoise"
    data_path_a: str = ""
    data_path_b: str = ""
    mean_a: tuple = (0.5, 0.5, 0.5)
    std_a: tuple = (0.5, 0.5, 0.5)
    mean_b: tuple = (0.5, 0.5, 0.5)
    std_b: tuple = (0.5, 0.5, 0.5)
    noise_exponential_sampling_lambda: float = 5.0
    ema_beta: float = 0.9999
    ema_update_every: int = 1
    ema_update_after_step: int = 100   # ema_pytorch default, made explicit
    # albumentations ShiftScaleRotate (lit_module.py:99-111), applied on the
    # device by ops/augment.py.
    aug_shift_limit: float = 0.2
    aug_scale_limit: float = 0.1
    aug_rotate_limit: float = 15.0
    aug_probability: float = 0.7

    def validate(self) -> None:
        super().validate()
        if self.mode not in ("denoise", "swap"):
            raise ValueError(
                f"mode must be 'denoise' or 'swap', got {self.mode!r}")
        if not self.data_path_a or not self.data_path_b:
            raise ValueError("data_path_a and data_path_b are required")
        if self.noise_exponential_sampling_lambda <= 0:
            raise ValueError(
                "noise_exponential_sampling_lambda must be positive")


def _rescale_mean_std(cfg) -> None:
    """Auto-convert 0-255-scale mean/std to 0-1 scale."""
    if any(v > 1.0 for v in cfg.mean) or any(v > 1.0 for v in cfg.std):
        warnings.warn(
            "mean/std look 0-255-scaled; dividing by 255 (the reference's "
            "denoiser configs predate its albumentations switch)",
            stacklevel=3)
        cfg.mean = tuple(v / 255.0 for v in cfg.mean)
        cfg.std = tuple(v / 255.0 for v in cfg.std)


@dataclasses.dataclass
class DenoiserConfig(BaseConfig):
    """Single-model denoiser pretrainer (reference `d3f denoise`)."""

    input_image_list_path: str = ""
    mean: tuple = (0.5, 0.5, 0.5)
    std: tuple = (0.5, 0.5, 0.5)
    noise_exponential_sampling_lambda: float = 5.0
    # Kornia RandomAffine parity (train_denoiser/lit_module.py:55-65).
    aug_degrees: float = 15.0
    aug_translate: float = 0.2
    aug_scale_min: float = 0.8
    aug_scale_max: float = 1.2

    def validate(self) -> None:
        super().validate()
        if not self.input_image_list_path:
            raise ValueError("input_image_list_path is required")
        _rescale_mean_std(self)


@dataclasses.dataclass
class BalanceConfig(BaseConfig):
    """Difficulty balancer (reference `d3f balance`), with the output list
    the reference accepted but never wrote."""

    data_path: str = ""
    output_image_list_path: str = ""
    mean: tuple = (0.5, 0.5, 0.5)
    std: tuple = (0.5, 0.5, 0.5)
    ratio_of_noise: float = 0.7
    number_of_classes: int = 10

    def validate(self) -> None:
        super().validate()
        if not self.data_path:
            raise ValueError("data_path is required")
        if not 0.0 <= self.ratio_of_noise <= 1.0:
            raise ValueError("ratio_of_noise must be in [0, 1]")
        if self.number_of_classes <= 0:
            raise ValueError("number_of_classes must be positive")
        _rescale_mean_std(self)


def config_from_dict(cls, data: dict, *, validate: bool = True):
    """Build a config dataclass from a (YAML) dict, warning on unknown keys."""
    field_names = {f.name for f in dataclasses.fields(cls)}
    known = {}
    for key, value in data.items():
        if key in field_names:
            known[key] = tuple(value) if isinstance(value, list) else value
        else:
            warnings.warn(f"unknown config key {key!r} ignored", stacklevel=2)
    cfg = cls(**known)
    if validate:
        cfg.validate()
    return cfg


def config_to_dict(cfg) -> dict:
    """The config as JSON-ready hparams: tuples become lists."""
    d = dataclasses.asdict(cfg)
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}


def read_yaml_file_into_dict(path) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    return data


def load_config(cls, yaml_path, overrides: dict | None = None):
    """YAML -> config, with optional overrides applied on top."""
    data = read_yaml_file_into_dict(yaml_path)
    if overrides:
        data.update({k: v for k, v in overrides.items() if v is not None})
    return config_from_dict(cls, data)


def overlay_config(cls, base: dict, new: dict):
    """``modify`` semantics: checkpoint hparams with the new YAML's keys on
    top; keys the new YAML leaves out keep the checkpoint's values."""
    return config_from_dict(cls, {**base, **new})
