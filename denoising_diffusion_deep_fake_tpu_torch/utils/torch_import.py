"""Import reference (Lightning) checkpoints into the port.

Port of ``denoising_diffusion_deep_fake_tpu/utils/torch_import.py:440-535``
for every encoder family. The reference trains
``segmentation_models_pytorch.Unet`` models inside a Lightning module, so
its users hold ``.ckpt`` files: ``torch.save`` of ``{"state_dict",
"hyper_parameters", "epoch", "global_step", ...}`` whose state_dict keys
are smp's under ``model_a.`` / ``model_b.`` and, in swap mode,
``ema_model_a.ema_model.`` / ``ema_model_b.ema_model.`` (ema_pytorch),
beside ``criterion.*`` (the SSIM window) and the EMA's ``initted`` /
``step`` buffers.

The port's U-Net already carries smp's key names (``models/``), so the
mapping is the identity on keys: BN's ``num_batches_tracked`` is dropped
(the port's ``BatchNorm2d`` has none) and every other key must be one of the
port's U-Net of the checkpoint's ``encoder_name``, at its shape. A key that
is not raises and names the keys, as JAX's "unmapped torch keys" does: so
an EfficientNet file that carries efficientnet-pytorch's classifier head
(``encoder._conv_head``, ``._bn1``, ``._fc``, which smp never runs and
neither package builds) raises, as JAX's importer does.

``import_reference_checkpoint`` is a file conversion on the host, as
JAX's is: it reads and writes CPU tensors, launches nothing and so takes no
``device``. That is not a CPU fallback of a device path; the states it
writes restore on the card through ``fit_deep_fake(resume_from=...)``,
``train resume|modify`` and ``load_swap_model``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    DeepFakeConfig,
    config_from_dict,
    config_to_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.inference import IDENTITIES
from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    freeze_running_stats_,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import (
    create_unet,
    unet_shapes,
)
from denoising_diffusion_deep_fake_tpu_torch.training.optim import make_adam
from denoising_diffusion_deep_fake_tpu_torch.training.state import (
    ModelState,
)

def _listed(keys) -> str:
    keys = sorted(keys)
    return f"{keys[:8]}{'...' if len(keys) > 8 else ''}"


def state_dict_from_smp(sd: dict, encoder_name: str
                        ) -> dict[str, torch.Tensor]:
    """A reference smp-Unet state_dict -> the port's ``Unet`` state_dict
    (fp32 CPU tensors): ``num_batches_tracked`` dropped; keys the port's
    U-Net lacks, keys it has that ``sd`` lacks, and other shapes raise."""
    template = unet_shapes(encoder_name)
    out, unmapped = {}, []
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in template:
            unmapped.append(key)
            continue
        out[key] = torch.as_tensor(value).detach().to(
            "cpu", torch.float32).contiguous()
    if unmapped:
        raise ValueError(f"unmapped torch keys: {_listed(unmapped)} (the "
                         f"port's {encoder_name} U-Net has smp's keys)")
    missing = set(template) - set(out)
    if missing:
        raise ValueError(f"the {encoder_name} U-Net needs keys the "
                         f"checkpoint lacks: {_listed(missing)}")
    shapes = [f"{k} {tuple(v.shape)} != {tuple(template[k])}"
              for k, v in out.items() if v.shape != template[k]]
    if shapes:
        raise ValueError(f"shape mismatch: {shapes[:8]}")
    return out


def split_lightning_state_dict(sd: dict) -> dict[str, dict]:
    """Group a Lightning checkpoint state_dict by model prefix.

    Returns e.g. ``{"model_a": {...}, "model_b": {...}, "ema_model_a":
    {...}}`` with per-model smp-relative keys. EMA entries are
    ema_pytorch's ``ema_model_a.ema_model.<smp key>``; its ``initted`` /
    ``step`` buffers and any other EMA subkey (an online copy) are
    dropped, and so is ``criterion.*`` (the SSIM window, recomputed)."""
    groups: dict[str, dict] = {}
    for name, value in sd.items():
        parts = name.split(".", 1)
        if len(parts) != 2:
            continue
        prefix, rest = parts
        if prefix.startswith("ema_model"):
            sub = rest.split(".", 1)
            if sub[0] != "ema_model" or len(sub) != 2:
                continue
            rest = sub[1]
        elif prefix == "criterion":
            continue
        groups.setdefault(prefix, {})[rest] = value
    return groups


def load_reference_checkpoint(ckpt_path) -> dict:
    """Read a reference ``.ckpt``: ``{model_name: port state_dict}`` for
    each model prefix, plus ``"hyper_parameters"`` and ``"lightning_meta"``
    (``epoch``, ``global_step``)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    hp = dict(ckpt.get("hyper_parameters", {}))
    encoder_name = hp.get("encoder_name", DeepFakeConfig.encoder_name)
    out = {name: state_dict_from_smp(model_sd, encoder_name)
           for name, model_sd in split_lightning_state_dict(
               ckpt["state_dict"]).items()}
    out["hyper_parameters"] = hp
    out["lightning_meta"] = {"epoch": int(ckpt.get("epoch", 0)),
                             "global_step": int(ckpt.get("global_step", 0))}
    return out


def _module(encoder_name: str, state_dict: dict) -> torch.nn.Module:
    """The port's U-Net on the CPU holding ``state_dict``'s tensors: built
    on the meta device and given them, so nothing is drawn or copied."""
    with torch.device("meta"):
        model = create_unet(encoder_name)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model


def import_reference_checkpoint(ckpt_path, output_dir, *,
                                keep: int = 8) -> Path:
    """Convert a reference Lightning ``.ckpt`` into the port's checkpoint
    layout (``checkpoint.py``): the migration path for the reference's
    users. Returns the step folder written.

    Weights, EMA shadows, BN statistics, hyperparameters and the epoch /
    global-step counters carry over; each identity gets a fresh Adam from
    the config and ``step = ema_step = 0`` (Adam's state is not portable
    across frameworks, as in the reference's own ``modify``). A checkpoint
    with EMA keys is a swap-mode one. Saved at ``global_step`` with
    ``extra = {epoch, global_step, workload, imported_from}``."""
    imported = load_reference_checkpoint(ckpt_path)
    hp = imported.pop("hyper_parameters")
    lightning_meta = imported.pop("lightning_meta")
    has_ema = any(k.startswith("ema_model") for k in imported)
    cfg = config_from_dict(DeepFakeConfig, hp, validate=False)
    if has_ema:
        cfg.mode = "swap"  # EMA shadows only exist in swap mode
    wanted = [f"{p}{i}" for i in IDENTITIES
              for p in ("model_",) + (("ema_model_",) if has_ema else ())]
    absent = [name for name in wanted if name not in imported]
    if absent:
        raise ValueError(f"{ckpt_path}: no {absent} keys in its state_dict "
                         f"(it has {sorted(imported)})")

    def build_state(ident: str) -> ModelState:
        model = _module(cfg.encoder_name, imported[f"model_{ident}"])
        optimizer = make_adam(model.parameters(), cfg.learning_rate,
                              b1=cfg.adam_b1, b2=cfg.adam_b2,
                              device=torch.device("cpu"))
        state = ModelState(model=model, optimizer=optimizer, step=0)
        if has_ema:
            shadow = _module(cfg.encoder_name, imported[f"ema_model_{ident}"])
            state.ema_model = freeze_running_stats_(
                shadow.requires_grad_(False))
            state.ema_step = 0
        return state

    states = {ident: build_state(ident) for ident in IDENTITIES}
    manager = CheckpointManager(output_dir, keep=keep)
    extra = {"epoch": lightning_meta["epoch"],
             "global_step": lightning_meta["global_step"],
             "workload": "deep_fake",
             "imported_from": str(ckpt_path)}
    return manager.save(lightning_meta["global_step"], states,
                        config_to_dict(cfg), extra)
