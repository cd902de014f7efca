"""Export the port's checkpoints back to the reference's Lightning format.

Port of ``denoising_diffusion_deep_fake_tpu/utils/torch_export.py:64-122``
(``export_smp_unet_state_dict``), the resnet branch of
``export_unet_state_dict`` (``:244-259``) and
``export_reference_checkpoint`` (``:262-337``): the inverse of
``utils/torch_import.py``. A model trained on the card goes back to anyone
running the reference, whose Lightning module loads ``state_dict`` keys of
smp's Unet under ``model_{a,b}.`` and ``ema_model_{a,b}.ema_model.``.

The port's U-Net has smp's keys in every family it builds, EfficientNet's
included, so a model's export is its state_dict with
BN's ``num_batches_tracked`` put back as int64 zero scalars after each
``running_mean`` (the reference's strict load expects them). JAX's
probe inversion (``:125-241``) is the port's way in from flax weights,
``utils/jax_weights.py``; a file needs none.

Like the import, this is a conversion of files on the host: CPU tensors
in, a ``.ckpt`` out, no launch.
"""

from __future__ import annotations

import torch

from denoising_diffusion_deep_fake_tpu_torch.checkpoint import (
    SINGLE,
    CheckpointManager,
)
from denoising_diffusion_deep_fake_tpu_torch.config import (
    DeepFakeConfig,
    config_from_dict,
)
from denoising_diffusion_deep_fake_tpu_torch.inference import IDENTITIES
from denoising_diffusion_deep_fake_tpu_torch.models.unet import unet_shapes


def export_unet_state_dict(state_dict: dict, encoder_name: str
                           ) -> dict[str, torch.Tensor]:
    """The port's ``Unet`` state_dict -> a reference smp-Unet state_dict:
    contiguous CPU tensors in the port's key order, with a
    ``num_batches_tracked`` int64 zero after each BN's ``running_mean``.
    The keys must be those of the port's ``encoder_name`` U-Net."""
    template = unet_shapes(encoder_name)
    if set(state_dict) != set(template):
        raise ValueError(
            f"not a {encoder_name} U-Net state_dict: missing "
            f"{sorted(set(template) - set(state_dict))[:8]}, unexpected "
            f"{sorted(set(state_dict) - set(template))[:8]}")
    sd = {}
    for key, value in state_dict.items():
        sd[key] = value.detach().to("cpu").contiguous()
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return sd


def export_reference_checkpoint(ckpt_dir, output_path, *,
                                step: int | None = None) -> dict:
    """A deep-fake checkpoint of the port -> a Lightning ``.ckpt`` the
    reference loads.

    Writes ``{"state_dict", "hyper_parameters", "epoch", "global_step",
    "pytorch-lightning_version"}`` with ``model_{a,b}.*`` and, from a
    swap-mode checkpoint, ``ema_model_{a,b}.ema_model.*`` plus
    ema_pytorch's ``initted`` and ``step`` buffers. No ``online_model.*``
    key is written (the reference builds its EMA with
    ``include_online_model=False``) and no ``criterion.*`` key (the SSIM
    window's buffer names depend on the reference's piqa version, so it
    loads such a file with ``strict=False``, as its ``modify`` does).
    Returns ``{"keys", "global_step", "identities"}``."""
    manager = CheckpointManager(ckpt_dir)
    meta = manager.read_meta(step)
    step = meta["step"]
    hparams, extra = meta["hparams"], meta.get("extra", {})
    if int(hparams.get("patchify_stem", 1) or 1) > 1:
        raise ValueError(
            "this checkpoint was trained with patchify_stem > 1 — a "
            "non-parity architecture the reference's smp.Unet cannot "
            "represent; export is not possible")
    folders = sorted(p.name for p in manager.step_dir(step).iterdir()
                     if p.is_dir())
    if folders != list(IDENTITIES):
        kind = ("a single-model (denoiser or balancer) checkpoint"
                if folders == [SINGLE] else f"states {folders}")
        raise ValueError(
            f"{ckpt_dir} holds {kind}; export writes the reference's "
            "two-identity deep-fake layout only")
    cfg = config_from_dict(DeepFakeConfig, hparams, validate=False)
    with_ema = hparams.get("mode", cfg.mode) == "swap"

    sd: dict[str, torch.Tensor] = {}
    for ident in IDENTITIES:
        parts = ["model", "counters"] + (["ema_model"] if with_ema else [])
        saved = manager.restore_partial(ident, parts, step=step,
                                        device="cpu")
        for k, v in export_unet_state_dict(saved["model"],
                                           cfg.encoder_name).items():
            sd[f"model_{ident}.{k}"] = v
        if with_ema:
            for k, v in export_unet_state_dict(saved["ema_model"],
                                               cfg.encoder_name).items():
                sd[f"ema_model_{ident}.ema_model.{k}"] = v
            sd[f"ema_model_{ident}.initted"] = torch.tensor(True)
            sd[f"ema_model_{ident}.step"] = torch.tensor(
                int(saved["counters"]["ema_step"]))

    global_step = int(extra.get("global_step", step))
    torch.save({
        "state_dict": sd,
        "hyper_parameters": hparams,
        "epoch": int(extra.get("epoch", 0)),
        "global_step": global_step,
        "pytorch-lightning_version": "1.8.0",
    }, output_path)
    return {"keys": len(sd), "global_step": global_step,
            "identities": list(IDENTITIES)}
