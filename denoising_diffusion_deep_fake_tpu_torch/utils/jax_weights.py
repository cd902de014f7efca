"""Carry the JAX package's U-Net weights into the port.

Turns flax ``params`` and ``batch_stats`` (nested dicts of numpy arrays, as
``jax.device_get`` returns them) into the port's ``Unet`` state_dict, whose
keys are smp's. The mapping is the one the JAX package's exporter uses
(``denoising_diffusion_deep_fake_tpu/utils/torch_export.py:44-125``, the
inverse of ``utils/torch_import.py``), kept here as its own copy: conv
kernels go HWIO -> OIHW, BN ``scale``/``bias`` -> ``weight``/``bias``,
``mean``/``var`` -> ``running_mean``/``running_var``.

``load_jax_state`` carries a whole JAX ``ModelState`` (``training/state.py``
there) into the port's: the online weights, and where present the EMA
shadow's weights and ``ema_step``, plus ``step``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _kernel_to_torch(k) -> np.ndarray:
    """HWIO (flax) -> OIHW (torch)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _torch_key(path: tuple, stat: bool) -> tuple[str, bool]:
    """(port state_dict key, is a conv kernel) for one flax leaf path."""
    bn = _BN_STAT if stat else _BN_PARAM
    name, rest = path[0], path[1:]
    if name == "encoder":
        sub = rest[0]
        m = re.fullmatch(r"layer(\d)_(\d+)", sub)
        if m:
            base = f"encoder.layer{m.group(1)}.{m.group(2)}"
            child = rest[1]
            if child == "downsample_conv":
                return f"{base}.downsample.0.weight", True
            if child == "downsample_bn":
                return f"{base}.downsample.1.{bn[rest[2]]}", False
            if rest[-1] == "kernel":
                return f"{base}.{child}.weight", True
            return f"{base}.{child}.{bn[rest[-1]]}", False
        if sub == "conv1":
            return "encoder.conv1.weight", True
        if sub == "bn1":
            return f"encoder.bn1.{bn[rest[1]]}", False
    elif name.startswith("decoder_block"):
        base = f"decoder.blocks.{name[len('decoder_block'):]}.{rest[0]}"
        if rest[1] == "conv":
            return f"{base}.0.weight", True
        return f"{base}.1.{bn[rest[-1]]}", False
    elif name == "segmentation_head":
        if rest[0] == "kernel":
            return "segmentation_head.0.weight", True
        return "segmentation_head.0.bias", False
    raise ValueError(f"unmapped flax key {'.'.join(path)} (the port has the "
                     "resnet family's U-Nets only; the other encoder "
                     "families are ROADMAP A11)")


def state_dict_from_jax(params: dict, batch_stats: dict
                        ) -> dict[str, torch.Tensor]:
    """flax U-Net variables -> the port's ``Unet`` state_dict (fp32)."""
    sd = {}
    for stat, tree in ((False, params), (True, batch_stats)):
        for path, value in _flatten(tree).items():
            key, is_kernel = _torch_key(path, stat)
            value = _kernel_to_torch(value) if is_kernel else value
            sd[key] = torch.from_numpy(
                np.array(value, dtype=np.float32, copy=True))
    return sd


def load_jax_state(state, jax_state) -> None:
    """Fill the port's ``ModelState`` in place from a JAX ``ModelState``
    whose arrays are on the host (``jax.device_get``): ``params`` and
    ``batch_stats`` into the model, ``ema_params`` and ``ema_batch_stats``
    into a shadow (attached when the port state has none) with
    ``ema_step``, and ``step``. The optimizer's moments are not carried."""
    state.model.load_state_dict(state_dict_from_jax(jax_state.params,
                                                    jax_state.batch_stats))
    state.step = int(jax_state.step)
    if jax_state.ema_params is not None:
        if not state.has_ema:
            state.attach_ema()
        state.ema_model.load_state_dict(state_dict_from_jax(
            jax_state.ema_params, jax_state.ema_batch_stats))
        state.ema_step = int(jax_state.ema_step)
