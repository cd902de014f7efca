"""Carry the JAX package's U-Net weights into the port.

Turns flax ``params`` and ``batch_stats`` (nested dicts of numpy arrays, as
``jax.device_get`` returns them) into the port's ``Unet`` state_dict, whose
keys are smp's: conv kernels HWIO -> OIHW, BN ``scale``/``bias`` ->
``weight``/``bias``, ``mean``/``var`` -> ``running_mean``/``running_var``.

Two maps, as the JAX package's exporter has them
(``denoising_diffusion_deep_fake_tpu/utils/torch_export.py``):

* ``_torch_key``, handwritten, for the resnet family (``:64-122``);
* a probe inversion for every family (``:125-241``): the port's own copy
  of JAX's smp -> flax key map (``convert_smp_unet_state_dict`` and its
  helpers, ``utils/torch_import.py:32-438`` there, numpy only) is run on a
  template of the port's U-Net (``unet_shapes``, on the meta device) whose
  every element holds its own index, and each flax leaf element is read
  back as the torch element it came from. The map must move values and do
  no arithmetic: a value that is not an integral index, an element no leaf
  produces, or one that two leaves produce, raises.

``load_jax_state`` carries a whole JAX ``ModelState`` (``training/state.py``
there) into the port's: the online weights, and where present the EMA
shadow's weights and ``ema_step``, plus ``step``.

A patchified U-Net (``patchify > 1``) holds its U-Net under ``unet`` in
both packages: flax ``unet/...``, the port ``unet.<smp key>``; its inner
U-Net has ``3 p^2`` input and output channels, and the maps run on it.
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

from denoising_diffusion_deep_fake_tpu_torch.models.resnet import (
    RESNET_SPECS,
)
from denoising_diffusion_deep_fake_tpu_torch.models.unet import unet_shapes

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
    raise ValueError(f"unmapped flax key {'.'.join(path)}: the handwritten "
                     "map covers the resnet family; pass encoder_name")



# ---- the port's copy of the JAX package's smp -> flax key map ----------


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


_SMP_BN_PARAM = {"weight": "scale", "bias": "bias"}
_SMP_BN_STAT = {"running_mean": "mean", "running_var": "var"}


def convert_smp_unet_state_dict(sd: dict[str, np.ndarray]) -> tuple[dict, dict]:
    """torch smp-Unet state_dict (numpy values) -> (params, batch_stats)."""
    params: dict = {}
    stats: dict = {}
    unused = []
    # VGG encoders interleave convs (which have biases) and BNs in one flat
    # ``features`` list — which indices are BNs is only visible from their
    # running stats, so scan once up front.
    vgg_bn_indices = {p[2] for k in sd
                      if (p := k.split("."))[0] == "encoder"
                      and len(p) == 4 and p[1] == "features"
                      and p[3] == "running_mean"}
    for name, value in sd.items():
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        handled = _convert_entry(parts, np.asarray(value), params, stats,
                                 vgg_bn_indices)
        if not handled:
            unused.append(name)
    if unused:
        raise ValueError(f"unmapped torch keys: {unused[:8]}"
                         f"{'...' if len(unused) > 8 else ''}")
    return params, stats


def _convert_entry(parts: list[str], value: np.ndarray, params: dict,
                   stats: dict, vgg_bn_indices: set | frozenset = frozenset()
                   ) -> bool:
    leaf = parts[-1]

    # ---- encoder ----
    if parts[0] == "encoder":
        if parts[1] == "features":
            return _features_entry(parts, leaf, value, params, stats,
                                   vgg_bn_indices)
        # EfficientNet (efficientnet-pytorch naming): encoder._conv_stem /
        # ._bn0 / ._blocks.{i}._{module}.{leaf} -> flattened flax names
        # (models/efficientnet.py).
        if parts[1] == "_conv_stem" and leaf == "weight":
            _set(params, ["encoder", "conv_stem", "kernel"],
                 _conv_kernel(value))
            return True
        if parts[1] == "_bn0":
            return _bn_entry(["encoder", "bn0"], leaf, value, params, stats)
        if parts[1] == "_blocks" and len(parts) == 5:
            name = f"blocks_{parts[2]}_{parts[3].lstrip('_')}"
            if "conv" in parts[3] or "_se_" in parts[3]:
                if leaf == "weight":
                    _set(params, ["encoder", name, "kernel"],
                         _conv_kernel(value))
                    return True
                if leaf == "bias":  # SE convs carry biases
                    _set(params, ["encoder", name, "bias"], value)
                    return True
                return False
            return _bn_entry(["encoder", name], leaf, value, params, stats)
        if parts[1] == "conv1" and leaf == "weight":
            _set(params, ["encoder", "conv1", "kernel"], _conv_kernel(value))
            return True
        if parts[1] == "bn1":
            return _bn_entry(["encoder", "bn1"], leaf, value, params, stats)
        # SE-Net stem (pretrainedmodels): encoder.layer0.{conv,bn}{i}.<leaf>
        # -> flattened layer0_conv{i} / layer0_bn{i} (models/senet.py).
        if parts[1] == "layer0":
            if parts[2].startswith("conv") and leaf == "weight":
                _set(params, ["encoder", f"layer0_{parts[2]}", "kernel"],
                     _conv_kernel(value))
                return True
            if parts[2].startswith("bn"):
                return _bn_entry(["encoder", f"layer0_{parts[2]}"], leaf,
                                 value, params, stats)
            return False
        # Inception-ResNet-v2 (Cadene named attributes): BasicConv2d stems
        # (conv2d_*), mixed_5b/6a/7a branch modules, repeat/repeat_1/repeat_2
        # Sequentials of residual blocks (flattened to repeat[_k]_{i}), and
        # the standalone block8 (distinguished from xception's block8 by its
        # branch*/conv2d children).
        if parts[1].startswith("conv2d_") or parts[1].startswith("mixed_"):
            return _ir_module_entry(["encoder", parts[1]], parts[2:], leaf,
                                    value, params, stats)
        if parts[1] in ("repeat", "repeat_1", "repeat_2") and len(parts) > 3:
            return _ir_module_entry(["encoder", f"{parts[1]}_{parts[2]}"],
                                    parts[3:], leaf, value, params, stats)
        if parts[1] == "block8" and parts[2] in ("branch0", "branch1",
                                                 "conv2d"):
            return _ir_module_entry(["encoder", "block8"], parts[2:], leaf,
                                    value, params, stats)
        # Xception (Cadene naming; models/xception.py mirrors the torch
        # Sequential indices): encoder.block{i}.rep.{j}.{conv1|pointwise}
        # (SeparableConv2d) or a BN directly at index j; skip/skipbn;
        # stem conv2/bn2 and the deep conv3/conv4 SeparableConvs + bn3/bn4.
        if re.fullmatch(r"block\d+", parts[1]):
            blk = parts[1]
            if parts[2] == "rep":
                name = f"rep{parts[3]}"
                if len(parts) == 6 and parts[4] in ("conv1", "pointwise"):
                    if leaf == "weight":
                        _set(params, ["encoder", blk, name, parts[4],
                                      "kernel"], _conv_kernel(value))
                        return True
                    return False
                return _bn_entry(["encoder", blk, name], leaf, value,
                                 params, stats)
            if parts[2] == "skip" and leaf == "weight":
                _set(params, ["encoder", blk, "skip", "kernel"],
                     _conv_kernel(value))
                return True
            if parts[2] == "skipbn":
                return _bn_entry(["encoder", blk, "skipbn"], leaf, value,
                                 params, stats)
            return False
        if parts[1] == "conv2" and len(parts) == 3 and leaf == "weight":
            _set(params, ["encoder", "conv2", "kernel"], _conv_kernel(value))
            return True
        if parts[1] in ("bn2", "bn3", "bn4"):
            return _bn_entry(["encoder", parts[1]], leaf, value, params,
                             stats)
        if (parts[1] in ("conv3", "conv4") and len(parts) == 4
                and parts[2] in ("conv1", "pointwise") and leaf == "weight"):
            _set(params, ["encoder", parts[1], parts[2], "kernel"],
                 _conv_kernel(value))
            return True
        m = re.fullmatch(r"layer(\d)", parts[1])
        if m:
            block = f"layer{m.group(1)}_{parts[2]}"
            sub = parts[3]
            if sub == "se_module":
                # encoder.layerL.i.se_module.fc{1,2}.{weight,bias} -> se_fc{k}
                if leaf == "weight":
                    _set(params, ["encoder", block, f"se_{parts[4]}",
                                  "kernel"], _conv_kernel(value))
                    return True
                if leaf == "bias":
                    _set(params, ["encoder", block, f"se_{parts[4]}", "bias"],
                         value)
                    return True
                return False
            if sub.startswith("conv") and leaf == "weight":
                _set(params, ["encoder", block, sub, "kernel"],
                     _conv_kernel(value))
                return True
            if sub.startswith("bn"):
                return _bn_entry(["encoder", block, sub], leaf, value,
                                 params, stats)
            if sub == "downsample":
                if parts[4] == "0" and leaf == "weight":
                    _set(params, ["encoder", block, "downsample_conv",
                                  "kernel"], _conv_kernel(value))
                    return True
                if parts[4] == "1":
                    return _bn_entry(["encoder", block, "downsample_bn"],
                                     leaf, value, params, stats)
        return False

    # ---- decoder ----
    if parts[0] == "decoder" and parts[1] == "center":
        # vgg-only CenterBlock: decoder.center.<i>.{0,1}.<leaf> with i the
        # Conv2dReLU index (0|1), 0=conv / 1=bn -> center_conv{i+1}/{conv,bn}.
        block = f"center_conv{int(parts[2]) + 1}"
        if parts[3] == "0" and leaf == "weight":
            _set(params, [block, "conv", "kernel"], _conv_kernel(value))
            return True
        if parts[3] == "1":
            return _bn_entry([block, "bn"], leaf, value, params, stats)
        return False
    if parts[0] == "decoder" and parts[1] == "blocks":
        block = f"decoder_block{parts[2]}"
        conv_block = parts[3]  # conv1 | conv2
        which = parts[4]       # 0 = conv, 1 = bn (smp Conv2dReLU Sequential)
        if which == "0" and leaf == "weight":
            _set(params, [block, conv_block, "conv", "kernel"],
                 _conv_kernel(value))
            return True
        if which == "1":
            return _bn_entry([block, conv_block, "bn"], leaf, value,
                             params, stats)
        return False

    # ---- segmentation head ----
    if parts[0] == "segmentation_head" and parts[1] == "0":
        if leaf == "weight":
            _set(params, ["segmentation_head", "kernel"], _conv_kernel(value))
            return True
        if leaf == "bias":
            _set(params, ["segmentation_head", "bias"], value)
            return True
    return False


def _ir_module_entry(base: list[str], rest: list[str], leaf: str,
                     value: np.ndarray, params: dict, stats: dict) -> bool:
    """Keys inside one Cadene inception-resnet module (after its name):
    ``{conv,bn}.<leaf>`` (BasicConv2d body), ``conv2d.<leaf>`` (the plain
    biased up-projection), ``branchX[.j].{conv,bn}.<leaf>``."""
    if len(rest) == 2 and rest[0] in ("conv", "bn"):
        if rest[0] == "conv":
            if leaf == "weight":
                _set(params, base + ["conv", "kernel"], _conv_kernel(value))
                return True
            return False
        return _bn_entry(base + ["bn"], leaf, value, params, stats)
    if len(rest) == 2 and rest[0] == "conv2d":
        if leaf == "weight":
            _set(params, base + ["conv2d", "kernel"], _conv_kernel(value))
            return True
        if leaf == "bias":
            _set(params, base + ["conv2d", "bias"], value)
            return True
        return False
    if rest and rest[0].startswith("branch"):
        if len(rest) == 3:
            name, sub = rest[0], rest[1]
        elif len(rest) == 4:
            name, sub = f"{rest[0]}_{rest[1]}", rest[2]
        else:
            return False
        if sub == "conv" and leaf == "weight":
            _set(params, base + [name, "conv", "kernel"],
                 _conv_kernel(value))
            return True
        if sub == "bn":
            return _bn_entry(base + [name, "bn"], leaf, value, params, stats)
    return False


def _features_entry(parts: list[str], leaf: str, value: np.ndarray,
                    params: dict, stats: dict,
                    vgg_bn_indices: set | frozenset) -> bool:
    """``encoder.features.*`` keys: VGG's flat conv/bn list, MobileNetV2's
    stem/InvertedResidual/head Sequentials, and DenseNet's named children
    (conv0/norm0, denseblock/denselayer, transition, norm5).

    Flax module names mirror the torchvision indices (``features_{i}``,
    ``conv_{k}[_{j}]`` — see models/vgg.py and models/mobilenet.py), so this
    is a mechanical rename plus the usual OIHW->HWIO kernel transpose.
    """
    idx = parts[2]

    # DenseNet: named (non-numeric) children of ``features``.
    if not idx.isdigit():
        if idx == "conv0" and leaf == "weight":
            _set(params, ["encoder", "conv0", "kernel"], _conv_kernel(value))
            return True
        if idx in ("norm0", "norm5"):
            return _bn_entry(["encoder", idx], leaf, value, params, stats)
        if idx.startswith("denseblock") and len(parts) == 6:
            # encoder.features.denseblock{i}.denselayer{j}.<mod>.<leaf>
            name = f"{idx}_{parts[3]}_{parts[4]}"
            if parts[4].startswith("conv"):
                if leaf == "weight":
                    _set(params, ["encoder", name, "kernel"],
                         _conv_kernel(value))
                    return True
                return False
            return _bn_entry(["encoder", name], leaf, value, params, stats)
        if idx.startswith("transition") and len(parts) == 5:
            name = f"{idx}_{parts[3]}"
            if parts[3] == "conv":
                if leaf == "weight":
                    _set(params, ["encoder", name, "kernel"],
                         _conv_kernel(value))
                    return True
                return False
            return _bn_entry(["encoder", name], leaf, value, params, stats)
        # DPN (pretrainedmodels OrderedDict features): conv1_1 stem (flat
        # names here), convK_i blocks with BnActConv2d / CatBnAct children,
        # conv5_bn_ac tail, dpn68b's plain c1x1_c1/c1x1_c2 convs.
        if idx == "conv1_1":
            if parts[3] == "conv" and leaf == "weight":
                _set(params, ["encoder", "conv1_1_conv", "kernel"],
                     _conv_kernel(value))
                return True
            if parts[3] == "bn":
                return _bn_entry(["encoder", "conv1_1_bn"], leaf, value,
                                 params, stats)
            return False
        if idx == "conv5_bn_ac" and parts[3] == "bn":
            return _bn_entry(["encoder", "conv5_bn_ac", "bn"], leaf, value,
                             params, stats)
        if re.fullmatch(r"conv\d_\d+", idx):
            sub = parts[3]
            if (sub in ("c1x1_c1", "c1x1_c2") and len(parts) == 5
                    and leaf == "weight"):
                _set(params, ["encoder", idx, sub, "kernel"],
                     _conv_kernel(value))
                return True
            if len(parts) == 6 and parts[4] == "conv" and leaf == "weight":
                _set(params, ["encoder", idx, sub, "conv", "kernel"],
                     _conv_kernel(value))
                return True
            if len(parts) == 6 and parts[4] == "bn":
                return _bn_entry(["encoder", idx, sub, "bn"], leaf, value,
                                 params, stats)
        return False

    block = f"features_{idx}"

    # VGG: encoder.features.<i>.<leaf> — conv (weight+bias) or BN, telling
    # them apart only by whether index <i> carries running stats.
    if len(parts) == 4:
        if idx in vgg_bn_indices:
            return _bn_entry(["encoder", block], leaf, value, params, stats)
        if leaf == "weight":
            _set(params, ["encoder", block, "kernel"], _conv_kernel(value))
            return True
        if leaf == "bias":
            _set(params, ["encoder", block, "bias"], value)
            return True
        return False

    # MobileNetV2 stem/head ConvBNReLU: encoder.features.<i>.{0,1}.<leaf>.
    if len(parts) == 5 and parts[3] in ("0", "1"):
        if parts[3] == "0" and leaf == "weight":
            _set(params, ["encoder", block, "0", "kernel"],
                 _conv_kernel(value))
            return True
        if parts[3] == "1":
            return _bn_entry(["encoder", block, "1"], leaf, value, params,
                             stats)
        return False

    # InceptionV4 (Cadene): stem BasicConv2d (features.<i>.{conv,bn}.<leaf>),
    # Mixed_3a/5a 'conv' BasicConv2d (features.<i>.conv.{conv,bn}.<leaf>),
    # and branch modules — single BasicConv2d (features.<i>.branchX.{conv,bn})
    # or Sequential (features.<i>.branchX.<j>.{conv,bn}) -> branchX_<j>.
    if len(parts) == 5 and parts[3] in ("conv", "bn"):
        if parts[3] == "conv":
            if leaf == "weight":
                _set(params, ["encoder", block, "conv", "kernel"],
                     _conv_kernel(value))
                return True
            return False
        return _bn_entry(["encoder", block, "bn"], leaf, value, params, stats)
    if len(parts) == 6 and parts[3] == "conv" and parts[4] in ("conv", "bn"):
        if parts[4] == "conv":
            if leaf == "weight":
                _set(params, ["encoder", block, "conv", "conv", "kernel"],
                     _conv_kernel(value))
                return True
            return False
        return _bn_entry(["encoder", block, "conv", "bn"], leaf, value,
                         params, stats)
    if parts[3].startswith("branch"):
        if len(parts) == 7:
            name, sub = f"{parts[3]}_{parts[4]}", parts[5]
        elif len(parts) == 6:
            name, sub = parts[3], parts[4]
        else:
            return False
        if sub == "conv" and leaf == "weight":
            _set(params, ["encoder", block, name, "conv", "kernel"],
                 _conv_kernel(value))
            return True
        if sub == "bn":
            return _bn_entry(["encoder", block, name, "bn"], leaf, value,
                             params, stats)
        return False

    # MobileNetV2 InvertedResidual: encoder.features.<i>.conv.<k>[.<j>].<leaf>
    if parts[3] == "conv":
        k = parts[4]
        if len(parts) == 7:  # ConvBNReLU pair inside the block Sequential
            if parts[5] == "0" and leaf == "weight":
                _set(params, ["encoder", block, f"conv_{k}_0", "kernel"],
                     _conv_kernel(value))
                return True
            if parts[5] == "1":
                return _bn_entry(["encoder", block, f"conv_{k}_1"], leaf,
                                 value, params, stats)
            return False
        if len(parts) == 6:  # bare linear-projection conv or its BN
            if leaf == "weight" and value.ndim == 4:
                _set(params, ["encoder", block, f"conv_{k}", "kernel"],
                     _conv_kernel(value))
                return True
            return _bn_entry(["encoder", block, f"conv_{k}"], leaf, value,
                             params, stats)
    return False


def _bn_entry(path: list[str], leaf: str, value: np.ndarray, params: dict,
              stats: dict) -> bool:
    if leaf in _SMP_BN_PARAM:
        _set(params, path + [_SMP_BN_PARAM[leaf]], value)
        return True
    if leaf in _SMP_BN_STAT:
        _set(stats, path + [_SMP_BN_STAT[leaf]], value)
        return True
    return False



@functools.lru_cache(maxsize=4)
def _inversion_plan(encoder_name: str, patchify: int = 1
                    ) -> tuple[dict, dict]:
    """The key map's permutation for ``encoder_name``'s U-Net (the inner
    U-Net of a patchified one, its keys without ``unet.``): ``(plan,
    shapes)``, ``plan`` mapping each flax leaf path ``("params" |
    "batch_stats", *path)`` to ``(leaf shape, torch key, how)`` where
    ``how`` is "kernel" (an OIHW -> HWIO transpose), "copy", or the torch
    element of each leaf element; ``shapes`` the torch keys' shapes."""
    shapes = {k.removeprefix("unet.") if patchify > 1 else k: tuple(v)
              for k, v in unet_shapes(encoder_name, patchify).items()}
    keys = list(shapes)
    sizes = np.array([int(np.prod(shapes[k], dtype=np.int64)) for k in keys],
                     dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    # float64 holds every index exactly (2^53 elements).
    probe = {k: (np.arange(n, dtype=np.float64) + off).reshape(shapes[k])
             for k, n, off in zip(keys, sizes, offsets)}
    p_params, p_stats = convert_smp_unet_state_dict(probe)
    del probe
    plan, covered = {}, set()
    for tree_name, tree in (("params", p_params), ("batch_stats", p_stats)):
        for path, pv in _flatten(tree).items():
            where = ".".join((tree_name,) + path)
            flat = np.ravel(pv)
            ids = flat.astype(np.int64)
            if (not np.array_equal(ids.astype(np.float64), flat)
                    or ids.min(initial=0) < 0
                    or ids.max(initial=0) >= offsets[-1]):
                raise ValueError(f"the key map's transform for {where} is "
                                 "not an element permutation")
            ki = int(np.searchsorted(offsets, ids[0], side="right")) - 1
            key, size = keys[ki], int(sizes[ki])
            loc = ids - offsets[ki]
            if len(loc) != size or loc.min() < 0 or loc.max() >= size:
                raise ValueError(f"{where} is not the {size} elements of "
                                 f"one torch key ({key})")
            hit = np.zeros(size, dtype=bool)
            hit[loc] = True
            if key in covered or not hit.all():
                raise ValueError(f"torch key {key} is produced twice "
                                 f"(again by {where})")
            covered.add(key)
            order = np.arange(size)
            if np.array_equal(loc, order):
                how = "copy"
            elif len(shapes[key]) == 4 and pv.shape == tuple(
                    shapes[key][i] for i in (2, 3, 1, 0)) and np.array_equal(
                    loc.reshape(pv.shape),
                    order.reshape(shapes[key]).transpose(2, 3, 1, 0)):
                how = "kernel"
            else:
                how = loc
            plan[(tree_name,) + path] = (pv.shape, key, how)
    uncovered = sorted(set(keys) - covered)
    if uncovered:
        raise ValueError(f"torch keys of {encoder_name} that the key map "
                         f"never produces: {uncovered[:8]}")
    return plan, shapes


def state_dict_from_jax_any(params: dict, batch_stats: dict,
                            encoder_name: str, patchify: int = 1
                            ) -> dict[str, torch.Tensor]:
    """flax U-Net variables -> the port's ``encoder_name`` U-Net
    state_dict (fp32), for any family, by the probe inversion. The trees
    may hold part of the model (gradients: ``batch_stats`` empty); a leaf
    that is not the model's raises."""
    plan, shapes = _inversion_plan(encoder_name, patchify)
    if patchify > 1:
        params, batch_stats = _inner_trees(params, batch_stats)
    sd = {}
    for tree_name, tree in (("params", params), ("batch_stats",
                                                 batch_stats)):
        for path, value in _flatten(tree).items():
            entry = plan.get((tree_name,) + path)
            if entry is None:
                raise ValueError(f"{tree_name}.{'.'.join(path)} is not a "
                                 f"leaf of the {encoder_name} U-Net")
            shape, key, how = entry
            if value.shape != shape:
                raise ValueError(f"{'.'.join(path)}: shape {value.shape}, "
                                 f"the {encoder_name} U-Net's is {shape}")
            if isinstance(how, str):
                out = _kernel_to_torch(value) if how == "kernel" else value
            else:
                out = np.empty(len(how), np.float32)
                out[how] = np.ravel(value)
            sd[key] = torch.from_numpy(np.array(
                out, dtype=np.float32, copy=True).reshape(shapes[key]))
    prefix = "unet." if patchify > 1 else ""
    return {prefix + k: sd[k] for k in shapes if k in sd}


def _inner_trees(params: dict, batch_stats: dict) -> tuple[dict, dict]:
    """A patchified U-Net's flax trees -> its inner U-Net's (``unet``)."""
    if set(params) - {"unet"} or set(batch_stats) - {"unet"}:
        raise ValueError("a patchified U-Net's variables are all under "
                         "'unet'")
    return params.get("unet", {}), batch_stats.get("unet", {})


def state_dict_from_jax(params: dict, batch_stats: dict,
                        encoder_name: str | None = None, patchify: int = 1
                        ) -> dict[str, torch.Tensor]:
    """flax U-Net variables -> the port's ``Unet`` (or ``PatchifiedUnet``)
    state_dict (fp32): the handwritten map when ``encoder_name`` is None or
    a resnet-family name, else ``state_dict_from_jax_any``."""
    if encoder_name is not None and encoder_name not in RESNET_SPECS:
        return state_dict_from_jax_any(params, batch_stats, encoder_name,
                                       patchify)
    if patchify > 1:
        inner = state_dict_from_jax(*_inner_trees(params, batch_stats))
        return {f"unet.{k}": v for k, v in inner.items()}
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
    name = state.model.encoder_name
    patch = getattr(state.model, "patch", 1)
    state.model.load_state_dict(state_dict_from_jax(
        jax_state.params, jax_state.batch_stats, name, patch))
    state.step = int(jax_state.step)
    if jax_state.ema_params is not None:
        if not state.has_ema:
            state.attach_ema()
        state.ema_model.load_state_dict(state_dict_from_jax(
            jax_state.ema_params, jax_state.ema_batch_stats, name, patch))
        state.ema_step = int(jax_state.ema_step)
