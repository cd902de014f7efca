"""Plain U-Net of segmentation_models_pytorch's topology, as functions.

smp's ``Unet(encoder_name, in_channels=3, classes=3, activation=None)``
with torchvision's resnet-family encoder and the (256, 128, 64, 32, 16)
decoder, written from the published architecture (torchvision's
``BasicBlock`` / ``Bottleneck``, smp's ``UnetDecoder``) with plain
``torch.nn.functional`` calls over a dict of tensors keyed by smp's
state_dict names. Nothing of the program is imported.

Numerics: everything in fp32 (the caller keeps TF32 off). Batch norm runs
in train mode, normalising with the batch's biased variance; the running
statistics are not read. ``quant`` (the control, ``reference/lowp.py``)
rounds each convolution's input and weight.

``spec(encoder_name)`` lists every tensor with its shape and init rule;
the benchmark makes its weights from it (``bench_port/inputs.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DECODER_CHANNELS = (256, 128, 64, 32, 16)
BN_EPS = 1e-5

# name: (kind, blocks per stage, groups, base width, expansion)
ENCODERS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64, 1),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64, 1),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64, 4),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4, 4),
}
WIDTHS = (64, 128, 256, 512)


def _blocks(encoder_name: str):
    """``(prefix, kind, inplanes, width, out, stride, groups, has_down)``
    for every block of the encoder."""
    kind, blocks, groups, base_width, expansion = ENCODERS[encoder_name]
    inplanes, out = 64, []
    for stage, (n, planes) in enumerate(zip(blocks, WIDTHS)):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            width = (planes if kind == "basic"
                     else int(planes * base_width / 64) * groups)
            o = planes * expansion
            out.append((f"encoder.layer{stage + 1}.{i}", kind, inplanes,
                        width, o, stride, groups,
                        stride != 1 or inplanes != o))
            inplanes = o
    return out


def encoder_channels(encoder_name: str) -> tuple:
    expansion = ENCODERS[encoder_name][4]
    return (3, 64) + tuple(w * expansion for w in WIDTHS)


def spec(encoder_name: str) -> list:
    """``[(name, shape, init)]``: ``init`` is ``conv_fan_out`` (He normal,
    fan out), ``conv_fan_in_uniform`` (He uniform, fan in),
    ``xavier_uniform``, ``bn_weight``, ``bn_bias``, ``zeros``,
    ``running_mean`` or ``running_var``."""
    out = []

    def conv(name, cin, cout, k, groups=1, init="conv_fan_out"):
        out.append((f"{name}.weight", (cout, cin // groups, k, k), init))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight"),
                    (f"{name}.bias", (c,), "bn_bias"),
                    (f"{name}.running_mean", (c,), "running_mean"),
                    (f"{name}.running_var", (c,), "running_var")])

    conv("encoder.conv1", 3, 64, 7)
    bn("encoder.bn1", 64)
    for prefix, kind, cin, width, o, stride, groups, down in _blocks(
            encoder_name):
        if kind == "basic":
            conv(f"{prefix}.conv1", cin, width, 3)
            bn(f"{prefix}.bn1", width)
            conv(f"{prefix}.conv2", width, width, 3)
            bn(f"{prefix}.bn2", width)
        else:
            conv(f"{prefix}.conv1", cin, width, 1)
            bn(f"{prefix}.bn1", width)
            conv(f"{prefix}.conv2", width, width, 3, groups)
            bn(f"{prefix}.bn2", width)
            conv(f"{prefix}.conv3", width, o, 1)
            bn(f"{prefix}.bn3", o)
        if down:
            conv(f"{prefix}.downsample.0", cin, o, 1)
            bn(f"{prefix}.downsample.1", o)
    for i, (cin, skip, cout) in enumerate(_decoder(encoder_name)):
        conv(f"decoder.blocks.{i}.conv1.0", cin + skip, cout, 3,
             init="conv_fan_in_uniform")
        bn(f"decoder.blocks.{i}.conv1.1", cout)
        conv(f"decoder.blocks.{i}.conv2.0", cout, cout, 3,
             init="conv_fan_in_uniform")
        bn(f"decoder.blocks.{i}.conv2.1", cout)
    conv("segmentation_head.0", DECODER_CHANNELS[-1], 3, 3,
         init="xavier_uniform")
    out.append(("segmentation_head.0.bias", (3,), "zeros"))
    return out


def _decoder(encoder_name: str):
    channels = encoder_channels(encoder_name)[1:][::-1]
    ins = (channels[0],) + DECODER_CHANNELS[:-1]
    skips = channels[1:] + (0,)
    return list(zip(ins, skips, DECODER_CHANNELS))


def trainable(name: str) -> bool:
    """Params get gradients; the BN running statistics are buffers."""
    return not name.endswith(("running_mean", "running_var"))


def _conv(p, name, x, stride=1, padding=0, groups=1, quant=None):
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias")
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, padding, 1, groups)


def forward(p: dict, x_nhwc: torch.Tensor, encoder_name: str, *,
            quant=None) -> torch.Tensor:
    """NHWC fp32 in, NHWC fp32 out, batch norm in train mode."""
    def bn(name, y):
        return F.batch_norm(y, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, BN_EPS)

    def conv(name, y, **kw):
        return _conv(p, name, y, quant=quant, **kw)

    x = x_nhwc.permute(0, 3, 1, 2)
    features = [x]
    y = F.relu(bn("encoder.bn1", conv("encoder.conv1", x, stride=2,
                                       padding=3)))
    features.append(y)
    y = F.max_pool2d(y, 3, 2, 1)
    stage_end = {}
    blocks = _blocks(encoder_name)
    for j, blk in enumerate(blocks):
        if j + 1 == len(blocks) or blocks[j + 1][0].split(".")[1] != \
                blk[0].split(".")[1]:
            stage_end[blk[0]] = True
    for prefix, kind, _, _, _, stride, groups, down in blocks:
        if kind == "basic":
            z = F.relu(bn(f"{prefix}.bn1", conv(f"{prefix}.conv1", y,
                                                 stride=stride, padding=1)))
            z = bn(f"{prefix}.bn2", conv(f"{prefix}.conv2", z, padding=1))
        else:
            z = F.relu(bn(f"{prefix}.bn1", conv(f"{prefix}.conv1", y)))
            z = F.relu(bn(f"{prefix}.bn2", conv(f"{prefix}.conv2", z,
                                                 stride=stride, padding=1,
                                                 groups=groups)))
            z = bn(f"{prefix}.bn3", conv(f"{prefix}.conv3", z))
        if down:
            y = bn(f"{prefix}.downsample.1",
                   conv(f"{prefix}.downsample.0", y, stride=stride))
        y = F.relu(z + y)
        if prefix in stage_end:
            features.append(y)
    head, skips = features[-1], features[1:-1][::-1]
    y = head
    for i in range(len(DECODER_CHANNELS)):
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if i < len(skips):
            y = torch.cat([y, skips[i]], dim=1)
        for c in ("conv1", "conv2"):
            y = F.relu(bn(f"decoder.blocks.{i}.{c}.1",
                          conv(f"decoder.blocks.{i}.{c}.0", y, padding=1)))
    y = conv("segmentation_head.0", y, padding=1)
    return y.permute(0, 2, 3, 1)
