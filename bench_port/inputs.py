"""The benchmark's inputs, made from ``--seed`` on the run's device.

Both sides get the same: the program through its own entry points (a
state_dict, frames handed to its loader's ``decode_fn``), the reference
as tensors. The weights are drawn in two large calls (one normal, one
uniform) and cut into tensors, each scaled by its init rule (torchvision's
He-normal fan-out for the encoder, smp's He-uniform fan-in for the
decoder, Xavier-uniform for the head, BN ones and zeros). The frames are
smooth images (a 16x-upsampled random field plus fine noise), so that
SSIM and the warp see structure and the loss is not that of white noise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_port.reference import unet

_WEIGHT_STREAM = 0x5EED_0001
_FRAME_STREAM = 0x5EED_0002


def _generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))
    return gen


def make_weights(encoder_name: str, seed: int, device) -> dict:
    """``name -> fp32 tensor`` for every tensor of ``unet.spec``."""
    spec = unet.spec(encoder_name)
    normal = [(n, s, i) for n, s, i in spec if i == "conv_fan_out"]
    uniform = [(n, s, i) for n, s, i in spec
               if i in ("conv_fan_in_uniform", "xavier_uniform")]
    gen = _generator(seed, _WEIGHT_STREAM, device)
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen,
                    device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen,
                   device=device) * 2.0 - 1.0
    out, zi, ui = {}, 0, 0
    for name, shape, init in spec:
        numel = math.prod(shape)
        if init == "conv_fan_out":
            fan_out = shape[0] * shape[2] * shape[3]
            out[name] = z[zi:zi + numel].view(shape) * math.sqrt(2.0 / fan_out)
            zi += numel
        elif init in ("conv_fan_in_uniform", "xavier_uniform"):
            fan_in = shape[1] * shape[2] * shape[3]
            fan_out = shape[0] * shape[2] * shape[3]
            bound = (math.sqrt(6.0 / fan_in) if init == "conv_fan_in_uniform"
                     else math.sqrt(6.0 / (fan_in + fan_out)))
            out[name] = u[ui:ui + numel].view(shape) * bound
            ui += numel
        elif init in ("bn_weight", "running_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return {k: v.contiguous() for k, v in out.items()}


def make_frames(seed: int, n: int, size: int, device, *,
                chunk: int = 128) -> torch.Tensor:
    """``(n, size, size, 3)`` uint8 RGB frames, in chunks on ``device``."""
    gen = _generator(seed, _FRAME_STREAM, device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    coarse = max(size // 16, 2)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        field = torch.rand((m, 3, coarse, coarse), generator=gen,
                           device=device)
        img = F.interpolate(field, size=(size, size), mode="bicubic",
                            align_corners=False)
        img = img + 0.08 * torch.randn(img.shape, generator=gen,
                                       device=device)
        out[i:i + m] = (img.clamp(0.0, 1.0) * 255.0).round().to(
            torch.uint8).permute(0, 2, 3, 1)
    return out
