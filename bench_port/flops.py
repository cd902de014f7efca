"""Operation and byte counts of the work a cell does, from shapes.

* ``unet_forward_flops``: the FLOPs (2 per multiply-add) of one U-Net
  forward, counted by ``torch.utils.flop_counter`` over the benchmark's
  own reference model (``reference/unet.py``) on the meta device: the
  convolutions, whatever implements them. A training step counts 3
  forwards (forward, and the backward's two products of each layer), no
  recompute.
* ``warp_fused_bytes`` / ``noise_f32_bytes``: what the port's two training
  kernels must move at the least, each input read once and each output
  written once: the fused warp reads uint8 NHWC and writes fp32, the fp32
  noise blend reads and writes fp32 (its noise is drawn in registers).

The peaks are NVIDIA's for one H100 SXM at its 700 W limit, dense.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference import unet

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def unet_forward_flops(encoder_name: str, image_size: int) -> int:
    """FLOPs of one image's forward at ``image_size`` squared."""
    with torch.device("meta"):
        params = {n: torch.empty(s) for n, s, _ in unet.spec(encoder_name)}
        x = torch.empty((1, image_size, image_size, 3))
        with FlopCounterMode(display=False) as counter:
            unet.forward(params, x, encoder_name)
    return int(counter.get_total_flops())


def warp_fused_bytes(batch: int, size: int, channels: int = 3) -> int:
    return batch * size * size * channels * (1 + 4)


def noise_f32_bytes(batch: int, size: int, channels: int = 3) -> int:
    return batch * size * size * channels * (4 + 4)
