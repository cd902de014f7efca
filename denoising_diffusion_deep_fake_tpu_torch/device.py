"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU. A
machine without a GPU raises instead of silently running the CPU path.
Inside a process group (``parallel/distributed.py``) the GPU is the
rank's own, ``cuda:{rank % device_count}``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when there is none); else as given. In
    a process group ``cuda`` without an index is the rank's card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if (device.type == "cuda" and device.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return torch.device("cuda", torch.distributed.get_rank()
                            % torch.cuda.device_count())
    return device
