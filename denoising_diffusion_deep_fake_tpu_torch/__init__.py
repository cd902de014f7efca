"""PyTorch / CUDA port of the denoising-diffusion deep-fake trainer.

A second package beside the JAX one (``denoising_diffusion_deep_fake_tpu``),
written for one NVIDIA H100. It mirrors the JAX package's module paths and
public layouts (NHWC images, ``(B,)`` per-sample parameters) and imports
nothing from it. The kernels the JAX package wrote in Pallas for the TPU
(the affine warp and the noise blend) are CUDA C++ kernels here
(``ops/cuda/``); everything else is plain PyTorch. Three workloads are
ported: the denoiser's train step (``training/denoiser.py``), the
difficulty balancer (``training/balance.py``) and the two-identity
deep-fake trainer in denoise and swap modes (``training/deep_fake.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``).
"""

from denoising_diffusion_deep_fake_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
