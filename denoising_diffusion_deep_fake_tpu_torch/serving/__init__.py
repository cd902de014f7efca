"""Long-running face-swap inference serving (engine + HTTP server).

Port of ``denoising_diffusion_deep_fake_tpu/serving/``: a persistent
process that loads the swap pipeline once and serves requests at device
batch rates (the reference has no serving layer).
"""

from denoising_diffusion_deep_fake_tpu_torch.serving.engine import (  # noqa: F401
    EngineOverloadedError,
    EngineStats,
    RequestExpiredError,
    SwapEngine,
)
