"""Data and spatial parallelism over ``torch.distributed`` (ROADMAP A9,
A9b): the process group (``distributed``), the rank's rows of the batch
and of each image (``mesh``), the collectives the port issues
(``collectives``), the halo geometry of H-sharded convolutions
(``halo``) and the census (``audit``)."""

from denoising_diffusion_deep_fake_tpu_torch.parallel.distributed import (
    data_shard,
    fetch_local,
    initialize,
    is_primary,
    local_batch_size,
    maybe_initialize_from_env,
    process_count,
    process_index,
)
from denoising_diffusion_deep_fake_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    shard_batch,
    shard_rows,
    shard_state,
    training_mesh,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "training_mesh",
    "shard_batch",
    "shard_rows",
    "shard_state",
    "initialize",
    "maybe_initialize_from_env",
    "is_primary",
    "process_count",
    "process_index",
    "local_batch_size",
    "data_shard",
    "fetch_local",
]
