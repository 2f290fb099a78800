"""Data parallelism over processes, one card each (parallel/dist.py)."""

from stedm_tpu_torch.parallel.dist import (
    barrier,
    is_main,
    local_batch_size,
    maybe_initialize_distributed,
    mesh_size,
    rank,
    world_size,
)

__all__ = ["barrier", "is_main", "local_batch_size", "maybe_initialize_distributed",
           "mesh_size", "rank", "world_size"]
