"""Data parallelism of the port over ``torch.distributed`` (one process per
device): the counterpart of ``glass_tpu/parallel``."""

from .mesh import (
    agree_batch_shape,
    all_reduce_mean,
    init_from_env,
    launch,
    make_parallel_train_step,
    rank,
    shard_batch,
    world_size,
)

__all__ = [
    "agree_batch_shape", "all_reduce_mean", "init_from_env", "launch", "make_parallel_train_step",
    "rank", "shard_batch", "world_size",
]
