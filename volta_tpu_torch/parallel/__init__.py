"""Data parallelism: one process a GPU over ``torch.distributed``
(``mesh``), and the step's context that the call sites read (``tp``)."""

from .mesh import (active, all_gather_rows, all_reduce_grads,
                   broadcast_state, init_distributed, is_rank0, min_across,
                   per_rank_batch, rank, shard_args, step_context,
                   sum_across, world_size)
from .tp import current_group, data_parallel, split_world

__all__ = [
    "active", "all_gather_rows", "all_reduce_grads", "broadcast_state",
    "init_distributed", "is_rank0", "min_across", "per_rank_batch", "rank",
    "shard_args", "step_context", "sum_across", "world_size",
    "current_group", "data_parallel", "split_world",
]
