"""Multi-process data parallelism on torch.distributed, and the
('data', 'model') layout of tensor parallelism and ZeRO-1 (sharding.py,
imported on its own: it reads the towers' parameter names)."""

from .distributed import (
    RowShard,
    all_gather,
    all_reduce_mean_,
    all_reduce_sum,
    allreduce_max_array,
    any_process_flag,
    barrier,
    gather_objects,
    host_shard_info,
    initialize_distributed,
    is_distributed,
    launch_env,
    model_all_reduce_sum_,
    process_count,
    process_index,
    shutdown_distributed,
)

__all__ = [
    "RowShard",
    "all_gather",
    "all_reduce_mean_",
    "all_reduce_sum",
    "allreduce_max_array",
    "any_process_flag",
    "barrier",
    "gather_objects",
    "host_shard_info",
    "initialize_distributed",
    "is_distributed",
    "launch_env",
    "model_all_reduce_sum_",
    "process_count",
    "process_index",
    "shutdown_distributed",
]
