"""Multi-process data parallelism on torch.distributed."""

from .distributed import (
    RowShard,
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
    shutdown_distributed,
)

__all__ = [
    "RowShard",
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
    "shutdown_distributed",
]
