from .dist import (
    all_reduce_mean,
    all_reduce_sum,
    init_from_env,
    is_distributed,
    part_rows,
    process_count,
    process_index,
    shard_range,
    sum_over_ranks,
)

__all__ = ["all_reduce_mean", "all_reduce_sum", "init_from_env", "is_distributed", "part_rows",
           "process_count", "process_index", "shard_range", "sum_over_ranks"]
