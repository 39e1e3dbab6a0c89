from legion.ops.segment import (  # noqa: F401
    block_dst_degree,
    block_src_out_degree,
    fanout_gather_mean,
    fanout_gather_sum,
)
