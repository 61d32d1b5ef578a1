"""Data parallelism (port of `pointseg.parallel`'s data axis)."""

from pointseg_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedLoader,
    active,
    all_reduce_,
    all_reduce_sum,
    backend_for,
    barrier,
    broadcast_,
    close_mesh,
    create_mesh,
    global_totals,
    reduce_gradients,
    refuse_indivisible,
    shard_batch,
    shard_state,
    under_torchrun,
    use,
)
from pointseg_torch.parallel.launch import spawn  # noqa: F401
