"""Data, tensor and point parallelism (port of `pointseg.parallel`)."""

from pointseg_torch.parallel.mesh import (  # noqa: F401
    Axis,
    Mesh,
    ShardedLoader,
    active,
    all_gather,
    all_reduce_,
    all_reduce_sum,
    axis_all_reduce_,
    backend_for,
    barrier,
    broadcast_,
    close_mesh,
    create_hybrid_mesh,
    create_mesh,
    global_totals,
    hybrid_grid,
    reduce_gradients,
    refuse_indivisible,
    shard_batch,
    shard_state,
    under_torchrun,
    use,
)
from pointseg_torch.parallel.points import (  # noqa: F401
    forward_points,
    gather_points,
    shard_points,
    use_points,
)
from pointseg_torch.parallel.tensor_parallel import (  # noqa: F401
    full_state_dict,
    load_full_state_dict,
    shard_state_tp,
    sharded_param_fraction,
    tensor_parallel_sharding,
)
from pointseg_torch.parallel.launch import spawn  # noqa: F401
