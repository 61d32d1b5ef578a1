"""Geometric primitives (port of `pointseg.ops`).

FPS, ball query, 3-NN, kNN, the row gathers (batched and flat) and
EdgeConv's gather-reduce (`edge_reduce`, float32 and bfloat16 rows)
launch hand-written CUDA kernels on CUDA tensors (`csrc/`, built by
`_kernels`) and run plain PyTorch on CPU tensors; the ball query and kNN
each have a flat and a two-level kernel, and the call's shape picks one.
Pooling is plain PyTorch on both. Importing this package registers the
kernels as PyTorch operators for `torch.export` (`library.py`).
"""

from pointseg_torch.ops.fps import farthest_point_sampling, sample  # noqa: F401
from pointseg_torch.ops.ballquery import (  # noqa: F401
    ball_query,
    ball_query_raw,
    group,
    pairwise_sqdist,
)
from pointseg_torch.ops.gather import (  # noqa: F401
    gather_rows,
    gather_rows_flat,
    gather_rows_with_coords,
)
from pointseg_torch.ops.edgereduce import edge_reduce, edge_reduce_plain  # noqa: F401
from pointseg_torch.ops.knn import (  # noqa: F401
    gather_neighbors,
    graph_feature,
    knn_indices,
)
from pointseg_torch.ops.interpolate import interpolate, three_nn  # noqa: F401
from pointseg_torch.ops.pooling import masked_reduce, reduce  # noqa: F401
from pointseg_torch.ops import library  # noqa: E402,F401  (registers the operators)
