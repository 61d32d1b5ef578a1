"""Geometric primitives (port of `pointseg.ops`).

FPS, ball query and 3-NN launch hand-written CUDA kernels on CUDA
tensors (`csrc/`, built by `_kernels`) and run plain PyTorch on CPU
tensors. Gathers and pooling are plain PyTorch on both.
"""

from pointseg_torch.ops.fps import farthest_point_sampling, sample  # noqa: F401
from pointseg_torch.ops.ballquery import (  # noqa: F401
    ball_query,
    ball_query_raw,
    group,
    pairwise_sqdist,
)
from pointseg_torch.ops.gather import gather_rows, gather_rows_with_coords  # noqa: F401
from pointseg_torch.ops.interpolate import interpolate, three_nn  # noqa: F401
from pointseg_torch.ops.pooling import masked_reduce, reduce  # noqa: F401
