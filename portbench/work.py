"""The yardstick's work counts: the H100's peaks, the model's matmul FLOPs
a step, and each op's operations and bytes, all from shapes alone.

Peaks (NVIDIA's data sheet, H100 SXM, 700 W): 67 TFLOP/s float32 outside
the tensor cores (the configurations run float32 with TF32 off) and
3.35 TB/s of HBM3.

`step_matmul_flops` counts the Linear layers of a model's forward and
backward pass from its published widths, by the architecture's
`forward_flops` (`portbench/reference/archs/<arch>.py`), in the form the
operations require: a grouped first layer (PointNet++'s, over
cat(xyz_j - xyz_c, f_j)) and an EdgeConv's Linear over cat(x_j - x_i,
x_i) distribute over the concatenation, so their feature products are
counted once a point, and only the relative-coordinate product once a
(centroid, neighbour) pair. The backward pass counts twice the forward
(input and weight gradients). Distance computations inside the
selections are the ops' work (below), not the model's.

Each traced op's module in `portbench/opwork/` counts one call of a
`pointseg_torch.ops` function by the rule of the port's kernel table: every input byte read once, every output byte written once, and
the arithmetic the selection needs (the FPS rounds, the ball-query and
3-NN distances, the kNN Gram products). The counts do not depend on how
the op is implemented.
"""

from __future__ import annotations

import math

from portbench import harness

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def mlp_flops(rows: int, fin: int, widths) -> float:
    """FLOPs of a stack of Linears of `widths` over `rows` rows of `fin`."""
    total = 0.0
    for w in widths:
        total += 2.0 * rows * fin * w
        fin = w
    return total


def step_matmul_flops(arch: str, batch: int, points: int, **arch_kwargs) -> float:
    """Forward + backward matmul FLOPs of one train step on (batch, points)
    of `arch` built with the configuration's `arch_kwargs`."""
    return 3.0 * harness.arch_module(arch).forward_flops(batch, points, **arch_kwargs)


def nbytes(shape, itemsize: int) -> int:
    return math.prod(shape) * itemsize


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
