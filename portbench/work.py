"""The yardstick's work counts: the H100's peaks, the model's matmul FLOPs
a step, and each op's operations and bytes, all from shapes alone.

Peaks (NVIDIA's data sheet, H100 SXM, 700 W): 67 TFLOP/s float32 outside
the tensor cores (the configurations run float32 with TF32 off) and
3.35 TB/s of HBM3.

`step_matmul_flops` counts the Linear layers of a model's forward and
backward pass from its published widths, in the form the operations
require: a grouped first layer (PointNet++'s, over cat(xyz_j - xyz_c,
f_j)) and an EdgeConv's Linear over cat(x_j - x_i, x_i) distribute over
the concatenation, so their feature products are counted once a point,
and only the relative-coordinate product once a (centroid, neighbour)
pair. The backward pass counts twice the forward (input and weight
gradients). Distance computations inside the selections are the ops'
work (below), not the model's.

`op_work` counts one forward call of a `pointseg_torch.ops` function by
the rule of the port's kernel table: every input byte read once, every
output byte written once, and the arithmetic the selection needs (the
FPS rounds, the ball-query and 3-NN distances, the kNN Gram products).
The counts do not depend on how the op is implemented.
"""

from __future__ import annotations

import math

from portbench.reference.models import PNPP_FP, PNPP_K, PNPP_SA

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _mlp(rows: int, fin: int, widths) -> float:
    total = 0.0
    for w in widths:
        total += 2.0 * rows * fin * w
        fin = w
    return total


def pointnet2_ssg_forward_flops(B: int, N: int, in_features: int = 6,
                                num_classes: int = 14) -> float:
    flops, n_in, width = 0.0, N, in_features
    for C, _, widths in PNPP_SA:
        first = widths[0]
        flops += 2.0 * B * n_in * width * first  # features, once a point
        flops += 2.0 * B * C * PNPP_K * 3 * first  # relative xyz, once a pair
        flops += _mlp(B * C * PNPP_K, first, widths[1:])
        n_in, width = C, widths[-1]
    # FP4..FP1 upsample onto the third, second and first level's centroids, then the points
    targets = [C for C, _, _ in PNPP_SA[-2::-1]] + [N]
    for n_out, (fin, widths) in zip(targets, PNPP_FP):
        flops += _mlp(B * n_out, fin, widths)
    return flops + 2.0 * B * N * 128 * num_classes


def dgcnn_forward_flops(B: int, N: int, emb_dims: int = 1024, num_classes: int = 14) -> float:
    rows = B * N
    flops = 0.0
    for fin, fout in ((3, 64), (64, 64), (64, 64), (64, 128)):
        flops += 2.0 * rows * fin * fout * 2  # W_e x_j and W_c x_i, once a point each
    flops += 2.0 * rows * 3 * 64  # colour branch
    flops += 2.0 * rows * (384 * emb_dims + (384 + emb_dims) * 512 + 512 * 256
                           + 256 * num_classes)
    return flops


FORWARD_FLOPS = {"pointnet2_ssg": pointnet2_ssg_forward_flops, "dgcnn": dgcnn_forward_flops}


def step_matmul_flops(arch: str, batch: int, points: int) -> float:
    """Forward + backward matmul FLOPs of one train step on (batch, points)."""
    return 3.0 * FORWARD_FLOPS[arch](batch, points)


def _nbytes(shape, itemsize: int) -> int:
    return math.prod(shape) * itemsize


def op_work(name: str, args: list) -> tuple[float, float]:
    """(operations, bytes) of one forward call of op `name`, from `args`:
    [(shape, itemsize), ...] of its tensor arguments in call order and its
    integer arguments as ints (see `portbench/loops/train.py`'s op list)."""
    if name == "farthest_point_sampling":  # coords (B, N, 3), C
        (shape, size), C = args[0], args[1]
        B, N, _ = shape
        return 9.0 * B * C * N, _nbytes(shape, size) + 4 * B + 4 * B * C
    if name == "ball_query":  # centroids (B, C, 3), coords (B, N, 3), K
        (cs, csz), (ps, psz), K = args[0], args[1], args[2]
        B, C, _ = cs
        N = ps[1]
        return 10.0 * B * C * N, _nbytes(cs, csz) + _nbytes(ps, psz) + 5 * B * C * K
    if name == "interpolate":  # features (B, M, D), tgt (B, N, 3), src (B, M, 3)
        (fs, fsz), (ts, tsz), (ss, ssz) = args[0], args[1], args[2]
        B, M, D = fs
        N = ts[1]
        ops = 10.0 * B * N * M + 6.0 * B * N * D
        return ops, (_nbytes(fs, fsz) + _nbytes(ts, tsz) + _nbytes(ss, ssz)
                     + B * N * D * fsz)
    if name == "knn_indices":  # x (B, N, F), k
        (xs, xsz), k = args[0], args[1]
        B, N, F = xs
        return 2.0 * B * N * N * F, _nbytes(xs, xsz) + 4 * B * N * k
    if name in ("gather_rows", "gather_neighbors"):  # table (B, N, D), idx (B, ...)
        (ts, tsz), (ix, isz) = args[0], args[1]
        out = math.prod(ix) * ts[-1] * tsz
        return 0.0, _nbytes(ts, tsz) + _nbytes(ix, isz) + out
    if name == "gather_rows_with_coords":  # table (B, N, D), coords (B, N, 3), idx
        (ts, tsz), (cs, csz), (ix, isz) = args[0], args[1], args[2]
        rows = math.prod(ix)
        return 0.0, (_nbytes(ts, tsz) + _nbytes(cs, csz) + _nbytes(ix, isz)
                     + rows * ts[-1] * tsz + rows * 3 * csz)
    raise KeyError(f"no work count for op {name!r}")


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
