"""The port's kernels as PyTorch operators, for `torch.export`.

`torch.export` traces a model on fake tensors, which have no memory: a
launch through `ctypes` on raw `data_ptr`s cannot run there, and a trace
of the plain versions would hold those instead of the kernels (and
unroll FPS's loop over the centroids). So each kernel that an eval-mode
forward reaches is registered here as one operator with
`torch.library.custom_op`, with a fake implementation that gives the
outputs' shapes and dtypes:

    pointseg_torch::fps, ball_query, ball_query_2l, three_nn, knn,
    knn_2l, gather_rows

(`gather_rows_flat`, which only the device-resident store calls, is not
one). Each operator's implementation is the op module's own function,
run when no trace runs: a CUDA tensor goes to `_kernels.launch` (and
counts in `LAUNCHES`), a CPU tensor to the plain version. The op
wrappers in `ops/*.py` call these operators only while
`torch.compiler.is_exporting()` is true; at any other time they dispatch
directly, so the training path never goes through PyTorch's dispatcher
(a call of a host-bound model costs its microseconds there,
`ops/_kernels.py`).

The wrappers pick `ball_query` or `ball_query_2l`, `knn` or `knn_2l`, by
the shape rule of `ops/ballquery.py` and `ops/knn.py`: the `_2l`
operator only past the flat kernel's limits. Each `_2l` operator runs
its two-level kernel at any shape on the card, so a test can hold that
kernel to the flat one where both take the shape, and a program exported
with it loads and runs.

Importing `pointseg_torch.ops` registers the operators; a process that
loads an exported artifact must do so before it runs it
(`pointseg_torch/io/export_aot.py`).
"""

from typing import Optional

import torch
from torch import Tensor

from pointseg_torch.ops.ballquery import _select
from pointseg_torch.ops.fps import farthest_point_sampling
from pointseg_torch.ops.gather import _gather
from pointseg_torch.ops.interpolate import three_nn as _three_nn
from pointseg_torch.ops.knn import _knn


@torch.library.custom_op("pointseg_torch::fps", mutates_args=())
def fps(coords: Tensor, start: Tensor, mask: Optional[Tensor], num_samples: int) -> Tensor:
    """(B, num_samples) int32 farthest-point indices from `start` (B,)."""
    return farthest_point_sampling(coords, num_samples, start_indices=start, mask=mask)


@fps.register_fake
def _(coords, start, mask, num_samples):
    return coords.new_empty((coords.shape[0], num_samples), dtype=torch.int32)


def _ball_query_fake(centroids, coords, mask, radius, K, repeat):
    shape = (*centroids.shape[:2], K)
    return (centroids.new_empty(shape, dtype=torch.int32),
            centroids.new_empty(shape, dtype=torch.bool))


@torch.library.custom_op("pointseg_torch::ball_query", mutates_args=())
def ball_query(centroids: Tensor, coords: Tensor, mask: Optional[Tensor], radius: float, K: int,
               repeat: bool) -> tuple[Tensor, Tensor]:
    """(idx, in_ball), each (B, C, K), by the shape rule on the card (the
    flat kernel, the two-level one past K = 32); the repeat filler
    applied when `repeat`."""
    return _select(centroids, coords, radius, K, mask, "flat", repeat)


@torch.library.custom_op("pointseg_torch::ball_query_2l", mutates_args=())
def ball_query_2l(centroids: Tensor, coords: Tensor, mask: Optional[Tensor], radius: float,
                  K: int, repeat: bool) -> tuple[Tensor, Tensor]:
    """`ball_query` by the two-level kernel on the card, at any K."""
    return _select(centroids, coords, radius, K, mask, "two_level", repeat)


ball_query.register_fake(_ball_query_fake)
ball_query_2l.register_fake(_ball_query_fake)


@torch.library.custom_op("pointseg_torch::three_nn", mutates_args=())
def three_nn(coords_tgt: Tensor, coords_src: Tensor, src_mask: Optional[Tensor],
             k: int) -> tuple[Tensor, Tensor]:
    """(d2 float32, idx int32), each (B, N, k)."""
    return _three_nn(coords_tgt, coords_src, k, src_mask=src_mask)


@three_nn.register_fake
def _(coords_tgt, coords_src, src_mask, k):
    shape = (*coords_tgt.shape[:2], k)
    return (coords_tgt.new_empty(shape, dtype=torch.float32),
            coords_tgt.new_empty(shape, dtype=torch.int32))


def _knn_fake(x, mask, k, include_self):
    return x.new_empty((*x.shape[:2], k), dtype=torch.int32)


@torch.library.custom_op("pointseg_torch::knn", mutates_args=())
def knn(x: Tensor, mask: Optional[Tensor], k: int, include_self: bool) -> Tensor:
    """(B, N, k) int32 neighbour indices by the shape rule on the card
    (the flat kernel, the two-level one past k = 32 or F = 512)."""
    return _knn(x, k, mask, include_self, "flat")


@torch.library.custom_op("pointseg_torch::knn_2l", mutates_args=())
def knn_2l(x: Tensor, mask: Optional[Tensor], k: int, include_self: bool) -> Tensor:
    """`knn` by the two-level kernel on the card, at any shape."""
    return _knn(x, k, mask, include_self, "two_level")


knn.register_fake(_knn_fake)
knn_2l.register_fake(_knn_fake)


@torch.library.custom_op("pointseg_torch::gather_rows", mutates_args=())
def gather_rows(table: Tensor, idx: Tensor, coords: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """(rows of `table` at `idx`, rows of `coords` at `idx`); the second
    is an empty tensor when `coords` is None."""
    if coords is None:
        return _gather(table, idx, None), table.new_empty((0,))
    return _gather(table, idx, coords)


@gather_rows.register_fake
def _(table, idx, coords):
    rows = table.new_empty((*idx.shape, table.shape[2]))
    if coords is None:
        return rows, table.new_empty((0,))
    return rows, coords.new_empty((*idx.shape, coords.shape[2]))
