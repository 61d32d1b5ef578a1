"""kNN graph construction and the edge-feature gather for DGCNN.

Port of `pointseg/ops/knn.py`. Every point takes its k nearest
neighbours under squared L2 distance in feature space, itself included,
as the k largest of the score

    s_ij = (2 <x_i, x_j> - |x_i|²) - |x_j|²      (the negated d²)

in (score descending, index ascending) order: equal scores, as between
repeated points, resolve to the lowest index.

On a CUDA tensor the selection is one launch of `csrc/knn.cu`, and the
shape alone picks the kernel. The flat kernel (eight query rows a warp
in a register tile, 16-byte loads when F is a multiple of 4) keeps one
list slot a warp lane and stages a block's query rows whole, so it takes
k <= `MAX_K` and F <= `MAX_F`; the two-level kernel, which takes any
k <= N and any F, runs past either limit (the enhanced DGCNN trainer's
k = 40). Both give the same indices slot for slot; measured at every kNN
shape of the DGCNN cells, the flat one is the faster. The two-level
kernel stands for the JAX package's `use_select2l` route; tests reach it
at any shape through `_knn(..., "two_level")` or `_knn_cuda`. Both
kernels take `mask` and `include_self` themselves (the JAX package sends
those two to its oracle). The launch counters show which kernel ran. The
plain PyTorch version below runs on a CPU tensor only. While
`torch.export` traces, the selection is the operator
`pointseg_torch::knn`, or `knn_2l` past the flat kernel's limits
(`ops/library.py`), which does the same at run time.
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels
from pointseg_torch.ops.gather import gather_rows

MAX_K = 32  # the flat kernel keeps one list slot per warp lane
# The flat kernel holds a block's 64 query rows whole in shared memory
# (227 KB a block on an H100), beside two 128-candidate tiles of 64
# features: F <= 631 fits, and MAX_F keeps room to spare. The two-level
# kernel stages the query rows 64 features at a time and takes any F.
MAX_F = 512
PLAIN_BLOCK_BYTES = 64 << 20  # size of one (B, rows, N) score block


def default_depth(k: int) -> int:
    """Per-lane stack depth of the two-level kNN kernel at which refills
    are rare (as `pointseg/ops/pallas/select2l.py::default_depth` from k =
    4 up; below, the deeper stack costs nothing here). The result never
    depends on it; depth 1 (a refill after every pick) is built for tests."""
    return 4 if k <= 20 else 5


def knn_indices(
    x: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    include_self: bool = True,
) -> torch.Tensor:
    """k nearest neighbours of every point under squared L2 distance.

    Args:
        x: (B, N, F) point features, channels-last. A NaN score (a
            diverged activation) ranks last, like an excluded point, so
            every index returned lies in [0, N).
        k: neighbours per point, 1 <= k <= N.
        mask: optional (B, N) bool; False points are never neighbours
            while a row has k others to take; with fewer, the excluded
            points fill the tail of its list in index order. (The lists
            of the False points themselves are arbitrary: mask
            downstream.)
        include_self: keep the point itself in its neighbourhood (the
            reference's semantics).

    Returns:
        (B, N, k) int32 neighbour indices. Selection carries no gradient.
    """
    return _knn(x, k, mask, include_self, "flat")


def _two_level(select: str, k: int, F: int) -> bool:
    """The shape rule: the two-level kernel past the flat kernel's `MAX_K`
    or `MAX_F`, or where `select` is "two_level" (tests force it)."""
    return select == "two_level" or k > MAX_K or F > MAX_F


def _knn(x, k, mask, include_self, select):
    """`knn_indices` with `select`: "flat", the shape rule (`_two_level`),
    which every caller outside the tests and the `knn_2l` operator
    passes, or "two_level"."""
    B, N, F = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"knn needs 1 <= k <= N, got k={k}, N={N}")
    x = x.detach().to(torch.float32).contiguous()
    if torch.compiler.is_exporting():  # one operator in the traced graph (ops/library.py)
        op = (torch.ops.pointseg_torch.knn_2l if _two_level(select, k, F)
              else torch.ops.pointseg_torch.knn)
        return op(x, mask, k, include_self)
    if _kernels.on_cuda(x):
        return _knn_cuda(x, k, select, default_depth(k), mask=mask, include_self=include_self)
    return knn_indices_plain(x, k, mask=mask, include_self=include_self)


def _scores(q: torch.Tensor, q2: torch.Tensor, x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(B, R, N) scores of query rows q (B, R, F) against x (B, N, F).

    The dot product is summed term by term in feature order, each
    operation rounded on its own, and the score is formed as
    (2·dot - |q|²) - |x|²: the CUDA kernels' arithmetic, so both select
    the same indices. A matrix product would sum in the library's order.
    """
    qq = q.transpose(1, 2)[..., None]  # (B, F, R, 1)
    xx = x.transpose(1, 2)[:, :, None, :]  # (B, F, 1, N)
    dot = qq[:, 0] * xx[:, 0]
    for f in range(1, x.shape[-1]):
        dot = dot + qq[:, f] * xx[:, f]
    return 2.0 * dot - q2[:, :, None] - x2[:, None, :]


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    sq = x * x
    out = sq[..., 0]
    for f in range(1, x.shape[-1]):
        out = out + sq[..., f]
    return out


def knn_indices_plain(
    x: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    include_self: bool = True,
) -> torch.Tensor:
    """Plain PyTorch `knn_indices`, the plain version of both kernels.

    Scores as `_scores` forms them, then the k largest by a stable sort
    of the negated scores, so equal scores keep index order
    (`torch.topk` does not promise an order among ties). The query rows
    go in blocks, so that no (B, N, N) tensor exists.
    """
    x = x.detach().to(torch.float32)
    B, N, _ = x.shape
    x2 = _sqnorm(x)
    if mask is not None:
        mask = mask.to(device=x.device, dtype=torch.bool)
    rows = max(1, min(N, PLAIN_BLOCK_BYTES // (4 * B * N)))
    out = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        neg = -_scores(x[:, r0:r1], x2[:, r0:r1], x, x2)  # ascending = nearest first
        if not include_self:
            own = torch.arange(r0, r1, device=x.device)
            neg[:, own - r0, own] = float("inf")
        if mask is not None:
            neg = torch.where(mask[:, None, :], neg, float("inf"))
        out[:, r0:r1] = torch.sort(neg, dim=-1, stable=True)[1][..., :k]
    return out


def _knn_cuda(x: torch.Tensor, k: int, select: str, depth: int, *,
              mask: torch.Tensor | None = None, include_self: bool = True) -> torch.Tensor:
    """One launch of the flat or the two-level kernel, as `_two_level`
    picks from `select`, k and F. `depth` is the two-level kernel's stack
    depth (4 or 5; 1 forces its refills)."""
    B, N, F = x.shape
    if F < 1:
        raise ValueError(f"the kNN kernels need F >= 1 features, got {F}")
    if depth not in (1, 4, 5):
        raise ValueError(f"the two-level kNN kernel is built for depth 1, 4 and 5, got {depth}")
    _kernels.check(x, "x", torch.float32, (B, N, F))
    if mask is not None:
        mask = mask.to(device=x.device, dtype=torch.bool).contiguous()  # one byte each
        _kernels.check(mask, "mask", torch.bool, (B, N))
    out = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    norms = torch.empty((B, N), dtype=torch.float32, device=x.device)  # the kernels' scratch
    if _two_level(select, k, F):
        _kernels.launch("knn_2l", "pointseg_knn_2l", x.device, _kernels.ptr(x),
                        _kernels.ptr(norms), _kernels.ptr(mask), _kernels.ptr(out),
                        B, N, F, k, int(include_self), depth)
    else:
        _kernels.launch("knn", "pointseg_knn", x.device, _kernels.ptr(x),
                        _kernels.ptr(norms), _kernels.ptr(mask), _kernels.ptr(out),
                        B, N, F, k, int(include_self))
    return out


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathers per-point neighbour features: x (B, N, F), idx (B, N, k)
    -> (B, N, k, F)."""
    return gather_rows(x, idx)


def graph_feature(
    x: torch.Tensor,
    k: int,
    *,
    idx: torch.Tensor | None = None,
    knn_on: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Edge features cat(x_j - x_i, x_i) for dynamic-graph convolution,
    (B, N, k, 2F). `knn_on` is the array to build the graph from when it
    differs from `x`; `idx` reuses a graph."""
    if idx is None:
        idx = knn_indices(x if knn_on is None else knn_on, k, mask=mask)
    neighbors = gather_neighbors(x, idx)
    center = x[:, :, None, :]
    return torch.cat([neighbors - center, center.expand_as(neighbors)], dim=-1)
