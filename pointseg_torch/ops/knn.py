"""kNN graph construction and the edge-feature gather for DGCNN.

Port of `pointseg/ops/knn.py`. Every point takes its k nearest
neighbours under squared L2 distance in feature space, itself included,
as the k largest of the score

    s_ij = (2 <x_i, x_j> - |x_i|²) - |x_j|²      (the negated d²)

in (score descending, index ascending) order: equal scores, as between
repeated points, resolve to the lowest index.

On a CUDA tensor the selection is one launch of `csrc/knn.cu`: the flat
kernel (`select="flat"`, the default) or the two-level kernel
(`select="two_level"`, the counterpart of the JAX package's
`use_select2l` setting; here a function argument). Both give the same
indices, and both take `mask` and `include_self` themselves (the JAX
package sends those two to its oracle). The plain PyTorch version below
runs on a CPU tensor only.
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels
from pointseg_torch.ops.gather import gather_rows

SELECTS = ("flat", "two_level")
MAX_K = 32  # the flat kernel keeps one list slot per warp lane
MAX_F = 384  # the feature-major candidate tile must fit shared memory
PLAIN_BLOCK_BYTES = 64 << 20  # size of one (B, rows, N) score block


def default_depth(k: int) -> int:
    """Per-lane stack depth of the two-level kernel at which refills are
    rare (as `pointseg/ops/pallas/select2l.py::default_depth` from k = 4
    up; below, the deeper stack costs nothing here). The result never
    depends on it."""
    return 4 if k <= 20 else 5


def knn_indices(
    x: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
    include_self: bool = True,
    select: str = "flat",
) -> torch.Tensor:
    """k nearest neighbours of every point under squared L2 distance.

    Args:
        x: (B, N, F) point features, channels-last. A NaN score (a
            diverged activation) ranks last, like an excluded point, so
            every index returned lies in [0, N).
        k: neighbours per point, 1 <= k <= N (and <= 32 on a CUDA tensor).
        mask: optional (B, N) bool; False points are never neighbours
            while a row has k others to take; with fewer, the excluded
            points fill the tail of its list in index order. (The lists
            of the False points themselves are arbitrary: mask
            downstream.)
        include_self: keep the point itself in its neighbourhood (the
            reference's semantics).
        select: 'flat' or 'two_level', the CUDA kernel to launch.

    Returns:
        (B, N, k) int32 neighbour indices. Selection carries no gradient.
    """
    if select not in SELECTS:
        raise ValueError(f"select must be one of {SELECTS}, got {select!r}")
    B, N, _ = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"knn needs 1 <= k <= N, got k={k}, N={N}")
    x = x.detach().to(torch.float32).contiguous()
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
    """One launch of the flat or the two-level kernel; `depth` is the
    two-level kernel's stack depth (4 or 5; 1 forces its refills)."""
    B, N, F = x.shape
    if k > MAX_K:
        raise ValueError(f"the CUDA kNN kernels take k <= {MAX_K}, got {k}")
    if not 1 <= F <= MAX_F:
        raise ValueError(f"the CUDA kNN kernels take 1 <= F <= {MAX_F}, got {F}")
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
    if select == "flat":
        _kernels.launch("knn", "pointseg_knn", x.device, _kernels.ptr(x),
                        _kernels.ptr(norms), _kernels.ptr(mask), _kernels.ptr(out),
                        B, N, F, k, int(include_self))
    else:
        _kernels.launch("knn_2l", "pointseg_knn_2l", x.device, _kernels.ptr(x),
                        _kernels.ptr(norms), _kernels.ptr(mask), _kernels.ptr(out),
                        B, N, F, k, int(include_self), depth)
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
