"""Ball query and neighbourhood grouping.

Port of `pointseg/ops/ballquery.py`. Each ball takes its K nearest
points within the radius, in ascending (d², index) order. A ball with
fewer than K members is filled, by default, by repeating its nearest
member ('repeat', standard PointNet++ grouping); 'index' keeps the raw
fillers, the lowest-index points outside the ball in ascending index
order. The JAX package picks the filler through a module-wide setting;
here it is the `filler` argument.

On a CUDA tensor the selection is one launch of `csrc/ballquery.cu`,
with or without a mask, and the shape alone picks the kernel: the flat
kernel, which keeps one slot a warp lane, where K <= `MAX_K`; the
two-level kernel, which takes any K <= N, past it (the launch counters
show which ran). Both give the same indices slot for slot; measured at
every ball query of the models' paths, the flat one is the faster. The
two-level kernel stands for the JAX package's `use_select2l` route;
tests reach it at any K through `_select(..., "two_level")`. On a CPU
tensor the plain PyTorch version below runs. All return the same raw
(idx, in_ball); `ball_query` with the repeat filler has the kernel
write it (still one launch), or applies it with `torch.where` on the
CPU. While `torch.export` traces, the selection is the operator
`pointseg_torch::ball_query`, or `ball_query_2l` past `MAX_K`
(`ops/library.py`), which does the same at run time.
"""

from __future__ import annotations

import numpy as np
import torch

from pointseg_torch.ops import _kernels

FILLERS = ("repeat", "index")
MAX_K = 32  # the flat kernel keeps one slot per warp lane; the two-level one any K
# The two-level kernel's per-lane stack depth at every K: at five its two
# balls a warp spill registers at two blocks an SM (`csrc/ballquery.cu`),
# and four measured as fast. The result never depends on it; depth 1 (a
# refill after every pick) is built for tests.
TWO_LEVEL_DEPTH = 4


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, Gram form, clamped at 0.

    Args:
        a: (..., C, D)
        b: (..., N, D)
    Returns:
        (..., C, N) float32 `max((|a|² - 2 a·b) + |b|², 0)`.

    The dot products are summed term by term in coordinate order, each
    operation rounded on its own, rather than by a matrix product whose
    summation order (and TF32 use) is the library's: this rounds exactly
    as the CUDA kernels do, so selections agree bit for bit.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = a[..., :, None, :]  # (..., C, 1, D)
    bb = b[..., None, :, :]  # (..., 1, N, D)
    a2 = _sum_terms(a * a)[..., :, None]
    b2 = _sum_terms(b * b)[..., None, :]
    cross = _sum_terms_pairwise(aa, bb)
    return torch.clamp_min(a2 - 2.0 * cross + b2, 0.0)


def _sum_terms(t: torch.Tensor) -> torch.Tensor:
    out = t[..., 0]
    for d in range(1, t.shape[-1]):
        out = out + t[..., d]
    return out


def _sum_terms_pairwise(aa: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    out = aa[..., 0] * bb[..., 0]
    for d in range(1, aa.shape[-1]):
        out = out + aa[..., d] * bb[..., d]
    return out


def _radius_sq(radius: float) -> float:
    # f32(radius)² rounded to f32, as the JAX oracle forms it
    return float(np.float32(radius) * np.float32(radius))


def ball_query_raw(
    centroids: torch.Tensor,
    coords: torch.Tensor,
    radius: float,
    K: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selection without the filler step.

    Returns:
        idx: (B, C, K) int32. In-ball members first, ascending by
            (d², index); then, for sparse balls, the lowest-index points
            outside the ball (or excluded by `mask`) in index order.
        in_ball: (B, C, K) bool, True on the member slots.
    """
    return _select(centroids, coords, radius, K, mask, "flat", repeat=False)


def _two_level(select: str, K: int) -> bool:
    """The shape rule: the two-level kernel past the flat kernel's
    `MAX_K`, or where `select` is "two_level" (tests force it)."""
    return select == "two_level" or K > MAX_K


def _select(centroids, coords, radius, K, mask, select, repeat: bool):
    """The selection, with the repeat filler applied when `repeat`: by
    the kernel on a CUDA tensor (one launch), by `torch.where` over the
    plain version's raw result on a CPU one. `select` is "flat", the
    shape rule (`_two_level`), which every caller outside the tests and
    the `ball_query_2l` operator passes, or "two_level"."""
    N = coords.shape[1]
    if not 1 <= K <= N:
        raise ValueError(f"ball query needs 1 <= K <= N, got K={K}, N={N}")
    if torch.compiler.is_exporting():  # one operator in the traced graph (ops/library.py)
        op = (torch.ops.pointseg_torch.ball_query_2l if _two_level(select, K)
              else torch.ops.pointseg_torch.ball_query)
        return op(centroids, coords, mask, radius, K, repeat)
    if _kernels.on_cuda(coords):
        return _ball_query_cuda(centroids, coords, _radius_sq(radius), K, mask, select,
                                TWO_LEVEL_DEPTH, repeat)
    if mask is not None:
        mask = mask.to(device=coords.device, dtype=torch.bool)
    idx, in_ball = ball_query_plain(centroids.detach().to(torch.float32),
                                    coords.detach().to(torch.float32), radius, K, mask=mask)
    if repeat:
        # slot 0 is the nearest member whenever the ball has one
        idx = torch.where(in_ball, idx, idx[..., :1])
    return idx, in_ball


def ball_query_plain(
    centroids: torch.Tensor,
    coords: torch.Tensor,
    radius: float,
    K: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `ball_query_raw`, the plain version of both kernels:
    the JAX oracle's masked top-K.

    Points outside the ball become +inf and the K smallest are taken by
    a stable sort, so equal distances (and the +inf fillers) keep index
    order. `torch.topk` would not do: its order among ties is not
    specified.
    """
    d2 = pairwise_sqdist(centroids, coords)  # (B, C, N)
    inside = d2 <= _radius_sq(radius)
    if mask is not None:
        inside = inside & mask[:, None, :]
    masked = torch.where(inside, d2, float("inf"))
    values, idx = torch.sort(masked, dim=-1, stable=True)
    return idx[..., :K].to(torch.int32), values[..., :K] < float("inf")


def _ball_query_cuda(centroids, coords, r2, K, mask, select, depth, repeat=False,
                     config=(0, 0, 0)):
    """One launch of the flat or the two-level kernel, as `_two_level`
    picks from `select` and K, which writes the repeat filler itself when
    `repeat`. `depth` is the two-level kernel's stack
    depth (`TWO_LEVEL_DEPTH`; 1 forces its refills); `config` forces the kernel's
    (centroids a warp, warps a block, warps a centroid), (0, 0, 0) lets it
    choose. A call at the training shapes is host time beside a kernel of
    microseconds, so nothing is done twice: f32 contiguous inputs and a
    contiguous bool mask pass as they are, each is checked once, and the
    outputs come from `new_empty`."""
    if depth not in (1, TWO_LEVEL_DEPTH):
        raise ValueError(f"the two-level ball query is built for depth 1 and {TWO_LEVEL_DEPTH}, "
                         f"got {depth}")
    if centroids.dtype != torch.float32 or not centroids.is_contiguous():
        centroids = centroids.to(torch.float32).contiguous()
    if coords.dtype != torch.float32 or not coords.is_contiguous():
        coords = coords.to(torch.float32).contiguous()
    B, C = centroids.shape[:2]
    N = coords.shape[1]
    if (centroids.dim() != 3 or coords.dim() != 3 or centroids.shape[2] != 3
            or coords.shape[2] != 3 or coords.shape[0] != B
            or centroids.device != coords.device):
        raise ValueError(f"ball query needs (B, C, 3) centroids and (B, N, 3) coords on one "
                         f"device, got {tuple(centroids.shape)} on {centroids.device} and "
                         f"{tuple(coords.shape)} on {coords.device}")
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous() or mask.device != coords.device:
            mask = mask.to(device=coords.device, dtype=torch.bool).contiguous()
        if mask.shape != (B, N):
            raise ValueError(f"mask: need shape {(B, N)}, got {tuple(mask.shape)}")
    idx = coords.new_empty((B, C, K), dtype=torch.int32)
    in_ball = coords.new_empty((B, C, K), dtype=torch.bool)
    if B == 0 or C == 0:
        return idx, in_ball
    args = (centroids.data_ptr(), coords.data_ptr(), _kernels.ptr(mask), idx.data_ptr(),
            in_ball.data_ptr(), B, C, N, K, r2)
    if _two_level(select, K):
        _kernels.launch("ball_query_2l", "pointseg_ball_query_2l", coords.device, *args, depth,
                        repeat, *config)
    else:
        _kernels.launch("ball_query", "pointseg_ball_query", coords.device, *args, repeat,
                        *config)
    return idx, in_ball


def ball_query(
    centroids: torch.Tensor,
    coords: torch.Tensor,
    radius: float,
    K: int,
    *,
    mask: torch.Tensor | None = None,
    filler: str = "repeat",
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each centroid, selects the K nearest points within `radius`.

    Args:
        centroids: (B, C, 3) query centres.
        coords: (B, N, 3) all points.
        radius: ball radius r; a point is in the ball when d² <= r².
        K: neighbours per ball. K > N (a ball wider than its level, as
            PointNeXt-XL's last stage at N = 4096) selects all N points
            and fills slots N..K-1 with slot 0, under either filler.
        mask: optional (B, N) bool; False points are never members.
        filler: 'repeat' or 'index' (module docstring).

    Returns:
        idx: (B, C, K) int32 indices into N.
        in_ball: (B, C, K) bool, True where the slot is a member.
    """
    if filler not in FILLERS:
        raise ValueError(f"filler must be one of {FILLERS}, got {filler!r}")
    N = coords.shape[1]
    if K <= N or N == 0:
        return _select(centroids, coords, radius, K, mask, "flat", repeat=filler == "repeat")
    idx, in_ball = _select(centroids, coords, radius, N, mask, "flat", repeat=filler == "repeat")
    pad = (*idx.shape[:-1], K - N)
    return (torch.cat([idx, idx[..., :1].expand(pad)], dim=-1),
            torch.cat([in_ball, in_ball.new_zeros(pad)], dim=-1))


def group(
    centroids: torch.Tensor,
    coords: torch.Tensor,
    features: torch.Tensor,
    radius: float,
    K: int,
    normalize: bool = False,
    *,
    mask: torch.Tensor | None = None,
    filler: str = "repeat",
) -> torch.Tensor:
    """Gathers each ball's coordinates (relative to the centroid, divided
    by the radius if `normalize`) and features.

    Returns:
        (B, C, K, 3 + D) grouped regions, channels-last.
    """
    from pointseg_torch.ops.gather import gather_rows

    idx, _ = ball_query(centroids, coords, radius, K, mask=mask, filler=filler)
    grouped_coords = gather_rows(coords, idx) - centroids[:, :, None, :]
    if normalize:
        grouped_coords = grouped_coords / radius
    return torch.cat([grouped_coords, gather_rows(features, idx)], dim=-1)
