"""Ball query and neighbourhood grouping.

Port of `pointseg/ops/ballquery.py`. Each ball takes its K nearest
points within the radius, in ascending (d², index) order. A ball with
fewer than K members is filled, by default, by repeating its nearest
member ('repeat', standard PointNet++ grouping); 'index' keeps the raw
fillers, the lowest-index points outside the ball in ascending index
order. The JAX package picks the filler through a module-wide setting;
here it is the `filler` argument.

On a CUDA tensor the selection is one launch of `csrc/ballquery.cu`: the
flat kernel (`select="flat"`, the default) or the two-level kernel
(`select="two_level"`, the counterpart of the JAX package's
`use_select2l` setting; here a function argument), at every shape and
with or without a mask. On a CPU tensor the plain PyTorch version below
runs for both. All return the same raw (idx, in_ball); `ball_query` then
applies the filler.
"""

from __future__ import annotations

import numpy as np
import torch

from pointseg_torch.ops import _kernels
from pointseg_torch.ops.knn import SELECTS, default_depth

FILLERS = ("repeat", "index")
MAX_K = 32  # the kernels keep one output slot per warp lane


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
    select: str = "flat",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The selection without the filler step.

    Returns:
        idx: (B, C, K) int32. In-ball members first, ascending by
            (d², index); then, for sparse balls, the lowest-index points
            outside the ball (or excluded by `mask`) in index order.
        in_ball: (B, C, K) bool, True on the member slots.
    """
    if select not in SELECTS:
        raise ValueError(f"select must be one of {SELECTS}, got {select!r}")
    N = coords.shape[1]
    if not 1 <= K <= N:
        raise ValueError(f"ball query needs 1 <= K <= N, got K={K}, N={N}")
    centroids = centroids.detach().to(torch.float32).contiguous()
    coords = coords.detach().to(torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(device=coords.device, dtype=torch.bool).contiguous()
    if _kernels.on_cuda(coords):
        return _ball_query_cuda(centroids, coords, _radius_sq(radius), K, mask, select,
                                default_depth(K))
    return ball_query_plain(centroids, coords, radius, K, mask=mask)


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


def _ball_query_cuda(centroids, coords, r2, K, mask, select, depth):
    """One launch of the flat or the two-level kernel; `depth` is the
    two-level kernel's stack depth (4 or 5; 1 forces its refills)."""
    B, C, _ = centroids.shape
    N = coords.shape[1]
    if K > MAX_K:
        raise ValueError(f"the CUDA ball query takes K <= {MAX_K}, got {K}")
    if depth not in (1, 4, 5):
        raise ValueError(f"the two-level ball query is built for depth 1, 4 and 5, got {depth}")
    _kernels.check(centroids, "centroids", torch.float32, (B, C, 3))
    _kernels.check(coords, "coords", torch.float32, (B, N, 3))
    if mask is not None:
        _kernels.check(mask, "mask", torch.bool, (B, N))
    if centroids.device != coords.device:
        raise ValueError("centroids and coords must be on the same device")
    idx = torch.empty((B, C, K), dtype=torch.int32, device=coords.device)
    in_ball = torch.empty((B, C, K), dtype=torch.bool, device=coords.device)
    if B == 0 or C == 0:
        return idx, in_ball
    args = (_kernels.ptr(centroids), _kernels.ptr(coords), _kernels.ptr(mask),
            _kernels.ptr(idx), _kernels.ptr(in_ball), B, C, N, K, r2)
    if select == "flat":
        _kernels.launch("ball_query", "pointseg_ball_query", coords.device, *args)
    else:
        _kernels.launch("ball_query_2l", "pointseg_ball_query_2l", coords.device, *args, depth)
    return idx, in_ball


def ball_query(
    centroids: torch.Tensor,
    coords: torch.Tensor,
    radius: float,
    K: int,
    *,
    mask: torch.Tensor | None = None,
    filler: str = "repeat",
    select: str = "flat",
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each centroid, selects the K nearest points within `radius`.

    Args:
        centroids: (B, C, 3) query centres.
        coords: (B, N, 3) all points.
        radius: ball radius r; a point is in the ball when d² <= r².
        K: neighbours per ball.
        mask: optional (B, N) bool; False points are never members.
        filler: 'repeat' or 'index' (module docstring).
        select: 'flat' or 'two_level', the CUDA kernel to launch.

    Returns:
        idx: (B, C, K) int32 indices into N.
        in_ball: (B, C, K) bool, True where the slot is a member.
    """
    if filler not in FILLERS:
        raise ValueError(f"filler must be one of {FILLERS}, got {filler!r}")
    idx, in_ball = ball_query_raw(centroids, coords, radius, K, mask=mask, select=select)
    if filler == "repeat":
        # slot 0 is the nearest member whenever the ball has one
        idx = torch.where(in_ball, idx, idx[..., :1])
    return idx, in_ball


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
    select: str = "flat",
) -> torch.Tensor:
    """Gathers each ball's coordinates (relative to the centroid, divided
    by the radius if `normalize`) and features.

    Returns:
        (B, C, K, 3 + D) grouped regions, channels-last.
    """
    from pointseg_torch.ops.gather import gather_rows

    idx, _ = ball_query(centroids, coords, radius, K, mask=mask, filler=filler, select=select)
    grouped_coords = gather_rows(coords, idx) - centroids[:, :, None, :]
    if normalize:
        grouped_coords = grouped_coords / radius
    return torch.cat([grouped_coords, gather_rows(features, idx)], dim=-1)
