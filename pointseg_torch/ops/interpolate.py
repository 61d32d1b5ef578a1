"""3-NN inverse-distance-weighted feature interpolation (upsampling).

Port of `pointseg/ops/interpolate.py`. On a CUDA tensor the 3-NN
selection is one launch of `csrc/threenn.cu`; on a CPU tensor the plain
PyTorch version below runs. The weights 1/(d² + eps), normalised over
the neighbours, and the weighted sum are plain differentiable PyTorch.
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels
from pointseg_torch.ops.ballquery import pairwise_sqdist
from pointseg_torch.ops.gather import gather_rows


def three_nn(
    coords_tgt: torch.Tensor,
    coords_src: torch.Tensor,
    k: int = 3,
    *,
    src_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Finds the k nearest source points for every target point.

    Args:
        coords_tgt: (B, N, 3) points to interpolate to.
        coords_src: (B, M, 3) points that carry features.
        k: number of neighbours (the CUDA kernel takes k = 3).
        src_mask: optional (B, M) bool; False sources count as +inf.

    Returns:
        d2: (B, N, k) float32 squared distances, ascending.
        idx: (B, N, k) int32 indices into M; ties go to the lowest index.
    """
    M = coords_src.shape[1]
    if not 1 <= k <= M:
        raise ValueError(f"three_nn needs 1 <= k <= M, got k={k}, M={M}")
    coords_tgt = coords_tgt.detach().to(torch.float32).contiguous()
    coords_src = coords_src.detach().to(torch.float32).contiguous()
    if src_mask is not None:
        src_mask = src_mask.to(device=coords_src.device, dtype=torch.bool).contiguous()
    if _kernels.on_cuda(coords_src):
        if k != 3:
            raise ValueError(f"the CUDA three_nn kernel takes k = 3, got {k}")
        return _three_nn_cuda(coords_tgt, coords_src, src_mask)
    return three_nn_plain(coords_tgt, coords_src, k, src_mask=src_mask)


def three_nn_plain(
    coords_tgt: torch.Tensor,
    coords_src: torch.Tensor,
    k: int = 3,
    *,
    src_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `three_nn`: Gram-form distances, then the k smallest
    by a stable sort (ties keep index order; `torch.topk` does not
    promise that)."""
    d2 = pairwise_sqdist(coords_tgt, coords_src)  # (B, N, M)
    if src_mask is not None:
        d2 = torch.where(src_mask[:, None, :], d2, float("inf"))
    values, idx = torch.sort(d2, dim=-1, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def _three_nn_cuda(coords_tgt, coords_src, src_mask):
    B, N, _ = coords_tgt.shape
    M = coords_src.shape[1]
    _kernels.check(coords_tgt, "coords_tgt", torch.float32, (B, N, 3))
    _kernels.check(coords_src, "coords_src", torch.float32, (B, M, 3))
    if src_mask is not None:
        _kernels.check(src_mask, "src_mask", torch.bool, (B, M))
    if coords_tgt.device != coords_src.device:
        raise ValueError("coords_tgt and coords_src must be on the same device")
    d2 = torch.empty((B, N, 3), dtype=torch.float32, device=coords_src.device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=coords_src.device)
    if B == 0 or N == 0:
        return d2, idx
    _kernels.launch(
        "three_nn", "pointseg_three_nn", coords_src.device,
        _kernels.ptr(coords_tgt), _kernels.ptr(coords_src), _kernels.ptr(src_mask),
        _kernels.ptr(d2), _kernels.ptr(idx), B, N, M,
    )
    return d2, idx


def interpolate(
    features: torch.Tensor,
    coords_tgt: torch.Tensor,
    coords_src: torch.Tensor,
    k: int = 3,
    eps: float = 1e-9,
    *,
    src_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse-distance-weighted k-NN interpolation of `features`
    (B, M, D), which live on `coords_src`, onto `coords_tgt`.

    Returns:
        (B, N, D) interpolated features.
    """
    d2, idx = three_nn(coords_tgt, coords_src, k, src_mask=src_mask)
    neighbors = gather_rows(features, idx)  # (B, N, k, D)
    weights = 1.0 / (d2 + eps)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    dtype = torch.promote_types(features.dtype, torch.float32)  # accumulate in >= f32
    out = torch.einsum("bnk,bnkd->bnd", weights.to(dtype), neighbors.to(dtype))
    return out.to(features.dtype)
