"""3-NN inverse-distance-weighted feature interpolation (upsampling).

Port of `pointseg/ops/interpolate.py`. On a CUDA tensor the 3-NN
selection is one launch of `csrc/threenn.cu`; on a CPU tensor the plain
PyTorch version below runs; while `torch.export` traces, the operator
`pointseg_torch::three_nn` (`ops/library.py`). The weights 1/(d² + eps), normalised over
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
    if torch.compiler.is_exporting():  # one operator in the traced graph (ops/library.py)
        return torch.ops.pointseg_torch.three_nn(coords_tgt, coords_src, src_mask, k)
    if _kernels.on_cuda(coords_src):
        if k != 3:
            raise ValueError(f"the CUDA three_nn kernel takes k = 3, got {k}")
        return _three_nn_cuda(coords_tgt, coords_src, src_mask)
    if src_mask is not None:
        src_mask = src_mask.to(device=coords_src.device, dtype=torch.bool)
    return three_nn_plain(coords_tgt.detach().to(torch.float32),
                          coords_src.detach().to(torch.float32), k, src_mask=src_mask)


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


def _three_nn_cuda(coords_tgt, coords_src, src_mask, split=(0, 0)):
    """One launch of `csrc/threenn.cu`; `split` forces its (targets a
    warp, warps a block), (0, 0) lets the kernel choose. As the ball
    query's call: f32 contiguous inputs and a contiguous bool mask pass as
    they are, each is checked once, the outputs come from `new_empty`."""
    if coords_tgt.dtype != torch.float32 or not coords_tgt.is_contiguous():
        coords_tgt = coords_tgt.to(torch.float32).contiguous()
    if coords_src.dtype != torch.float32 or not coords_src.is_contiguous():
        coords_src = coords_src.to(torch.float32).contiguous()
    if (coords_tgt.dim() != 3 or coords_src.dim() != 3 or coords_tgt.shape[2] != 3
            or coords_src.shape[2] != 3 or coords_tgt.shape[0] != coords_src.shape[0]
            or coords_tgt.device != coords_src.device):
        raise ValueError(f"three_nn needs (B, N, 3) targets and (B, M, 3) sources on one "
                         f"device, got {tuple(coords_tgt.shape)} on {coords_tgt.device} and "
                         f"{tuple(coords_src.shape)} on {coords_src.device}")
    B, N, _ = coords_tgt.shape
    M = coords_src.shape[1]
    if src_mask is not None:
        if (src_mask.dtype != torch.bool or not src_mask.is_contiguous()
                or src_mask.device != coords_src.device):
            src_mask = src_mask.to(device=coords_src.device, dtype=torch.bool).contiguous()
        if src_mask.shape != (B, M):
            raise ValueError(f"src_mask: need shape {(B, M)}, got {tuple(src_mask.shape)}")
    d2 = coords_src.new_empty((B, N, 3))
    idx = coords_src.new_empty((B, N, 3), dtype=torch.int32)
    if B == 0 or N == 0:
        return d2, idx
    _kernels.launch(
        "three_nn", "pointseg_three_nn", coords_src.device,
        coords_tgt.data_ptr(), coords_src.data_ptr(), _kernels.ptr(src_mask), d2.data_ptr(),
        idx.data_ptr(), B, N, M, *split,
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
