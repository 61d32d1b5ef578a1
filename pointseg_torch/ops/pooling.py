"""Region pooling over grouped neighbourhoods (port of
`pointseg/ops/pooling.py`).

Max-pooling uses `torch.amax`, whose gradient is shared evenly among
tied maxima, as `jnp.max`'s is. Ties are common here: the repeat filler
puts the same row into a region several times.
"""

from __future__ import annotations

import torch


def reduce(x: torch.Tensor, kind: str = "max", dim: int = 2) -> torch.Tensor:
    """Pools each region to one point: (B, C, K, D) -> (B, C, D)."""
    if kind == "max":
        return torch.amax(x, dim=dim)
    if kind == "avg":
        return torch.mean(x, dim=dim)
    raise ValueError(f"'{kind}' pooling not supported; use 'max' or 'avg'.")


def masked_reduce(
    x: torch.Tensor, mask: torch.Tensor, kind: str = "max", dim: int = 2
) -> torch.Tensor:
    """Pools with a validity mask over the pooled axis.

    Args:
        x: (..., K, D) values.
        mask: bool, True = valid, broadcastable to x over the same K
            axis (a mask without the trailing D axis is expanded).
        kind: 'max' or 'avg'.

    A region with no valid entry pools to 0, so no sentinel reaches the
    BatchNorm statistics downstream.
    """
    if mask.dim() == x.dim() - 1:
        mask = mask[..., None]
    any_valid = mask.any(dim=dim)
    if kind == "max":
        lowest = torch.finfo(x.dtype).min
        pooled = torch.amax(torch.where(mask, x, lowest), dim=dim)
        return torch.where(any_valid, pooled, 0.0).to(x.dtype)
    if kind == "avg":
        total = torch.where(mask, x, 0.0).sum(dim=dim)
        count = mask.sum(dim=dim).clamp_min(1)
        return total / count.to(x.dtype)
    raise ValueError(f"'{kind}' pooling not supported; use 'max' or 'avg'.")
