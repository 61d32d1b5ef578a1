"""Batched row gathers.

Port of `gather_rows` and `gather_rows_with_coords` from
`pointseg/ops/gather.py` as a plain indexed gather (`torch.gather`),
whose backward is a scatter-add. The JAX package's one-hot matrix-unit
strategies and its bf16 coordinate packing exist for the TPU and are
not ported. Indices are selections and carry no gradient.
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathers rows of a batched table by integer indices.

    Args:
        table: (B, N, C) rows.
        idx: (B, ...) integer indices into N, any trailing shape.

    Returns:
        (B, *idx.shape[1:], C); differentiable in `table`.
    """
    B, _, C = table.shape
    flat = idx.reshape(B, -1).long()
    rows = torch.gather(table, 1, flat[..., None].expand(-1, -1, C))
    return rows.reshape(*idx.shape, C)


def gather_rows_with_coords(
    features: torch.Tensor, coords: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathers feature rows and coordinate rows with the same indices.

    One gather over the concatenated (features, coords) table when the
    dtypes agree, two otherwise. Coordinates are selection geometry and
    are detached, as in the JAX package; `features` stays differentiable.

    Returns:
        ((B, *idx.shape[1:], H), (B, *idx.shape[1:], 3)).
    """
    coords = coords.detach()
    h = features.shape[-1]
    if features.dtype == coords.dtype:
        rows = gather_rows(torch.cat([features, coords], dim=-1), idx)
        return rows[..., :h], rows[..., h:]
    return gather_rows(features, idx), gather_rows(coords, idx)
