"""The selections of the plain reference: FPS, ball query, 3-NN and kNN.

Frozen copies of the plain PyTorch versions that the program's CUDA
kernels were made equal to, index for index: distances in the same
order of rounded operations, ties to the lowest index (a stable sort,
`argmax`'s first maximum). The reference's selections therefore match
the program's wherever the coordinates they see match, and its logits
can be held to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

PLAIN_BLOCK_BYTES = 64 << 20  # one (B, rows, N) score block of the kNN


def _sum_terms(t: torch.Tensor) -> torch.Tensor:
    out = t[..., 0]
    for d in range(1, t.shape[-1]):
        out = out + t[..., d]
    return out


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, C, D), (B, N, D) -> (B, C, N) `max((|a|² - 2 a·b) + |b|², 0)`,
    the dot product summed term by term in coordinate order."""
    aa, bb = a[..., :, None, :], b[..., None, :, :]
    cross = aa[..., 0] * bb[..., 0]
    for d in range(1, a.shape[-1]):
        cross = cross + aa[..., d] * bb[..., d]
    a2 = _sum_terms(a * a)[..., :, None]
    b2 = _sum_terms(b * b)[..., None, :]
    return torch.clamp_min(a2 - 2.0 * cross + b2, 0.0)


def fps(coords: torch.Tensor, num_samples: int, start: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), C, (B,) starts -> (B, C) indices of farthest point sampling."""
    B, N, _ = coords.shape
    x, y, z = coords.float().unbind(-1)
    dist = torch.full((B, N), float("inf"), device=coords.device)
    out = torch.empty((B, num_samples), dtype=torch.int64, device=coords.device)
    far = start.long()[:, None]
    for i in range(num_samples):
        out[:, i] = far[:, 0]
        if i == num_samples - 1:
            break
        dx = x - x.gather(1, far)
        dy = y - y.gather(1, far)
        dz = z - z.gather(1, far)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = dist.argmax(dim=1, keepdim=True)
    return out


def ball_query(centroids: torch.Tensor, coords: torch.Tensor, radius: float,
               K: int) -> torch.Tensor:
    """(B, C, K) indices: each ball's members nearest first (ties by index),
    a sparse ball filled with its nearest member."""
    d2 = sqdist(centroids.float(), coords.float())
    r2 = float(np.float32(radius) * np.float32(radius))
    masked = torch.where(d2 <= r2, d2, float("inf"))
    values, idx = torch.sort(masked, dim=-1, stable=True)
    idx, inside = idx[..., :K], values[..., :K] < float("inf")
    return torch.where(inside, idx, idx[..., :1])


def three_nn(tgt: torch.Tensor, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(d² (B, N, 3), idx (B, N, 3)) of each target's three nearest sources."""
    d2 = sqdist(tgt.float(), src.float())
    values, idx = torch.sort(d2, dim=-1, stable=True)
    return values[..., :3], idx[..., :3]


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, k) indices of each point's k nearest points under squared L2
    (itself included): the k largest of (2 x_i·x_j - |x_i|²) - |x_j|², the
    dot product summed in feature order, ties by index; query rows in
    blocks so that no (B, N, N) tensor exists."""
    x = x.detach().float()
    B, N, F = x.shape
    x2 = _sum_terms(x * x)
    rows = max(1, min(N, PLAIN_BLOCK_BYTES // (4 * B * N)))
    out = torch.empty((B, N, k), dtype=torch.int64, device=x.device)
    xx = x.transpose(1, 2)[:, :, None, :]
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        qq = x[:, r0:r1].transpose(1, 2)[..., None]
        dot = qq[:, 0] * xx[:, 0]
        for f in range(1, F):
            dot = dot + qq[:, f] * xx[:, f]
        neg = -(2.0 * dot - x2[:, r0:r1, None] - x2[:, None, :])
        out[:, r0:r1] = torch.sort(neg, dim=-1, stable=True)[1][..., :k]
    return out


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, D), idx (B, ...) -> (B, ..., D)."""
    B = table.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(table, 1, flat[..., None].expand(-1, -1, table.shape[-1]))
    return out.reshape(*idx.shape, table.shape[-1])
