"""Masked cross-entropy (port of `pointseg/train/loss.py`): float32
log-softmax over classes, positions at or past each sample's length
masked out, mean over the valid points, and 0 when every point is
padding.

Inside a data-parallel step (`parallel/mesh.py`) the batch is one rank's
rows and the mean divides by the valid points of the global batch: each
rank's loss is its share of the global loss (0 for a rank whose rows are
all padding), the shares sum to the one-process loss, and so do their
gradients. A global batch that is all padding gives 0."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointseg_torch.parallel.mesh import active, all_reduce_


def length_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) lengths -> (B, N) bool mask of valid positions."""
    positions = torch.arange(n, device=lengths.device)
    return positions[None, :] < lengths.to(torch.int64)[:, None]


def _masked_mean(token_loss: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    mask = length_mask(lengths, token_loss.shape[1]).to(torch.float32)
    total = mask.sum()
    mesh = active()
    if mesh is not None:  # the global batch's count: this rank's share of its mean
        total = all_reduce_(total.clone(), mesh)
    loss = (token_loss * mask).sum() / total.clamp_min(1.0)
    return torch.where(total > 0, loss, torch.zeros_like(loss))


def masked_onehot_cross_entropy(
    logits: torch.Tensor, targets_onehot: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over non-padding points.

    Args:
        logits: (B, N, C) scores.
        targets_onehot: (B, N, C) one-hot labels, any numeric dtype.
        lengths: (B,) valid points per sample.
    """
    log_probs = F.log_softmax(logits.to(torch.float32), dim=-1)
    token_loss = -(targets_onehot.to(torch.float32) * log_probs).sum(dim=-1)
    return _masked_mean(token_loss, lengths)


def masked_cross_entropy_int(
    logits: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Integer-label variant: labels (B, N)."""
    log_probs = F.log_softmax(logits.to(torch.float32), dim=-1)
    token_loss = -log_probs.gather(-1, labels[..., None].long())[..., 0]
    return _masked_mean(token_loss, lengths)
