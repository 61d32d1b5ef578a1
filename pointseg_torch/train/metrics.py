"""Segmentation metrics over zero-padded variable-length batches (port
of `pointseg/train/metrics.py`).

All functions take predictions (B, N, C) class scores (argmax is taken),
labels (B, N, C) one-hot (padded rows all zero) and lengths (B,). Class
membership for IoU and the confusion matrix reads the one-hot channel
(`labels == 1`), so a padded row belongs to no class; mIoU smooths
numerator and denominator with eps = 1e-6, so an absent class scores 1.
They return tensors on the input's device and never synchronise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointseg_torch.train.loss import length_mask


def _argmax_and_mask(predictions, labels, lengths):
    pred = predictions.argmax(dim=-1)
    lab = labels.argmax(dim=-1)
    return pred, lab, length_mask(lengths, predictions.shape[1])


def update_accuracy(predictions, labels, lengths) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) point counts, the streaming form."""
    pred, lab, mask = _argmax_and_mask(predictions, labels, lengths)
    return ((pred == lab) & mask).sum(), mask.sum()


def overall_accuracy(predictions, labels, lengths) -> torch.Tensor:
    """Accuracy over non-padding points."""
    correct, total = update_accuracy(predictions, labels, lengths)
    return correct / total.clamp_min(1)


def _masked_onehots(predictions, labels, lengths):
    num_classes = labels.shape[-1]
    pred, _, mask = _argmax_and_mask(predictions, labels, lengths)
    m = mask.to(torch.float32)[..., None]
    pred_m = F.one_hot(pred, num_classes).to(torch.float32) * m
    lab_m = (labels == 1).to(torch.float32) * m
    return pred_m, lab_m


def confusion_matrix(predictions, labels, lengths) -> torch.Tensor:
    """(C, C) int32 confusion matrix, rows = true class, cols = predicted."""
    pred_m, lab_m = _masked_onehots(predictions, labels, lengths)
    return torch.einsum("bni,bnj->ij", lab_m, pred_m).to(torch.int32)


def update_intersection_over_union(predictions, labels, lengths):
    """Per-class (intersections, unions), the streaming form."""
    pred_m, lab_m = _masked_onehots(predictions, labels, lengths)
    inter = (pred_m * lab_m).sum(dim=(0, 1))
    union = torch.maximum(pred_m, lab_m).sum(dim=(0, 1))
    return inter, union


def intersection_over_union(predictions, labels, lengths, eps: float = 1e-6):
    """(mIoU, per-class IoUs)."""
    inter, union = update_intersection_over_union(predictions, labels, lengths)
    return iou_from_totals(inter, union, eps)


def iou_from_totals(intersections, unions, eps: float = 1e-6):
    """Finalises streamed I/U totals into (mIoU, per-class IoUs)."""
    ious = (intersections + eps) / (unions + eps)
    return ious.mean(), ious


def accuracy_from_one_hot(labels, predictions) -> torch.Tensor:
    """Legacy-stack accuracy: argmax against argmax over ALL positions,
    padding included."""
    return (labels.argmax(dim=-1) == predictions.argmax(dim=-1)).to(torch.float32).mean()
