"""The training loop (port of the host-loader path of
`pointseg/train/loop.py`): per-epoch training with interval logging,
a streaming evaluation pass over the test set after every epoch, and
epoch summaries. Checkpoints, the device-resident store, scanned and
accumulated steps are not ported yet (ROADMAP.md).

Batches come from the numpy loaders of `pointseg.data`; each is copied
to the device once. Metrics stay on the device and are read at the log
interval and at the end of an epoch.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from pointseg_torch.train import metrics as M
from pointseg_torch.train.logging import MetricsLogger
from pointseg_torch.train.state import TrainState, eval_step, train_step


def to_device(batch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(points, labels, lengths) numpy batch -> tensors on `device`."""
    return tuple(torch.from_numpy(np.asarray(a)).to(device) for a in batch)


def train_epoch(
    state: TrainState,
    train_loader: Iterable,
    logger: MetricsLogger | None,
    log_interval: int,
    global_step: int,
) -> tuple[TrainState, float, int]:
    """One pass over the training set; returns (state, mean loss, step)."""
    losses = []
    for batch_index, batch in enumerate(train_loader):
        metrics = train_step(state, *to_device(batch, state.device))
        if logger is not None and batch_index % log_interval == 0:
            logger.add_scalar("Train/Loss", float(metrics["loss"]), global_step)
            logger.add_scalar("Train/Accuracy", 100.0 * float(metrics["accuracy"]),
                              global_step)
            logger.add_scalar("Train/Mean_IoU", 100.0 * float(metrics["miou"]),
                              global_step)
        losses.append(metrics["loss"])
        global_step += 1
    total_loss = float(torch.stack(losses).mean()) if losses else 0.0
    return state, total_loss, global_step


def evaluate(state: TrainState, test_loader: Iterable, num_classes: int = 14) -> dict:
    """Streaming evaluation over the test set: loss, overall and
    mean-class accuracy, per-class IoU and mIoU, confusion matrix."""
    device = state.device
    losses = []
    correct = torch.zeros((), dtype=torch.int64, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    inter = torch.zeros((num_classes,), device=device)
    union = torch.zeros((num_classes,), device=device)
    confusion = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for batch in test_loader:
        out = eval_step(state, *to_device(batch, device))
        losses.append(out["loss"])
        correct += out["correct"]
        total += out["total"]
        inter += out["intersections"]
        union += out["unions"]
        confusion += out["confusion"]

    mean_iou, ious = M.iou_from_totals(inter, union)
    conf = confusion.cpu().numpy()
    # per-class recall; a class with no true points contributes 0
    class_total = conf.sum(axis=1)
    class_acc = np.where(class_total > 0, np.diag(conf) / np.maximum(class_total, 1), 0.0)
    return {
        "loss": float(torch.stack(losses).mean()) if losses else 0.0,
        "accuracy": int(correct) / max(int(total), 1),
        "mean_class_accuracy": float(class_acc.mean()) if len(class_acc) else 0.0,
        "class_accuracies": class_acc,
        "mean_iou": float(mean_iou),
        "ious": ious.cpu().numpy(),
        "confusion": conf,
    }


def train_model(
    state: TrainState,
    train_loader: Iterable,
    test_loader: Iterable,
    num_epochs: int,
    log_interval: int = 20,
    logger: MetricsLogger | None = None,
    num_classes: int = 14,
    config: dict | None = None,
    verbose: bool = True,
) -> tuple[TrainState, dict]:
    """Full training run. Returns the final state and the records
    {train_loss, val_loss, val_acc, val_miou, epoch_times, total_time}."""
    global_step = state.step
    records = {"train_loss": [], "val_loss": [], "val_acc": [], "val_miou": [],
               "epoch_times": []}
    t_start = time.time()
    for epoch in range(num_epochs):
        t0 = time.time()
        state, train_loss, global_step = train_epoch(
            state, train_loader, logger, log_interval, global_step)
        ev = evaluate(state, test_loader, num_classes=num_classes)
        dt = time.time() - t0

        if verbose:
            print(f"Epoch {epoch + 1} completed ({dt:.1f}s):")
            print(f"- Training loss: {train_loss}")
            print(f"- Validation loss: {ev['loss']}")
            print(f"- Validation accuracy: {ev['accuracy']}")
            print(f"- Validation mean IoU: {ev['mean_iou']}")
            print("-" * 15, flush=True)
        if logger is not None:
            logger.add_scalar("Train/Epoch_Loss", train_loss, epoch)
            logger.add_scalar("Val/Loss", ev["loss"], epoch)
            logger.add_scalar("Val/Accuracy", 100.0 * ev["accuracy"], epoch)
            logger.add_scalar("Val/Mean_Iou", 100.0 * ev["mean_iou"], epoch)
            logger.add_tensor("Val/Ious", 100.0 * ev["ious"], epoch)
            logger.flush()

        records["train_loss"].append(train_loss)
        records["val_loss"].append(ev["loss"])
        records["val_acc"].append(ev["accuracy"])
        records["val_miou"].append(ev["mean_iou"])
        records["epoch_times"].append(dt)

    records["total_time"] = time.time() - t_start
    if config is not None:
        records["config"] = config
    return state, records
