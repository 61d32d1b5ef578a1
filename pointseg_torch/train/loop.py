"""The training loop (port of `pointseg/train/loop.py`): per-epoch
training with interval logging, a streaming evaluation pass over the
test set after every epoch, epoch summaries, and a checkpoint every
`ckpt_every_epochs` epochs (`pointseg_torch.io.checkpoint`).

Batches come from the numpy loaders of `pointseg_torch.data`, each copied
to the device once, or from the device-resident store
(`pointseg_torch.data.device.DeviceEpochLoader`), whose batches are
already there and pass through untouched. Metrics stay on the device and
are read at the log interval and at the end of an epoch; with
`scan_steps > 1` on the device store, once an epoch.
"""

from __future__ import annotations

import os
import time
from typing import Iterable

import numpy as np
import torch

from pointseg_torch.io.checkpoint import save_checkpoint
from pointseg_torch.parallel.mesh import barrier
from pointseg_torch.train import metrics as M
from pointseg_torch.train.logging import MetricsLogger
from pointseg_torch.train.state import TrainState, eval_step, train_step, train_step_accum
from pointseg_torch.utils.trace import span


def to_device(batch, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(points, labels, lengths) batch -> tensors on `device`: numpy
    arrays are copied there, tensors already there (the device store's
    batches) pass through untouched."""
    return tuple(a.to(device) if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.asarray(a)).to(device) for a in batch)


def _log_train_metrics(logger: MetricsLogger, loss, accuracy, miou, step: int) -> None:
    with span("pointseg_torch.loop.log_read"):
        logger.add_scalar("Train/Loss", float(loss), step)
        logger.add_scalar("Train/Accuracy", 100.0 * float(accuracy), step)
        logger.add_scalar("Train/Mean_IoU", 100.0 * float(miou), step)


def train_epoch(
    state: TrainState,
    train_loader: Iterable,
    logger: MetricsLogger | None,
    log_interval: int,
    global_step: int,
    scan_steps: int = 1,
    accum_steps: int = 1,
) -> tuple[TrainState, float, int]:
    """One pass over the training set; returns (state, mean loss, step).

    `scan_steps > 1` with a `DeviceEpochLoader` runs the epoch through
    its `scan_epoch`: same batch sequence and random streams, no host
    read until the epoch's stacked metrics are fetched once at its end
    (interval logging still happens, from those). With any other loader
    it changes nothing, as in the JAX package; `--data-parallel` hands
    the epoch a `parallel.ShardedLoader`, which is not one, so the scan
    path is not taken there either (as in the JAX package, whose wrapper
    hides the store's loader in the same way).

    `accum_steps > 1` groups K consecutive loader batches into ONE
    optimizer update via `train_step_accum` (an effective batch K*B at
    the peak memory of one batch). A short trailing group still
    accumulates. Host loaders only; mutually exclusive with `scan_steps`.
    """
    from pointseg_torch.data.device import DeviceEpochLoader

    if accum_steps > 1:
        if scan_steps > 1:
            raise ValueError("scan_steps and accum_steps are mutually exclusive")
        if isinstance(train_loader, DeviceEpochLoader):
            # _train_epoch_accum stacks batches on the host: every
            # micro-batch of a device loader would come back from the card
            raise ValueError(
                "accum_steps > 1 requires a host loader; the device "
                "store samples on the device and cannot be host-stacked "
                "(drop --device-data or --accum-steps)")
        return _train_epoch_accum(state, train_loader, logger, log_interval, global_step,
                                  accum_steps)

    if scan_steps > 1 and isinstance(train_loader, DeviceEpochLoader):
        state, ms = train_loader.scan_epoch(state, scan_steps)
        n = int(ms["loss"].shape[0]) if ms else 0
        with span("pointseg_torch.loop.epoch_close"):
            if logger is not None and n:
                # one fetch for the whole epoch's stacked metrics
                loss_h, acc_h, miou_h = (ms[k].cpu().numpy()
                                         for k in ("loss", "accuracy", "miou"))
                for i in range(0, n, log_interval):
                    _log_train_metrics(logger, loss_h[i], acc_h[i], miou_h[i], global_step + i)
            total_loss = float(ms["loss"].mean()) if n else 0.0
        return state, total_loss, global_step + n

    losses = []
    for batch_index, batch in enumerate(train_loader):
        with span("pointseg_torch.loop.to_device"):
            batch = to_device(batch, state.device)
        metrics = train_step(state, *batch)
        if logger is not None and batch_index % log_interval == 0:
            _log_train_metrics(logger, metrics["loss"], metrics["accuracy"], metrics["miou"],
                               global_step)
        losses.append(metrics["loss"])
        global_step += 1
    with span("pointseg_torch.loop.epoch_close"):
        total_loss = float(torch.stack(losses).mean()) if losses else 0.0
    return state, total_loss, global_step


def _train_epoch_accum(
    state: TrainState,
    train_loader: Iterable,
    logger: MetricsLogger | None,
    log_interval: int,
    global_step: int,
    accum_steps: int,
) -> tuple[TrainState, float, int]:
    """Gradient-accumulation epoch: K loader batches -> one update.

    The K batches are stacked on the host and copied to the device as
    one (K, B, ...) array each: fewer, larger copies. `global_step`
    counts OPTIMIZER updates, matching `state.step`.
    """
    losses = []
    group: list = []

    def flush():
        nonlocal global_step
        with span("pointseg_torch.loop.to_device"):
            stacked = to_device((np.stack(parts) for parts in zip(*group)), state.device)
        metrics = train_step_accum(state, *stacked)
        if logger is not None and global_step % log_interval == 0:
            _log_train_metrics(logger, metrics["loss"], metrics["accuracy"], metrics["miou"],
                               global_step)
        losses.append(metrics["loss"])
        global_step += 1
        group.clear()

    for batch in train_loader:
        group.append(tuple(np.asarray(a) for a in batch))
        if len(group) == accum_steps:
            flush()
    if group:
        flush()
    with span("pointseg_torch.loop.epoch_close"):
        total_loss = float(torch.stack(losses).mean()) if losses else 0.0
    return state, total_loss, global_step


def evaluate(state: TrainState, test_loader: Iterable, num_classes: int = 14,
             step_fn=None) -> dict:
    """Streaming evaluation over the test set: loss, overall and
    mean-class accuracy, per-class IoU and mIoU, confusion matrix.

    `step_fn` defaults to `eval_step` (running BatchNorm statistics); pass
    `make_eval_step(model, "batch")` for test-time BatchNorm adaptation
    (`pointseg_torch/train/state.py`)."""
    if step_fn is None:
        step_fn = eval_step
    device = state.device
    losses = []
    correct = torch.zeros((), dtype=torch.int64, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    inter = torch.zeros((num_classes,), device=device)
    union = torch.zeros((num_classes,), device=device)
    confusion = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for batch in test_loader:
        out = step_fn(state, *to_device(batch, device))
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
    ckpt_dir: str | None = None,
    ckpt_every_epochs: int = 1,
    config: dict | None = None,
    verbose: bool = True,
    confusion_dir: str | None = None,
    scan_steps: int = 1,
    accum_steps: int = 1,
) -> tuple[TrainState, dict]:
    """Full training run, with a checkpoint (and `config` as its sidecar)
    in `ckpt_dir` every `ckpt_every_epochs` epochs and, with
    `confusion_dir`, the epoch's evaluation confusion matrix drawn into
    `confusion_dir/confusion_epoch_{n}.png` (nothing where matplotlib is
    not installed, as in the JAX package). Returns the final state and
    the records {train_loss, val_loss, val_acc, val_miou, epoch_times,
    total_time}.

    On a data-parallel `state.mesh` every rank trains on its rows and
    evaluates the whole test set, as one process does; only rank 0
    prints, draws and writes the checkpoint, after every rank has come to
    it (give the other ranks a `NullLogger`, `train/logging.py`)."""
    main = state.mesh is None or state.mesh.rank == 0
    verbose = verbose and main
    global_step = state.step
    records = {"train_loss": [], "val_loss": [], "val_acc": [], "val_miou": [],
               "epoch_times": []}
    t_start = time.time()
    for epoch in range(num_epochs):
        t0 = time.time()
        state, train_loss, global_step = train_epoch(
            state, train_loader, logger, log_interval, global_step,
            scan_steps=scan_steps, accum_steps=accum_steps)
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

        if confusion_dir is not None and main:
            # the reference wires this plot but leaves it commented out (training.py:176)
            try:
                from pointseg_torch.utils.visualize import plot_confusion_matrix

                os.makedirs(confusion_dir, exist_ok=True)
                plot_confusion_matrix(
                    ev["confusion"],
                    os.path.join(confusion_dir, f"confusion_epoch_{epoch + 1}.png"))
            except ImportError:
                pass  # matplotlib not installed

        if ckpt_dir is not None and (epoch + 1) % ckpt_every_epochs == 0:
            barrier(state.mesh)  # every rank has finished the epoch
            if main:
                save_checkpoint(ckpt_dir, state, config=config)

    records["total_time"] = time.time() - t_start
    if config is not None:
        records["config"] = config
    return state, records
