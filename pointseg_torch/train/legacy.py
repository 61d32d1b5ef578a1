"""The legacy/chunked training stack (port of `pointseg/train/legacy.py`,
the reference's Training/train_model.py:89-288).

Whole-room list batches with string labels, host-side preprocessing
(fractional random subsampling, pad/truncate to min(batch_max, cut),
string -> one-hot), the B == 1 skip (BatchNorm needs batch statistics),
Adam training with an evaluation after every epoch, and the records
export. As in the JAX package: batches are channels-last (B, N, D),
padded to a multiple of 512 points (capped by `cut`), and the model is
called as `logits = model(points)`.

`preprocess_batch_to_train_format` is numpy and gives the JAX package's
arrays bit for bit from the same `np.random.Generator`. The steps are the
port's `train_step` / `eval_step` on the state's device: batches are
copied there once each. Dropout draws from torch's default generator and
FPS from the state's (`pointseg_torch/train/state.py`), where the JAX
package folds the epoch into one key.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
import torch

from pointseg_torch.train.logging import save_records
from pointseg_torch.train.loop import to_device
from pointseg_torch.train.state import TrainState, eval_step, train_step


def preprocess_batch_to_train_format(
    x: Sequence[np.ndarray],
    y: Sequence[Sequence[str]],
    mapping: Sequence[str],
    cut: int | None = None,
    sampling: float | None = None,
    rng: np.random.Generator | None = None,
    pad_multiple: int = 512,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Variable-length rooms -> padded arrays + one-hot labels.

    Mirrors the reference semantics (train_model.py:89-171): optional
    fractional sampling to max(int(N*s), 1) points without replacement,
    pad/truncate to min(batch_max, cut), labels one-hot via
    mapping.index, lengths clamped to cut, cont=False when B == 1.

    Returns (points (B, N, D) f32, labels (B, N, C) f32, lengths (B,),
    cont). N is rounded up to `pad_multiple` (set pad_multiple=1 for
    exact reference shapes).
    """
    if sampling is not None and not (0 < sampling <= 1.0):
        raise ValueError(f"sampling must be in (0,1], got {sampling}")
    rng = rng or np.random.default_rng()

    if sampling is not None:
        xs, ys = [], []
        for xi, yi in zip(x, y):
            n = xi.shape[0]
            k = max(int(n * sampling), 1)
            perm = rng.permutation(n)[:k]
            xs.append(xi[perm])
            ys.append([yi[j] for j in perm])
        x, y = xs, ys

    lengths = np.array([xi.shape[0] for xi in x], np.int32)
    max_length = int(lengths.max())
    if cut is not None:
        max_length = min(max_length, cut)
    n_pad = (int(math.ceil(max_length / pad_multiple) * pad_multiple) if pad_multiple > 1
             else max_length)
    if cut is not None:
        n_pad = min(n_pad, max(cut, max_length))

    B = len(x)
    D = x[0].shape[-1]
    C = len(mapping)
    index = {label: i for i, label in enumerate(mapping)}

    points = np.zeros((B, n_pad, D), np.float32)
    labels = np.zeros((B, n_pad, C), np.float32)
    for i, (xi, yi) in enumerate(zip(x, y)):
        n = min(xi.shape[0], max_length)
        points[i, :n] = xi[:n]
        codes = np.array([index.get(l, -1) for l in yi[:n]], np.int64)
        if (codes < 0).any():
            bad = sorted({l for l in yi[:n] if l not in index})
            raise ValueError(f"Labels not present in mapping: {bad}")
        labels[i, np.arange(n), codes] = 1.0

    lengths = np.minimum(lengths, max_length)
    return points, labels, lengths, B > 1


def batches(loader: Iterable, mapping: Sequence[str], cut: int | None,
            sampling: float | None, np_rng: np.random.Generator, device: torch.device):
    """The loader's list batches, preprocessed and on `device`; batches of
    one room are skipped (the reference's B == 1 rule)."""
    for batch in loader:
        points, labels, lengths, cont = preprocess_batch_to_train_format(
            batch["x"], batch["y"], mapping, cut=cut, sampling=sampling, rng=np_rng)
        if cont:
            yield to_device((points, labels, lengths), device)


def train_epoch(
    state: TrainState,
    train_loader: Iterable,
    mapping: Sequence[str],
    cut: int | None,
    sampling: float | None,
    np_rng: np.random.Generator,
) -> tuple[TrainState, float]:
    """(reference train_model.py:175-198). The loss is the mean over the
    batches trained on; the reference divides by the loader's length,
    skipped B == 1 batches included, which understates it (the JAX
    package's deliberate fix)."""
    losses = [train_step(state, *b)["loss"]
              for b in batches(train_loader, mapping, cut, sampling, np_rng, state.device)]
    return state, float(torch.stack(losses).sum()) / len(losses) if losses else 0.0


def evaluate(
    state: TrainState,
    test_loader: Iterable,
    mapping: Sequence[str],
    cut: int | None,
    sampling: float | None,
    np_rng: np.random.Generator,
) -> tuple[float | None, float | None]:
    """Loss + length-weighted accuracy (reference train_model.py:201-224).
    The reference weights `accuracy_from_one_hot` (computed over ALL
    positions, padding included) by the real lengths; this is the
    masked accuracy, as in the JAX package. (None, None) when no batch
    was evaluated."""
    losses, correct, total = [], 0, 0
    for b in batches(test_loader, mapping, cut, sampling, np_rng, state.device):
        out = eval_step(state, *b)
        losses.append(out["loss"])
        correct = correct + out["correct"]
        total = total + out["total"]
    if not losses:
        return None, None
    return (float(torch.stack(losses).sum()) / len(losses),
            float(correct) / max(float(total), 1.0))


def train_model(
    state: TrainState,
    train_loader: Iterable,
    test_loader: Iterable,
    mapping: Sequence[str],
    epochs: int = 20,
    print_records: bool = False,
    records_dir: str | None = None,
    records_filename: str | None = None,
    cut: int | None = None,
    sampling: float | None = None,
    seed: int = 0,
) -> tuple[TrainState, dict]:
    """The legacy loop (reference train_model.py:230-287); `seed` seeds
    the numpy sampling generator. Returns (state, {train_loss, val_loss,
    val_acc}), the records also written to
    `records_dir/records_filename.json` when `records_dir` is given."""
    np_rng = np.random.default_rng(seed)
    train_losses, val_losses, val_metrics = [], [], []

    for epoch in range(epochs):
        state, train_loss = train_epoch(state, train_loader, mapping, cut, sampling, np_rng)
        val_loss, val_acc = evaluate(state, test_loader, mapping, cut, sampling, np_rng)
        train_losses.append(train_loss)
        val_losses.append(val_loss)
        val_metrics.append(val_acc)
        if print_records:
            print(f"Epoch {epoch + 1}/{epochs}")
            print(f"Train Loss: {train_loss}")
            print(f"Val Loss: {val_loss}, Val Accuracy: {val_acc}", flush=True)

    records = {"train_loss": train_losses, "val_loss": val_losses, "val_acc": val_metrics}
    if records_dir is not None:
        save_records(records_dir, records_filename or "records", records)
    return state, records
