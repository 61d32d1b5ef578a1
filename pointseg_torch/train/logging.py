"""Training observability (a copy of `pointseg/train/logging.py`, which
the port cannot import: `pointseg.train` imports JAX).

Rebuilds the reference's three logging mechanisms (SURVEY.md §5):
1. TensorBoard scalars/tensors — via torch.utils.tensorboard when it
   imports (it needs the tensorboard package), else skipped;
2. always-on CSV + JSONL scalars (inspectable without TensorBoard);
3. records export: the legacy stack's pickle of
   {train_loss, val_loss, val_acc[, epoch_times, total_time, config]}
   (Training/train_model.py:283-286, models/dgcnn/train_model.py:295-313)
   written as JSON.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
import time
from typing import Any


class MetricsLogger:
    """Scalar/tensor logger writing CSV + JSONL, mirrored to
    TensorBoard when available."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._csv.writerow(["wall_time", "tag", "step", "value"])
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        now = time.time()
        value = float(value)
        self._jsonl.write(
            json.dumps({"wall_time": now, "tag": tag, "step": int(step), "value": value})
            + "\n"
        )
        self._csv.writerow([now, tag, int(step), value])
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_tensor(self, tag: str, values, step: int) -> None:
        vals = [float(v) for v in values]
        self._jsonl.write(
            json.dumps(
                {"wall_time": time.time(), "tag": tag, "step": int(step), "values": vals}
            )
            + "\n"
        )
        if self._tb is not None:
            for i, v in enumerate(vals):
                self._tb.add_scalar(f"{tag}/{i}", v, step)

    def flush(self) -> None:
        self._jsonl.flush()
        self._csv_file.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()


def save_records(
    path_dir: str,
    filename: str,
    records: dict[str, Any],
    as_pickle: bool = False,
) -> str:
    """Legacy records export (reference Training/train_model.py:283-286).
    JSON by default; `as_pickle=True` writes the reference's .pkl format
    for tooling compatibility."""
    os.makedirs(path_dir, exist_ok=True)
    if as_pickle:
        path = os.path.join(path_dir, f"{filename}.pkl")
        with open(path, "wb") as f:
            pickle.dump(records, f)
    else:
        path = os.path.join(path_dir, f"{filename}.json")
        with open(path, "w") as f:
            json.dump(records, f, indent=2, default=float)
    return path
