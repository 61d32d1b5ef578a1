"""Instrumented legacy-stack trainer and its config-closure factory (port
of `pointseg/train/enhanced.py`, the reference's "enhanced" DGCNN
trainer, models/dgcnn/train_model.py).

Per-batch throughput, ETA and device memory (reference :61-90), epoch
summaries (:259-280), records with `epoch_times`, `total_time` and the
whole `config` (:295-313), `create_dgcnn_trainer(**config)` with the
reference's recommended configuration (k = 40, emb_dims = 1024, cut
8192, sampling 0.5, 50 epochs, 14 classes; :319-336), and
`quick_test_model`, a forward on random input with its time and memory
(:476-520). k = 40 is past the flat kNN kernel's 32, so every EdgeConv
of the default trainer runs the two-level kNN kernel on the card
(`pointseg_torch/ops/knn.py`).
"""

from __future__ import annotations

import time
from typing import Iterable, Sequence

import numpy as np
import torch

from pointseg_torch.data.s3dis import S3DIS_CLASSES
from pointseg_torch.train.legacy import batches, evaluate
from pointseg_torch.train.logging import save_records
from pointseg_torch.train.state import TrainState, create_train_state, train_step
from pointseg_torch.utils.memory import format_memory_usage


def train_epoch_with_progress(
    state: TrainState,
    train_loader: Iterable,
    mapping: Sequence[str],
    cut: int | None,
    sampling: float | None,
    np_rng: np.random.Generator,
    epoch: int,
    num_epochs: int,
    log_every: int = 10,
    verbose: bool = True,
) -> tuple[TrainState, float]:
    """Legacy train epoch with a rate / ETA / memory line every
    `log_every` batches (reference train_model.py:14-118); the loss is the
    mean over the batches trained on (B == 1 skipped, as in `legacy.py`)."""
    losses = []
    n_total = len(train_loader)
    t0 = time.time()
    points_seen = 0
    for bi, (points, labels, lengths) in enumerate(
            batches(train_loader, mapping, cut, sampling, np_rng, state.device)):
        metrics = train_step(state, points, labels, lengths)
        losses.append(metrics["loss"])  # on the device; one read an epoch
        points_seen += int(lengths.sum())
        if verbose and (bi + 1) % log_every == 0:
            dt = time.time() - t0
            rate = (bi + 1) / dt
            eta = (n_total - bi - 1) / max(rate, 1e-9)
            print(f"Epoch {epoch + 1}/{num_epochs} [{bi + 1}/{n_total}] "
                  f"loss={float(metrics['loss']):.4f} {points_seen / dt:,.0f} pts/s "
                  f"eta={eta:.0f}s | {format_memory_usage()}", flush=True)
    return state, float(torch.stack(losses).sum()) / len(losses) if losses else 0.0


def evaluate_with_progress(
    state: TrainState,
    test_loader: Iterable,
    mapping: Sequence[str],
    cut: int | None,
    np_rng: np.random.Generator,
) -> tuple[float | None, float | None]:
    """(reference train_model.py:121-168): the legacy evaluation
    (`legacy.evaluate`), which never subsamples here."""
    return evaluate(state, test_loader, mapping, cut, None, np_rng)


def train_model_with_detailed_progress(
    state: TrainState,
    train_loader: Iterable,
    test_loader: Iterable,
    mapping: Sequence[str],
    epochs: int = 50,
    cut: int | None = 8192,
    sampling: float | None = 0.5,
    records_dir: str | None = None,
    records_filename: str = "records",
    config: dict | None = None,
    seed: int = 0,
    verbose: bool = True,
) -> tuple[TrainState, dict]:
    """Full instrumented run with timing records (reference
    train_model.py:171-316); `seed` seeds the numpy sampling generator."""
    np_rng = np.random.default_rng(seed)
    records = {"train_loss": [], "val_loss": [], "val_acc": [], "epoch_times": [],
               "config": config or {}}
    t_start = time.time()
    for epoch in range(epochs):
        t0 = time.time()
        state, train_loss = train_epoch_with_progress(
            state, train_loader, mapping, cut, sampling, np_rng, epoch, epochs,
            verbose=verbose)
        val_loss, val_acc = evaluate_with_progress(state, test_loader, mapping, cut, np_rng)
        dt = time.time() - t0
        records["train_loss"].append(train_loss)
        records["val_loss"].append(val_loss)
        records["val_acc"].append(val_acc)
        records["epoch_times"].append(dt)
        if verbose:
            print(f"=== Epoch {epoch + 1}/{epochs} done in {dt:.1f}s | "
                  f"train {train_loss:.4f} | val {val_loss} | acc {val_acc} | "
                  f"{format_memory_usage()}", flush=True)
    records["total_time"] = time.time() - t_start
    if records_dir is not None:
        save_records(records_dir, records_filename, records)
    return state, records


def create_dgcnn_trainer(**config):
    """Config-closure trainer factory (reference train_model.py:319-473).

    Defaults are the reference's recommended configuration; override any
    by keyword. `device` (default "cuda") is where the model trains;
    `seed` fixes the weights (`torch.manual_seed`), the FPS generator and
    the numpy sampling. Returns (`train(train_loader, test_loader) ->
    (state, records)`, the config).
    """
    cfg = {
        "num_classes": 14,
        "k": 40,
        "emb_dims": 1024,
        "dropout": 0.5,
        "learning_rate": 1e-3,
        "epochs": 50,
        "cut": 8192,
        "sampling": 0.5,
        "mapping": S3DIS_CLASSES,
        "records_dir": None,
        "records_filename": "dgcnn_records",
        "seed": 0,
        "verbose": True,
        "device": "cuda",
    }
    cfg.update(config)

    def train(train_loader, test_loader):
        from pointseg_torch.models import DGCNNWithColor

        torch.manual_seed(cfg["seed"])
        model = DGCNNWithColor(num_classes=cfg["num_classes"], k=cfg["k"],
                               emb_dims=cfg["emb_dims"], dropout=cfg["dropout"])
        state = create_train_state(model, device=cfg["device"],
                                   learning_rate=cfg["learning_rate"], seed=cfg["seed"])
        return train_model_with_detailed_progress(
            state, train_loader, test_loader, cfg["mapping"], epochs=cfg["epochs"],
            cut=cfg["cut"], sampling=cfg["sampling"], records_dir=cfg["records_dir"],
            records_filename=cfg["records_filename"],
            config={k: v for k, v in cfg.items() if k != "mapping"}, seed=cfg["seed"],
            verbose=cfg["verbose"])

    return train, cfg


def quick_test_model(
    num_classes: int = 14, k: int = 16, emb_dims: int = 256, n_points: int = 4096,
    verbose: bool = True, device: torch.device | str = "cuda",
) -> dict:
    """Forward of a DGCNNWithColor on random input (2, n_points, 6), with
    its time and memory (reference train_model.py:476-520). Eager PyTorch
    compiles nothing: `compile_time_s` is the first call's time (the JAX
    package's compile and run), kernel build and load included on a
    first use of the card; `steady_time_s` the second's. Both end in a
    synchronisation on the card."""
    from pointseg_torch.models import DGCNNWithColor

    device = torch.device(device)
    torch.manual_seed(0)
    model = DGCNNWithColor(num_classes=num_classes, k=k, emb_dims=emb_dims).to(device).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, n_points, 6)).astype(np.float32)).to(device)

    def timed_forward():
        t0 = time.time()
        with torch.no_grad():
            out = model(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.time() - t0

    out, compile_s = timed_forward()
    out, steady_s = timed_forward()
    n_params = sum(p.numel() for p in model.parameters())
    result = {
        "output_shape": tuple(out.shape),
        "compile_time_s": compile_s,
        "steady_time_s": steady_s,
        "num_params": n_params,
        "memory": format_memory_usage(),
    }
    if verbose:
        print(f"quick_test_model: out {tuple(out.shape)}, params {n_params:,}")
        print(f"compile {compile_s:.2f}s, steady {steady_s * 1000:.2f}ms")
        print(result["memory"])
    return result
