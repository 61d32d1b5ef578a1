"""Train state and the train/eval steps (port of `pointseg/train/state.py`).

`train_step`: forward in train mode (batch BatchNorm statistics,
dropout, FPS starts drawn from the state's generator) -> masked
cross-entropy -> backward -> Adam, plus the train-batch accuracy and
mIoU. `eval_step`: forward in eval mode (running statistics, FPS from
index 0) -> loss and the streaming metric contributions. The model runs
unmasked in both, as in the JAX package; loss and metrics are
length-masked. `train_step_accum`: one optimizer update from K
micro-batches (gradient accumulation). None synchronises with the
device: every returned value is a tensor on the model's device.

Dropout draws from torch's default generator (seed it with
`torch.manual_seed`); FPS draws from `TrainState.generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch
from torch import nn

from pointseg_torch.train import metrics as M
from pointseg_torch.train.loss import masked_onehot_cross_entropy


def make_optimizer(params: Iterable[nn.Parameter], learning_rate: float = 1e-3,
                   schedule: str = "constant") -> torch.optim.Optimizer:
    """Constant-rate Adam with optax.adam's defaults (b1 0.9, b2 0.999,
    eps 1e-8), which are torch's. Other schedules are not ported yet."""
    if schedule != "constant":
        raise NotImplementedError(
            f"LR schedule {schedule!r} is not yet ported to pointseg_torch, see ROADMAP.md")
    return torch.optim.Adam(params, lr=learning_rate)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator | None  # FPS starts in training; None starts at 0
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: nn.Module, *, device: torch.device | str,
                       learning_rate: float = 1e-3, seed: int = 0) -> TrainState:
    """Moves `model` to `device` and pairs it with Adam and a seeded FPS
    generator on the same device."""
    device = torch.device(device)
    model.to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(model, make_optimizer(model.parameters(), learning_rate), generator)


def train_step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
               lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """One optimisation step + train-batch metrics {loss, accuracy, miou}."""
    state.model.train()
    logits = state.model(points, generator=state.generator)
    loss = masked_onehot_cross_entropy(logits, labels, lengths)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        accuracy = M.overall_accuracy(logits, labels, lengths)
        miou, _ = M.intersection_over_union(logits, labels, lengths)
    return {"loss": loss.detach(), "accuracy": accuracy, "miou": miou}


def train_step_accum(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
                     lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """ONE optimizer update from K micro-batches (gradient accumulation).

    Shapes carry a leading micro-batch axis: points (K, B, N, F),
    labels (K, B, N, C), lengths (K, B). Semantics, as in the JAX
    package:

    - the update uses the MEAN of the K micro-batch gradients, all taken
      at the same (pre-update) parameters: what one update on the
      concatenated (K*B)-sample batch computes, up to BatchNorm batch
      statistics (per micro-batch here) and float reassociation. Each
      micro-batch's loss is scaled by 1/K before its backward pass, so
      the gradients sum to the mean in place;
    - BatchNorm running statistics thread through the K forwards in
      order, as K consecutive un-stepped forwards leave them;
    - every micro-batch draws its own dropout masks and FPS starts (the
      generators advance from one forward to the next);
    - `state.step` advances by 1 (optimizer steps, not forwards).

    Why: an effective batch K*B at the peak memory of one micro-batch.
    Returned metrics are means over the micro-batches.
    """
    k = points.shape[0]
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    sums = None
    for i in range(k):
        logits = state.model(points[i], generator=state.generator)
        loss = masked_onehot_cross_entropy(logits, labels[i], lengths[i])
        (loss / k).backward()
        with torch.no_grad():
            accuracy = M.overall_accuracy(logits, labels[i], lengths[i])
            miou, _ = M.intersection_over_union(logits, labels[i], lengths[i])
            micro = torch.stack([loss.detach(), accuracy, miou])
        sums = micro if sums is None else sums + micro
    state.optimizer.step()
    state.step += 1
    loss, accuracy, miou = (sums / k).unbind(0)
    return {"loss": loss, "accuracy": accuracy, "miou": miou}


@torch.no_grad()
def eval_step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
              lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """Loss + streaming metric contributions for one eval batch."""
    state.model.eval()
    logits = state.model(points)
    correct, total = M.update_accuracy(logits, labels, lengths)
    inter, union = M.update_intersection_over_union(logits, labels, lengths)
    return {
        "loss": masked_onehot_cross_entropy(logits, labels, lengths),
        "correct": correct,
        "total": total,
        "intersections": inter,
        "unions": union,
        "confusion": M.confusion_matrix(logits, labels, lengths),
    }
