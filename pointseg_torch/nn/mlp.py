"""Shared point-MLP stacks (port of `pointseg/nn/mlp.py`).

Channels-last: each "1x1 conv" is an `nn.Linear` over the last axis, and
BatchNorm normalises over every other axis, for (B, N, F) per-point and
(B, C, K, F) per-neighbour input alike.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over all axes but the last, updating its running
    statistics as flax.linen.BatchNorm does.

    Momentum 0.1 and eps 1e-5 are flax's momentum 0.9 and eps 1e-5
    (`pointseg/nn/mlp.py`). The one deliberate difference from
    `nn.BatchNorm1d`: torch folds the UNBIASED batch variance
    (factor n/(n-1)) into `running_var`, flax the biased one. This
    module folds the biased one, so a training step leaves the same
    running statistics as the JAX package's. The forward pass itself
    normalises with the biased variance in both.

    The state_dict keys are `nn.BatchNorm1d`'s (weight, bias,
    running_mean, running_var, num_batches_tracked).
    """

    # Set by `train/state.py::bn_adapted_model` for the length of its
    # forward: batch statistics at evaluation, where no gradient is taken.
    adapting = False

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape(-1, x.shape[-1])
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(rows, dim=0, correction=0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
            if self.adapting:
                # normalise with the statistics just taken, which var_mean
                # gets nearer to float64 than the CPU's training-mode
                # batch_norm does (tests/test_torch_eval.py, ROADMAP.md F6)
                y = F.batch_norm(rows, mean, var, self.weight, self.bias,
                                 training=False, eps=self.eps)
            else:
                y = F.batch_norm(rows, None, None, self.weight, self.bias,
                                 training=True, eps=self.eps)
        else:
            y = F.batch_norm(rows, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False, eps=self.eps)
        return y.reshape(x.shape)


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the DGCNN activation."""
    return F.leaky_relu(x, negative_slope=0.2)


class SharedMLP(nn.Module):
    """Stack of [Linear -> BatchNorm -> activation] applied per point.

    `act` defaults to ReLU and `use_bias` to True, as in the reference's
    PointNet++ MLPs; its DGCNN convolutions are bias-free with
    `leaky_relu_02`. The submodules are named `conv.i` and `batch.i`, the
    key layout of the reference's torch MLPs that
    `pointseg/io/torch_import.py` reads.
    """

    def __init__(self, in_features: int, widths: Sequence[int],
                 act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 use_bias: bool = True):
        super().__init__()
        self.act = act
        self.conv = nn.ModuleList()
        self.batch = nn.ModuleList()
        for width in widths:
            self.conv.append(nn.Linear(in_features, width, bias=use_bias))
            self.batch.append(BatchNorm(width))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.conv, self.batch):
            x = self.act(bn(conv(x)))
        return x
