"""Shared point-MLP stacks (port of `pointseg/nn/mlp.py`).

Channels-last: each "1x1 conv" is an `nn.Linear` over the last axis, and
BatchNorm normalises over every other axis, for (B, N, F) per-point and
(B, C, K, F) per-neighbour input alike.

Compute dtype. Every block takes `dtype`, flax's `dtype` attribute: the
dtype its activations are computed in, while its parameters stay float32.
`torch.bfloat16` casts each block's input, and each Linear's weight and
bias, to bfloat16 (flax `Dense`'s `promote_dtype`); BatchNorm takes its
statistics and normalises in float32 and returns bfloat16 (flax's
`BatchNorm(dtype=bfloat16)`). `torch.float32`, the default, casts
nothing, so a model moved to float64 with `.double()` computes in float64.

Tensor parallelism: a `Linear` or `BatchNorm` that
`parallel/tensor_parallel.py::shard_state_tp` split holds its shard and a
plan (`tp`); it computes with the shard by the Megatron pairing and
returns whole activations (that module's docstring). `tp` is None
otherwise, and nothing changes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointseg_torch.parallel import tensor_parallel as tp_ops
from pointseg_torch.parallel.mesh import active, all_reduce_


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` in a block's compute dtype: unchanged under float32 (the
    tensor's own dtype is kept), cast under bfloat16."""
    return x if dtype == torch.float32 else x.to(dtype)


class Linear(nn.Linear):
    """`nn.Linear` that computes in `dtype`: input, weight and bias are
    cast to it, as flax's `Dense(dtype=...)` casts them; the parameters,
    and so their gradients, stay float32. Same state_dict keys.

    Column-parallel (`tp.mode == 'column'`): the rank's output channels
    from the whole input, all-gathered over the model axis. Row-parallel
    ('row'): the rank's input channels' partial product, summed over the
    axis, then the (whole) bias. The shard is cast as the whole weight is."""

    tp = None  # the tensor-parallel plan (`parallel/tensor_parallel.py`), or None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else cast(self.bias, self.dtype)
        weight, x = cast(self.weight, self.dtype), cast(x, self.dtype)
        plan = self.tp
        if plan is None:
            return F.linear(x, weight, bias)
        if plan.mode == "column":
            return tp_ops.gather(F.linear(tp_ops.sum_grad(x, plan), weight, bias), plan)
        y = tp_ops.reduce_sum(F.linear(tp_ops.take_share(x, plan), weight), plan)
        return y if bias is None else y + bias


class _TrainNorm(torch.autograd.Function):
    """Training-mode BatchNorm of (rows, C) from the batch's own float32
    (or wider) statistics, `torch.var_mean` with no correction:
    y = (x - mean) * weight * rsqrt(var + eps) + bias, by `F.batch_norm`'s
    one elementwise pass given these statistics (float32 arithmetic for
    bfloat16 rows), returned in `out_dtype`. The gradient flows through the
    statistics: the backward is the closed form of a training-mode
    `F.batch_norm`'s (with x^ = (x - mean) * rstd,
    dx = weight * rstd * (dy - mean(dy) - x^ * mean(dy * x^)),
    dweight = sum(dy * x^), dbias = sum(dy)), by aten's fused batch-norm
    backward given these statistics. Saves the input rows and three
    vectors, as `F.batch_norm` does. The statistics come back too,
    detached, for the running averages.

    With a data-parallel `mesh` (`parallel/mesh.py`) the rows are one
    rank's share and the statistics are the global batch's, in two passes
    over `all_reduce`, as accurate as `var_mean` (F6): the sum and count
    give the mean, then each rank's sum of squared deviations from it the
    biased variance. The backward all-reduces sum(dy) and sum(dy * x^),
    the two reductions inside the fused backward, before its elementwise
    pass; dweight and dbias stay the rank's own sums, which the gradient
    reduction adds up."""

    @staticmethod
    def forward(ctx, rows, weight, bias, eps: float, out_dtype: torch.dtype, mesh=None):
        acc = torch.promote_types(rows.dtype, torch.float32)
        if mesh is None:
            var, mean = torch.var_mean(rows.to(acc), dim=0, correction=0)
        else:
            x = rows.to(acc)
            sums = torch.cat([x.sum(dim=0), x.new_full((1,), rows.shape[0])])
            sums = all_reduce_(sums, mesh)
            ctx.count = sums[-1]
            mean = sums[:-1] / ctx.count
            var = all_reduce_((x - mean).square().sum(dim=0), mesh) / ctx.count
        y = F.batch_norm(rows, mean, var, weight, bias, training=False, eps=eps)
        ctx.eps = eps
        ctx.mesh = mesh
        ctx.save_for_backward(rows, weight, mean, torch.rsqrt(var + eps))
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        rows, weight, mean, rstd = ctx.saved_tensors
        if ctx.mesh is None:
            dx, dweight, dbias = torch.ops.aten.native_batch_norm_backward(
                dy.to(rows.dtype), rows, weight, None, None, mean, rstd, True, ctx.eps,
                list(ctx.needs_input_grad[:3]))
            return dx, dweight, dbias, None, None, None
        dy = dy.to(mean.dtype)
        xhat = (rows.to(mean.dtype) - mean) * rstd
        local = torch.cat([dy.sum(dim=0), (dy * xhat).sum(dim=0)])
        dbias, dweight = local.clone().chunk(2)
        mean_dy, mean_dy_xhat = (all_reduce_(local, ctx.mesh) / ctx.count).chunk(2)
        dx = (weight * rstd) * (dy - mean_dy - xhat * mean_dy_xhat)
        return dx.to(rows.dtype), dweight, dbias, None, None, None


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over all axes but the last, with flax.linen.BatchNorm's
    statistics and running-average rule.

    Momentum 0.1 and eps 1e-5 are flax's momentum 0.9 and eps 1e-5
    (`pointseg/nn/mlp.py`). In training mode the module normalises with
    the batch's biased variance and mean from `torch.var_mean` in float32
    (or wider), the gradient flowing through them (`_TrainNorm`), and
    folds the same two, detached, into `running_mean` / `running_var`:
    the biased variance, as flax does, where `nn.BatchNorm1d` folds the
    unbiased one. One row normalises to `bias`, as flax's does (exactly on
    the card, whose elementwise pass centres first; within rounding on the
    CPU, whose pass folds the mean into the shift), where a training-mode
    `F.batch_norm` refuses a batch of one row. Inside a data-parallel step
    the statistics are the global batch's (`_TrainNorm`), and so are the
    running averages, the same on every rank. In eval mode it
    normalises with the running statistics. The output is in `dtype`
    (module docstring); the arithmetic is float32 either way.

    The state_dict keys are `nn.BatchNorm1d`'s (weight, bias,
    running_mean, running_var, num_batches_tracked).

    Split over a model axis (`tp`), the four vectors are all-gathered
    before use (one collective; the backward keeps the rank's slice of
    the gradient) and a running-statistics update writes the rank's slice.
    """

    tp = None  # the tensor-parallel plan (`parallel/tensor_parallel.py`), or None

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def whole(self, running: bool):
        """(weight, bias, running_mean, running_var) as whole vectors: the
        module's own, or gathered over the model axis where they are split
        (the running statistics only with `running`, else None)."""
        if self.tp is None:
            return self.weight, self.bias, self.running_mean, self.running_var
        parts = [self.weight, self.bias]
        if running:
            parts += [self.running_mean, self.running_var]
        out = tp_ops.gather(torch.stack(parts), self.tp).unbind(0)
        return (out[0], out[1], out[2].detach(), out[3].detach()) if running else (
            out[0], out[1], None, None)

    @torch.no_grad()
    def fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Folds a batch's (whole) statistics into the running ones."""
        if self.tp is not None:
            n = self.running_mean.shape[0]
            mean, var = (t.narrow(0, self.tp.index * n, n) for t in (mean, var))
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape(-1, x.shape[-1])
        acc = torch.promote_types(x.dtype, torch.float32)
        out_dtype = acc if self.dtype == torch.float32 else self.dtype
        weight, bias, running_mean, running_var = self.whole(not self.training)
        if self.training:
            y, mean, var = _TrainNorm.apply(rows, weight, bias, self.eps, out_dtype, active())
            self.fold(mean, var)
        else:
            y = F.batch_norm(rows, running_mean, running_var, weight, bias, training=False,
                             eps=self.eps).to(out_dtype)
        return y.reshape(x.shape)


class Dropout(nn.Dropout):
    """`nn.Dropout` whose mask, inside a data-parallel step
    (`parallel/mesh.py`), is drawn for the global batch, each rank keeping
    its rows: the rank's rows get the mask that one process draws for
    them, and torch's generator advances as in one process. Elsewhere it
    is `nn.Dropout`. The mask is drawn by the same call on a tensor of
    ones of the global shape, so it is the one-process mask on the CPU and
    on the card alike."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = active()
        if mesh is None or not self.training or self.p == 0.0:
            return super().forward(x)
        rows = x.shape[0] * mesh.world_size
        scale = F.dropout(x.new_ones((rows, *x.shape[1:])), self.p, training=True)
        return x * scale[mesh.rows(rows)]


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), the DGCNN activation."""
    return F.leaky_relu(x, negative_slope=0.2)


class SharedMLP(nn.Module):
    """Stack of [Linear -> BatchNorm -> activation] applied per point,
    its input cast to `dtype` first (flax's SharedMLP).

    `act` defaults to ReLU and `use_bias` to True, as in the reference's
    PointNet++ MLPs; its DGCNN convolutions are bias-free with
    `leaky_relu_02`. `last_act=False` ends the last layer at its
    BatchNorm. The submodules are named `conv.i` and `batch.i`, the
    key layout of the reference's torch MLPs that
    `pointseg/io/torch_import.py` reads.
    """

    def __init__(self, in_features: int, widths: Sequence[int],
                 act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 last_act: bool = True):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.last_act = last_act
        self.conv = nn.ModuleList()
        self.batch = nn.ModuleList()
        for width in widths:
            self.conv.append(Linear(in_features, width, bias=use_bias, dtype=dtype))
            self.batch.append(BatchNorm(width, dtype=dtype))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)
        for i, (conv, bn) in enumerate(zip(self.conv, self.batch)):
            x = bn(conv(x))
            if self.last_act or i < len(self.conv) - 1:
                x = self.act(x)
        return x
