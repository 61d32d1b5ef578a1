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

`make_optimizer` is Adam with optax's cosine and warmup-cosine rate
schedules and global-norm clipping; every update takes its rate from
`TrainState.step`. `make_eval_step(model, "batch")` evaluates with
batch BatchNorm statistics (`bn_adapted_model`), leaving the running
ones untouched.

Dropout draws from torch's default generator (seed it with
`torch.manual_seed`); FPS draws from `TrainState.generator`.

Under a profiler a train step is the span `pointseg_torch.step#<n>`
(`n` = `TrainState.step` before the update) holding its forward,
backward, update and metrics spans (`pointseg_torch/utils/trace.py`).

On the card `train_step` launches the step from Python once for each
shape of batch: it captures the whole step (forward, loss, backward,
clip, Adam, the BatchNorm running statistics, the batch metrics) into a
CUDA graph and replays it on every later batch of that shape, the same
kernels in the same order from one launch. It runs eagerly wherever a
replay would be wrong and the step can see it (`_graph_blocked`);
`STEP_GRAPHS` counts each kind of step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch
from torch import nn
from torch.optim import optimizer as optim_module

from pointseg_torch.parallel.mesh import Mesh, global_totals, reduce_gradients, use
from pointseg_torch.parallel.tensor_parallel import global_sq_norm
from pointseg_torch.train import metrics as M
from pointseg_torch.train.loss import masked_onehot_cross_entropy
from pointseg_torch.utils.trace import recording, span

# train steps by how they ran: "captured" (the step of a new batch shape,
# captured into a CUDA graph and then replayed once), "replayed" (one
# launch of a captured step) and "eager" (launched op by op from Python)
STEP_GRAPHS = {"captured": 0, "replayed": 0, "eager": 0}
_warm = False  # an eager train step has run on the card in this process


class ScheduledAdam(torch.optim.Adam):
    """`optax.adam` under a learning-rate schedule, behind an optional
    `optax.clip_by_global_norm` (the chain of `pointseg/train/state.py::
    make_optimizer`), with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8), which are torch's.

    The rate of update t is the schedule at t, the count BEFORE the update
    (optax's count). `set_rate_and_clip(t)` sets it on every parameter
    group and clips the gradients; the train steps call it with
    `TrainState.step` just before `step()`, so a resumed run needs no
    scheduler state of its own: the step count carries it.

    A group of CUDA parameters runs torch's fused Adam, capturable: one
    multi-tensor kernel reading its step counts and its rate from float32
    tensors on the card, the rate filled by `set_rate`, so a captured step
    reads the rate set before its replay. A group of CPU parameters holds
    its rate as a float and runs torch's plain Adam.
    """

    def __init__(self, params: Iterable[nn.Parameter], learning_rate: float = 1e-3,
                 schedule: str = "constant", total_steps: int | None = None,
                 warmup_steps: int = 0, grad_clip: float | None = None):
        if schedule not in ("constant", "cosine", "warmup_cosine"):
            raise ValueError(f"unknown schedule '{schedule}'")
        warmup = warmup_steps if schedule == "warmup_cosine" else 0
        if schedule != "constant" and (total_steps or 0) <= warmup:
            raise ValueError(f"the {schedule} schedule needs total_steps > {warmup}, "
                             f"got {total_steps}")
        self.learning_rate = learning_rate
        self.schedule = schedule
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.grad_clip = grad_clip
        super().__init__(params, lr=self.rate(0))
        # torch warns once when a capturable group steps outside a capture;
        # the eager steps of `train_step` do so by design
        self._warned_capturable_if_run_uncaptured = True

    def rate(self, count: int) -> float:
        """The schedule at update `count`, in float32 as optax computes it:
        `cosine_decay_schedule(lr, total_steps)` or
        `warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)`."""
        f32 = np.float32
        lr = self.learning_rate
        if self.schedule == "constant":
            return lr
        if self.schedule == "warmup_cosine" and count < self.warmup_steps:
            # linear_schedule(0, lr, warmup): (0 - lr) * (1 - t / warmup) + lr
            frac = f32(1.0) - f32(count) / f32(self.warmup_steps)
            return float(f32(0.0 - lr) * frac + f32(lr))
        decay = self.total_steps
        if self.schedule == "warmup_cosine":
            count, decay = count - self.warmup_steps, decay - self.warmup_steps
        t = np.minimum(f32(count), f32(decay))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / f32(decay)))
        return float(f32(lr) * cosine)

    @torch.no_grad()
    def set_rate(self, count: int) -> None:
        """Sets the rate of update `count` on every parameter group: a
        float for CPU parameters, a fill of the group's rate tensor for
        CUDA ones. Where that tensor is missing or elsewhere (the first
        update, `load_state_dict`, a move), the group is made fused and
        capturable on its parameters' card, Adam's step counts moved there
        too."""
        rate = self.rate(count)
        for group in self.param_groups:
            device = group["params"][0].device if group["params"] else None
            if device is None or device.type != "cuda":
                group["lr"], group["capturable"], group["fused"] = rate, False, False
                continue
            lr = group["lr"]
            if (group["fused"] and group["capturable"] and isinstance(lr, torch.Tensor)
                    and lr.device == device):
                lr.fill_(rate)
                continue
            group["lr"] = torch.tensor(rate, dtype=torch.float32, device=device)
            group["capturable"] = group["fused"] = True
            for p in group["params"]:
                held = self.state.get(p, {})
                if "step" in held:
                    held["step"] = held["step"].to(device, torch.float32)

    @torch.no_grad()
    def clip(self) -> None:
        """With `grad_clip`, clips the gradients by optax's rule: kept while
        their global norm is below the limit, else g / norm * limit (no
        host read)."""
        if self.grad_clip:
            params = [p for group in self.param_groups for p in group["params"]
                      if p.grad is not None]
            clip_by_global_norm_([p.grad for p in params], self.grad_clip, params)

    def set_rate_and_clip(self, count: int) -> None:
        """`set_rate(count)`, then `clip()`."""
        self.set_rate(count)
        self.clip()


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         params: list[torch.Tensor] | None = None) -> None:
    """`optax.clip_by_global_norm` in place: every tensor kept where the
    global norm sqrt(sum |g|^2) is below `max_norm`, else g / norm *
    max_norm. (`torch.nn.utils.clip_grad_norm_` multiplies by max_norm /
    (norm + 1e-6) and clips at equality, so it rounds otherwise.) With
    the gradients' `params`, the norm is over whole tensors where some are
    tensor-parallel shards (`parallel/tensor_parallel.py::global_sq_norm`)."""
    if not grads:
        return
    if params is not None and any(getattr(p, "tp_plan", None) is not None for p in params):
        norm = global_sq_norm(grads, params).sqrt()
    else:
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_optimizer(params: Iterable[nn.Parameter], learning_rate: float = 1e-3,
                   schedule: str = "constant", total_steps: int | None = None,
                   warmup_steps: int = 0, grad_clip: float | None = None) -> ScheduledAdam:
    """Adam with an optional rate schedule ('constant', 'cosine' or
    'warmup_cosine', which need `total_steps`) and global-norm gradient
    clipping, as `pointseg/train/state.py::make_optimizer` builds them.
    'constant' with no clip is the reference's fixed-rate Adam."""
    return ScheduledAdam(params, learning_rate, schedule, total_steps, warmup_steps, grad_clip)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator | None  # FPS starts in training; None starts at 0
    step: int = 0
    mesh: Mesh | None = None  # data-parallel group (`parallel.shard_state`); None: one process
    graphs: _StepGraphs = field(default_factory=lambda: _StepGraphs(), repr=False,
                                compare=False)  # `train_step`'s captured steps

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: nn.Module, *, device: torch.device | str,
                       learning_rate: float = 1e-3, seed: int = 0, schedule: str = "constant",
                       total_steps: int | None = None, warmup_steps: int = 0,
                       grad_clip: float | None = None) -> TrainState:
    """Moves `model` to `device` and pairs it with Adam (`make_optimizer`'s
    schedule and clip) and a seeded FPS generator on the same device."""
    device = torch.device(device)
    model.to(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    optimizer = make_optimizer(model.parameters(), learning_rate, schedule, total_steps,
                               warmup_steps, grad_clip)
    return TrainState(model, optimizer, generator)


def _apply_update(state: TrainState, set_rate: bool = True) -> None:
    """Optimizer update number `state.step` from the gradients in place:
    the schedule's rate (unless a captured step reads the rate set before
    its replay) and the clip first where the optimizer is
    `make_optimizer`'s. `state.step` is the caller's to advance."""
    if isinstance(state.optimizer, ScheduledAdam):
        if set_rate:
            state.optimizer.set_rate_and_clip(state.step)
        else:
            state.optimizer.clip()
    state.optimizer.step()


@torch.no_grad()
def _batch_metrics(loss, logits, labels, lengths, mesh: Mesh | None):
    """(loss, accuracy, mIoU) of the batch; on a data-parallel mesh of the
    global batch, from the ranks' loss shares and accuracy and IoU totals
    summed in one all_reduce."""
    if mesh is None or mesh.world_size == 1:
        accuracy = M.overall_accuracy(logits, labels, lengths)
        miou, _ = M.intersection_over_union(logits, labels, lengths)
        return loss.detach(), accuracy, miou
    correct, total = M.update_accuracy(logits, labels, lengths)
    inter, union = M.update_intersection_over_union(logits, labels, lengths)
    loss, correct, total, inter, union = global_totals(
        [loss.detach(), correct, total, inter, union], mesh)
    miou, _ = M.iou_from_totals(inter, union)
    return loss, correct / total.clamp_min(1), miou


def _step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
          lengths: torch.Tensor, set_rate: bool = True):
    """The train step's work, eager or under capture: (logits, (loss,
    accuracy, miou)). Leaves `state.step` as it was."""
    state.model.train()
    with span("pointseg_torch.step.forward"):
        logits = state.model(points, generator=state.generator)
        loss = masked_onehot_cross_entropy(logits, labels, lengths)
    with span("pointseg_torch.step.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("pointseg_torch.step.update"):
        reduce_gradients(state.model, state.mesh)
        _apply_update(state, set_rate)
    with span("pointseg_torch.step.metrics"):
        return logits, _batch_metrics(loss, logits, labels, lengths, state.mesh)


def _hooked(modules, optimizer) -> bool:
    """Whether a forward or backward hook of any of `modules`, a global
    module hook, or a step hook of `optimizer` or of every optimizer
    would run in a train step."""
    g, o = nn.modules.module, optim_module
    if (g._global_forward_hooks or g._global_forward_pre_hooks or g._global_backward_hooks
            or g._global_backward_pre_hooks or o._global_optimizer_pre_hooks
            or o._global_optimizer_post_hooks or optimizer._optimizer_step_pre_hooks
            or optimizer._optimizer_step_post_hooks):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in modules)


class _StepGraph:
    """One train step captured for one shape of batch: the graph, the
    static inputs it reads, the outputs (the logits too) and gradients it
    writes."""

    def __init__(self, state: TrainState, batch: tuple[torch.Tensor, ...], pool):
        self.inputs = tuple(t.clone() for t in batch)  # outside the pool: never reused
        self.graph = torch.cuda.CUDAGraph()
        if state.generator is not None:
            self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph, pool=pool):
            self.logits, self.outputs = _step(state, *self.inputs, set_rate=False)
        self.params = [p for g in state.optimizer.param_groups for p in g["params"]]
        self.grads = [p.grad for p in self.params]

    def run(self, state: TrainState, batch: tuple[torch.Tensor, ...]) -> dict:
        for static, t in zip(self.inputs, batch):
            static.copy_(t)
        state.optimizer.set_rate(state.step)
        self.graph.replay()
        for p, grad in zip(self.params, self.grads):  # `.grad` as an eager step leaves it
            if p.grad is not grad:
                p.grad = grad
        loss, accuracy, miou = (t.clone() for t in self.outputs)
        return {"loss": loss, "accuracy": accuracy, "miou": miou}


class _StepGraphs:
    """A train state's captured steps, keyed by the batch's shapes and
    dtypes (and the TF32 switches that chose their GEMMs), sharing one
    memory pool: steps never overlap. They hold the state's tensors by
    address, so they are dropped whenever those change (another
    optimizer or optimizer state, `load_state_dict`, a rate tensor
    remade, parameters moved): `refresh`."""

    def __init__(self):
        self.by_key: dict = {}
        self.held: tuple = ()
        self.addresses: tuple = ()
        self.modules: list = []
        self.pool = None

    def refresh(self, state: TrainState) -> None:
        opt = state.optimizer
        held = (state.model, opt, opt.state, opt.param_groups, state.generator,
                *(g["lr"] for g in opt.param_groups))
        addresses = tuple(p.data_ptr() for g in opt.param_groups for p in g["params"])
        if (addresses != self.addresses or len(held) != len(self.held)
                or any(a is not b for a, b in zip(held, self.held))):
            self.by_key, self.held, self.addresses = {}, held, addresses
            self.modules, self.pool = list(state.model.modules()), None

    def run(self, state: TrainState, batch: tuple[torch.Tensor, ...]) -> dict:
        """The step as a replay of the graph of `batch`'s shapes, captured
        first where there is none."""
        key = (*((t.shape, t.dtype, t.device) for t in batch),
               torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        graph = self.by_key.get(key)
        if graph is None:
            STEP_GRAPHS["captured"] += 1
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = self.by_key[key] = _StepGraph(state, batch, self.pool)
        else:
            STEP_GRAPHS["replayed"] += 1
        return graph.run(state, batch)


def _graph_blocked(state: TrainState, points: torch.Tensor) -> bool:
    """Whether this step runs eagerly: where a replay would differ from
    launching it or cannot be made. CPU tensors; a data-parallel mesh
    (its collectives are not captured); an optimizer that is not
    `make_optimizer`'s (no rate tensor, not capturable); a profiler
    recording (its spans and op ranges see launches only); before the
    process's first eager step on the card (cuBLAS handles, autograd's
    device threads) or the optimizer's first update (Adam's state is made
    then); a hook on a module or on the optimizer's step (a replay skips
    it)."""
    if (not points.is_cuda or state.mesh is not None
            or not isinstance(state.optimizer, ScheduledAdam) or recording()
            or not _warm or not state.optimizer.state):
        return True
    state.graphs.refresh(state)
    return _hooked(state.graphs.modules, state.optimizer)


def train_step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
               lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """One optimisation step + train-batch metrics {loss, accuracy, miou}.

    On a data-parallel `state.mesh` the batch is this rank's rows of the
    global batch; the step computes what one process computes on the
    global batch (`parallel/mesh.py`): the gradients are summed over the
    ranks before the update and the metrics are the global batch's.

    On the card, past `_graph_blocked`, the step is a replay of the
    state's graph for this batch's shapes (captured on the first such
    batch): the same draws from the FPS and dropout generators, the same
    `.grad` and state afterwards as an eager step, and the returned
    metrics are copies, not the graph's buffers."""
    global _warm
    batch = (points, labels, lengths)
    with use(state.mesh), span("pointseg_torch.step", state.step):
        if _graph_blocked(state, points):
            STEP_GRAPHS["eager"] += 1
            _, (loss, accuracy, miou) = _step(state, *batch)
            out = {"loss": loss, "accuracy": accuracy, "miou": miou}
            _warm = _warm or points.is_cuda
        else:
            out = state.graphs.run(state, batch)
    state.step += 1
    return out


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

    On a data-parallel `state.mesh` each micro-batch is this rank's rows
    of a global micro-batch, with global BatchNorm statistics, loss count
    and metrics, and the gradients are summed over the ranks once, after
    the K backward passes.
    """
    k = points.shape[0]
    sums = None
    with use(state.mesh), span("pointseg_torch.step", state.step):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        for i in range(k):
            with span("pointseg_torch.step.forward"):
                logits = state.model(points[i], generator=state.generator)
                loss = masked_onehot_cross_entropy(logits, labels[i], lengths[i])
            with span("pointseg_torch.step.backward"):
                (loss / k).backward()
            with span("pointseg_torch.step.metrics"):
                micro = torch.stack(_batch_metrics(loss, logits, labels[i], lengths[i],
                                                   state.mesh))
                sums = micro if sums is None else sums + micro
        with span("pointseg_torch.step.update"):
            reduce_gradients(state.model, state.mesh)
            _apply_update(state)  # the clip, if any, sees the mean gradient
    state.step += 1
    loss, accuracy, miou = (sums / k).unbind(0)
    return {"loss": loss, "accuracy": accuracy, "miou": miou}


def _eval_outputs(logits, labels, lengths) -> dict[str, torch.Tensor]:
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


@torch.no_grad()
def eval_step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
              lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """Loss + streaming metric contributions for one eval batch."""
    state.model.eval()
    return _eval_outputs(state.model(points), labels, lengths)


class bn_adapted_model:  # noqa: N801  (the JAX package's name)
    """`model` for test-time BatchNorm adaptation: calling it runs the
    forward pass with every BatchNorm normalising with the statistics of
    the batch at hand (training mode, the `var_mean` statistics of a
    training forward), every other module in eval mode (dropout off; an
    EdgeConv follows its BatchNorm), no FPS generator (every start at 0)
    and no gradient, and then puts back each module's mode and every
    BatchNorm's running statistics and `num_batches_tracked` exactly as
    they were. The JAX
    package runs `train=True` with dropout 0 and throws the mutated
    `batch_stats` away; the port's BatchNorm folds batch statistics into
    its buffers in place whenever it is in training mode, so they are
    copied before the forward and written back after it.

    Running-average BatchNorm is where a model trained on sampled blocks
    is sensitive to the point density of whole blocks at evaluation; the
    batch statistics are robust to it (`pointseg/train/state.py::
    bn_adapted_model`). An opt-in mode, not the parity default."""

    def __init__(self, model: nn.Module):
        self.model = model

    @torch.no_grad()
    def __call__(self, points: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        modes = [(m, m.training) for m in self.model.modules()]
        norms = [m for m in self.model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        saved = [[b.clone() for b in m.buffers(recurse=False)] for m in norms]
        self.model.eval()
        for m in norms:
            m.train()
        try:
            return self.model(points, mask=mask)
        finally:
            for m, buffers in zip(norms, saved):
                for b, old in zip(m.buffers(recurse=False), buffers):
                    b.copy_(old)
            for m, training in modes:
                m.training = training


def bn_batch_apply(model: nn.Module, points: torch.Tensor) -> torch.Tensor:
    """Forward with batch-statistics BatchNorm; the running statistics stay
    as they were (`bn_adapted_model`)."""
    return bn_adapted_model(model)(points)


def make_eval_step(model: nn.Module, bn_stats: str = "running"):
    """eval_step variant factory: 'running' (the parity default,
    `eval_step`) or 'batch' (test-time BatchNorm adaptation through
    `bn_adapted_model(model)`; `model` is the state's)."""
    if bn_stats == "running":
        return eval_step
    if bn_stats != "batch":
        raise ValueError("bn_stats must be 'running' or 'batch'")
    adapted = bn_adapted_model(model)

    def step(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
             lengths: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            return _eval_outputs(adapted(points), labels, lengths)

    return step
