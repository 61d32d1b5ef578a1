"""Tensor parallelism over a mesh's model axis (port of
`pointseg/parallel/mesh.py::tensor_parallel_sharding`,
`sharded_param_fraction` and `shard_state_tp`).

The JAX package places each weight of a train state on a ('data',
'model') mesh and lets GSPMD insert the collectives. Here the placement is
the same rule on the same leaves, and the layers compute with their
shards by the Megatron pairing, with `all_reduce` alone (the one
collective, with `broadcast`, that gloo has for CUDA tensors):

- the rule (`tensor_parallel_sharding`) reads a JAX leaf's shape: a
  matrix splits its output channels (its last dim) where they are at
  least `min_size` and divide by the axis, else its input channels (dim
  -2) on the same terms; a vector (BatchNorm's scale, bias, mean and var,
  a Dense bias) splits where it is as long; everything else is
  replicated;
- the port's tensors are those leaves in other coordinates: a Linear's
  (out, in) weight is the transposed (in, out) kernel, so column-parallel
  splits its dim 0 and row-parallel its dim 1; a GroupedFirstLayer's
  `conv.0.weight` (h, 3 + D) joins two leaves, `w_rel` (3, h) and
  `w_feat` (D, h), each placed by the rule (`Placement`'s segments);
  `num_batches_tracked` has no leaf and stays whole;
- column-parallel: the input is used whole, the rank computes its output
  channels and they are all-gathered over the model axis; the backward
  keeps the rank's slice of the output gradient and sums the input
  gradient over the axis;
- row-parallel: the rank takes its input channels of the (whole) input,
  forms the partial product, which is summed over the axis, and the bias
  is added once; the backward of the slice all-gathers the input
  gradient, the backward of the sum is the identity;
- a split vector is all-gathered before use (its backward keeps the
  rank's slice); a running-statistics update writes the rank's slice.

So every activation is whole on every rank of a model line and each rank
of the line computes the same thing outside its shards: the global-batch
paths (`parallel/mesh.py`) reduce over the data axis alone, and gradients
are summed over the data axis only. A shard's gradient is its own.

`shard_state_tp(mesh, state)` makes the ranks of the world equal
(`shard_state` over every rank), then keeps each rank's shard of every
placed parameter, buffer and optimizer moment, and sets `state.mesh`.
`full_state_dict` gathers the whole tensors back under the one-process
keys (what `np.asarray` of a sharded `jax.Array` gives), and
`load_full_state_dict` re-shards them: `io/checkpoint.py` saves and
restores through them, so a checkpoint of a tensor-parallel run restores
in one process and the reverse.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
from torch import nn

from pointseg_torch.parallel.mesh import Mesh, all_gather, axis_all_reduce_, shard_state

MODEL_AXIS = "model"
MIN_SIZE = 128


def tensor_parallel_sharding(mesh: Mesh, x, axis: str = MODEL_AXIS,
                             min_size: int = MIN_SIZE) -> tuple:
    """The placement of one JAX leaf of shape `x` (a shape or anything with
    `.shape`) as a partition spec: a tuple of one entry a dim, `axis` on
    the split dim and None elsewhere; () for a replicated leaf (the
    `PartitionSpec` of the JAX rule, module docstring)."""
    shape = tuple(getattr(x, "shape", x))
    if axis not in mesh.axis_names:
        return ()
    tp = mesh.axis_size(axis)
    if len(shape) >= 2 and shape[-1] >= min_size and shape[-1] % tp == 0:
        return (None,) * (len(shape) - 1) + (axis,)
    if len(shape) >= 2 and shape[-2] >= min_size and shape[-2] % tp == 0:
        return (None,) * (len(shape) - 2) + (axis, None)
    if len(shape) == 1 and shape[0] >= min_size and shape[0] % tp == 0:
        return (axis,)
    return ()


@dataclass(frozen=True)
class Placement:
    """How a port tensor of `full_shape` is split over the model axis:
    along `dim`, the segments (start, length, split) in order, a split
    segment giving each rank its 1/tp of it, a whole one kept on every
    rank."""

    dim: int
    segments: tuple[tuple[int, int, bool], ...]
    full_shape: tuple[int, ...]

    def local(self, full: torch.Tensor, index: int, size: int) -> torch.Tensor:
        parts = []
        for start, length, split in self.segments:
            seg = full.narrow(self.dim, start, length)
            parts.append(seg.narrow(self.dim, index * length // size, length // size)
                         if split else seg)
        return torch.cat(parts, dim=self.dim)

    def whole(self, local: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
        """The full tensor from the ranks' shards (one all-gather)."""
        size = mesh.axis_size(axis)
        shards = all_gather(local.detach()[None], mesh, axis, 0)  # (tp, *local)
        parts, at = [], 0
        for _, length, split in self.segments:
            n = length // size if split else length
            pieces = shards.narrow(self.dim + 1, at, n)
            parts.append(torch.cat(pieces.unbind(0), dim=self.dim) if split else pieces[0])
            at += n
        return torch.cat(parts, dim=self.dim)


def _whole(dim: int, length: int, shape) -> Placement:
    return Placement(dim, ((0, length, True),), tuple(shape))


@dataclass(frozen=True)
class TPPlan:
    """A layer's tensor-parallel form: `mode` is 'column' or 'row' (a
    Linear), 'features_row' (a GroupedFirstLayer's first layer whose
    `w_feat` is row-parallel and `w_rel` whole) or 'vector' (a
    BatchNorm's split vectors), over `axis` of `mesh`."""

    mesh: Mesh
    axis: str
    mode: str

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)


# --- the differentiable collectives of the Megatron pairing ------------------------------

class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis (a
    whole input that each rank multiplies by its own output channels)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return axis_all_reduce_(grad.contiguous().clone(), ctx.plan.mesh, ctx.plan.axis), None


class _Gather(torch.autograd.Function):
    """All-gather of the ranks' equal shares along `dim`; the backward
    keeps the rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim, ctx.n = plan, dim, x.shape[dim]
        return all_gather(x, plan.mesh, plan.axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.plan.index * ctx.n, ctx.n), None, None


class _Sum(torch.autograd.Function):
    """Sum over the axis (partial products); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, plan):
        return axis_all_reduce_(x.contiguous().clone(), plan.mesh, plan.axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Slice(torch.autograd.Function):
    """The rank's share of a whole tensor along `dim`; the backward
    all-gathers the gradient, so the layers before see all of it."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        n = x.shape[dim] // plan.size
        return x.narrow(dim, plan.index * n, n)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.plan.mesh, ctx.plan.axis, ctx.dim), None, None


def sum_grad(x: torch.Tensor, plan: TPPlan) -> torch.Tensor:
    return _SumGrad.apply(x, plan)


def gather(x: torch.Tensor, plan: TPPlan, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, plan, dim % x.dim())


def reduce_sum(x: torch.Tensor, plan: TPPlan) -> torch.Tensor:
    return _Sum.apply(x, plan)


def take_share(x: torch.Tensor, plan: TPPlan, dim: int = -1) -> torch.Tensor:
    return _Slice.apply(x, plan, dim % x.dim())


# --- placing a model -----------------------------------------------------------------------

def _linear_mode(out_features: int, in_features: int, mesh: Mesh, axis: str,
                 min_size: int) -> str | None:
    spec = tensor_parallel_sharding(mesh, (in_features, out_features), axis, min_size)
    return {(None, axis): "column", (axis, None): "row"}.get(spec)


def leaves(model: nn.Module) -> list[tuple[str, str, tuple[int, ...], str, tuple]]:
    """The JAX package's leaves of `model`, as the port holds them: (port
    state_dict key, collection 'params' or 'batch_stats', JAX leaf shape,
    its role ('kernel', 'bias', 'vector', 'w_rel', 'w_feat'), the port
    tensor's region (a slice a dim)). A Linear is a kernel (in, out) and a
    bias; a BatchNorm four vectors; a GroupedFirstLayer's first layer the
    two kernels `w_rel` (3, h) and `w_feat` (D, h) (column blocks of
    `conv.0.weight`) and `w_rel`'s bias."""
    from pointseg_torch.nn.blocks import GroupedFirstLayer
    from pointseg_torch.nn.mlp import BatchNorm, Linear

    firsts = {id(m.conv[0]) for m in model.modules() if isinstance(m, GroupedFirstLayer)}
    out = []
    for name, m in model.named_modules():
        key = f"{name}." if name else ""
        if isinstance(m, Linear) and id(m) in firsts:
            h, width = m.weight.shape
            out.append((f"{key}weight", "params", (3, h), "w_rel",
                        (slice(None), slice(0, 3))))
            out.append((f"{key}weight", "params", (width - 3, h), "w_feat",
                        (slice(None), slice(3, width))))
            out.append((f"{key}bias", "params", (h,), "bias", (slice(None),)))
        elif isinstance(m, Linear):
            o, i = m.weight.shape
            out.append((f"{key}weight", "params", (i, o), "kernel", (slice(None), slice(None))))
            if m.bias is not None:
                out.append((f"{key}bias", "params", (o,), "bias", (slice(None),)))
        elif isinstance(m, BatchNorm):
            c = m.num_features
            for tname, coll in (("weight", "params"), ("bias", "params"),
                                ("running_mean", "batch_stats"), ("running_var", "batch_stats")):
                out.append((f"{key}{tname}", coll, (c,), "vector", (slice(None),)))
    return out


def sharded_param_fraction(model: nn.Module | Mapping, mesh: Mesh, axis: str = MODEL_AXIS,
                           min_size: int = MIN_SIZE) -> float:
    """Fraction of the parameter ELEMENTS that `tensor_parallel_sharding`
    splits over `axis`, counted over the JAX package's parameter leaves
    (`leaves`: a GroupedFirstLayer's first weight as its two leaves; no
    running statistics), as the JAX function counts them. `model` may
    also be a mapping of leaves (shapes, or anything with `.shape`)."""
    if isinstance(model, Mapping):
        shapes = [tuple(getattr(v, "shape", v)) for v in model.values()]
    else:
        shapes = [shape for _, coll, shape, _, _ in leaves(model) if coll == "params"]
    total = sharded = 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        total += n
        if tensor_parallel_sharding(mesh, shape, axis, min_size):
            sharded += n
    return sharded / max(total, 1)


def plans(model: nn.Module, mesh: Mesh, axis: str = MODEL_AXIS,
          min_size: int = MIN_SIZE) -> dict[str, tuple[TPPlan, dict[str, Placement]]]:
    """{module name: (its plan, {tensor name: placement})} for every layer
    that the rule splits on `mesh` (none where the axis has one rank)."""
    from pointseg_torch.nn.blocks import GroupedFirstLayer
    from pointseg_torch.nn.mlp import BatchNorm, Linear

    if mesh.axis_size(axis) == 1:
        return {}
    firsts = {id(m.conv[0]) for m in model.modules() if isinstance(m, GroupedFirstLayer)}
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            o, i = m.weight.shape
            if id(m) in firsts:
                rel = tensor_parallel_sharding(mesh, (3, o), axis, min_size)
                feat = tensor_parallel_sharding(mesh, (i - 3, o), axis, min_size)
                if rel == (None, axis):  # both kernels column-parallel: dim 0 of the whole
                    mode = "column"
                elif feat == (axis, None):
                    mode = "features_row"
                else:
                    continue
            else:
                mode = _linear_mode(o, i, mesh, axis, min_size)
                if mode is None:
                    continue
            shape = tuple(m.weight.shape)
            placed = {"weight": (_whole(0, o, shape) if mode == "column" else
                                 _whole(1, i, shape) if mode == "row" else
                                 Placement(1, ((0, 3, False), (3, i - 3, True)), shape))}
            if m.bias is not None and mode == "column":
                placed["bias"] = _whole(0, o, (o,))
            out[name] = (TPPlan(mesh, axis, mode), placed)
        elif isinstance(m, BatchNorm):
            c = m.num_features
            if tensor_parallel_sharding(mesh, (c,), axis, min_size):
                out[name] = (TPPlan(mesh, axis, "vector"),
                             {t: _whole(0, c, (c,)) for t in
                              ("weight", "bias", "running_mean", "running_var")})
    return out


def shard_state_tp(mesh: Mesh, state, axis: str = MODEL_AXIS, min_size: int = MIN_SIZE):
    """DP x TP placement of a TrainState (port of `shard_state_tp`): every
    rank of the world takes rank 0's weights, buffers and generators
    (`shard_state` over the whole mesh), then each layer that the rule
    splits keeps the rank's shard of its weight, bias, BatchNorm vectors
    and their optimizer moments (Adam's `exp_avg` and `exp_avg_sq` follow
    their parameter, as optax's `mu` and `nu` do; the step count stays
    whole) and computes with it (module docstring). Sets `state.mesh`,
    whose data axis the train steps reduce over. A model axis of one rank
    places nothing: the data-parallel state."""
    state = shard_state(mesh.flat(), state)
    index, size = mesh.axis_index(axis) if axis in mesh.axis_names else 0, mesh.axis_size(axis)
    moments = state.optimizer.state
    with torch.no_grad():
        for name, (plan, placed) in plans(state.model, mesh, axis, min_size).items():
            module = state.model.get_submodule(name)
            for tname, placement in placed.items():
                t = getattr(module, tname)
                for key, value in list(moments.get(t, {}).items()):
                    if torch.is_tensor(value) and value.shape == t.shape:
                        moments[t][key] = placement.local(value, index, size).clone()
                t.data = placement.local(t.data, index, size).clone()
                t.tp_placement, t.tp_plan = placement, plan
            module.tp = plan
    state.mesh = mesh
    return state


def placed_tensors(model: nn.Module):
    """(key, tensor, placement or None) of every state_dict entry."""
    sd = model.state_dict(keep_vars=True)
    return [(k, t, getattr(t, "tp_placement", None)) for k, t in sd.items()]


def _plan_of(model: nn.Module) -> TPPlan | None:
    return next((m.tp for m in model.modules() if getattr(m, "tp", None) is not None), None)


def is_placed(model: nn.Module) -> bool:
    """True for a model that `shard_state_tp` split."""
    return _plan_of(model) is not None


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict with every shard replaced by the whole
    tensor, gathered over the model axis (a collective: every rank of the
    model line calls it), under the one-process keys. An entry that is
    not split is the model's own tensor, as `state_dict` gives it."""
    plan = _plan_of(model)
    out = {}
    for key, t, placement in placed_tensors(model):
        t = t.detach()
        out[key] = t if placement is None else placement.whole(t, plan.mesh, plan.axis)
    return out


def load_full_state_dict(model: nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """Loads whole tensors (a one-process state_dict) into a placed model,
    each shard taking its slice."""
    plan = _plan_of(model)
    with torch.no_grad():
        for key, t, placement in placed_tensors(model):
            value = sd[key].to(t.device, t.dtype)
            if placement is not None:
                value = placement.local(value, plan.index, plan.size)
            t.copy_(value)


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def full_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """The optimizer's state_dict with each placed parameter's moments
    gathered whole (a collective, as `full_state_dict`)."""
    plan = _plan_of(model)
    sd = optimizer.state_dict()
    for i, p in enumerate(_optimizer_tensors(optimizer)):
        placement = getattr(p, "tp_placement", None)
        if placement is None or i not in sd["state"]:
            continue
        sd["state"][i] = {k: (placement.whole(v, plan.mesh, plan.axis)
                              if torch.is_tensor(v) and v.shape == p.shape else v)
                          for k, v in sd["state"][i].items()}
    return sd


def shard_optimizer_state_(optimizer: torch.optim.Optimizer, model: nn.Module) -> None:
    """After `load_state_dict` of whole moments: each placed parameter's
    moments cut to its shard."""
    plan = _plan_of(model)
    for p in _optimizer_tensors(optimizer):
        placement = getattr(p, "tp_placement", None)
        state = optimizer.state.get(p, {})
        if placement is None:
            continue
        for k, v in list(state.items()):
            if torch.is_tensor(v) and tuple(v.shape) == placement.full_shape:
                state[k] = placement.local(v, plan.index, plan.size).clone()


def full_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """Every state_dict entry's one-process shape."""
    return {k: placement.full_shape if placement is not None else tuple(t.shape)
            for k, t, placement in placed_tensors(model)}


def global_sq_norm(grads: list[torch.Tensor], owners: list) -> torch.Tensor:
    """sum |g|^2 over whole tensors, `owners[i]` the parameter of
    `grads[i]`: a placed leaf's squares are summed over its model axis
    (each element counted once), a whole leaf's are taken once."""
    whole = [g for g, p in zip(grads, owners) if getattr(p, "tp_plan", None) is None]
    split = [(g, p.tp_plan) for g, p in zip(grads, owners)
             if getattr(p, "tp_plan", None) is not None]
    total = torch.stack([g.square().sum() for g in whole]).sum() if whole else None
    if split:
        plan = split[0][1]
        part = torch.stack([g.square().sum() for g, _ in split]).sum()
        part = axis_all_reduce_(part.clone(), plan.mesh, plan.axis)
        total = part if total is None else total + part
    return total
