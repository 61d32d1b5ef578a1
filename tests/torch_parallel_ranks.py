"""What each data-parallel rank runs, for `tests/test_torch_parallel.py`
and `chip_smoke.py` phase 10, started by `pointseg_torch.parallel.spawn`
(a rank imports this module by name). Imports torch and the port only,
never JAX.

`train_run(mesh, spec)` builds a model from a seed (or takes a given
`state_dict`), keeps this rank's rows of a global batch, takes
`spec["steps"]` train steps and returns what a comparison needs, on the
CPU: the first step's loss, gradients (summed over the ranks, before the
update), parameters and BatchNorm buffers after it, the FPS picks of the
first forward pass, the losses and parameters after the last step, and
the kernel launches. `room_run(mesh, spec)` returns the predictions of
one whole room by the streaming path with its window groups shared over
the mesh. On a mesh of one rank (`Mesh(device=...)`) both run the
one-process code, which is the reference.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from pointseg_torch.parallel import (Mesh, barrier, reduce_gradients, shard_batch, shard_state,
                                     spawn, use)
from pointseg_torch.parallel.mesh import COLLECTIVES

MODELS = {  # the models of the float32 and float64 steps: name -> (model kwargs, B, N)
    "PointNet++": ({}, 4, 256),
    "PointNet": ({}, 8, 64),  # the TNets' FC BatchNorm over 8 rows, 4 a rank
    "DeepGraphCnn": ({"k": 8, "emb_dims": 64}, 4, 256),
    "PointNeXt": ({}, 4, 256),
}


def blocks(B, N, seed=0, lengths=None):
    """A seeded global batch (points, one-hot labels, lengths); by default
    row 1 (rank 0's, on two ranks) ends in 30 points of padding."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    if lengths is None:
        lengths = np.full((B,), N, np.int32)
        lengths[1] = N - 30
    return x, y, np.asarray(lengths, np.int32)


def train_spec(name, **extra):
    """One SGD step (lr 1e-3) of MODELS[name] from seed 3 on `blocks`."""
    kwargs, B, N = MODELS[name]
    spec = dict(model=name, model_kwargs=kwargs, seed=3, batch=blocks(B, N),
                optimizer="sgd", lr=1e-3, steps=1)
    spec.update(extra)
    return spec


@contextlib.contextmanager
def recorded_fps(picks: list) -> Iterator[None]:
    """Appends the (B, C) indices of every FPS call in the block to
    `picks` (the selection the blocks call, `pointseg_torch.ops`)."""
    from pointseg_torch import ops

    plain = ops.farthest_point_sampling

    def record(*args, **kwargs):
        idx = plain(*args, **kwargs)
        picks.append(idx.cpu())
        return idx

    ops.farthest_point_sampling = record
    try:
        yield
    finally:
        ops.farthest_point_sampling = plain


def _optimizer(params, kind: str, lr: float):
    from pointseg_torch.train.state import make_optimizer

    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr)
    return make_optimizer(params, lr)


def _cpu(tensors) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors}


def train_run(mesh: Mesh, spec: dict) -> dict:
    """Train steps of `spec["model"]` on this rank's rows. `spec`:
    model, model_kwargs, seed (weights, dropout and FPS generator),
    state_dict (optional: overrides the seeded weights), batch (global
    numpy (points, labels, lengths); with accum K > 1 each has a leading
    K axis), optimizer ('sgd' or 'adam'), lr, steps, fps_random (False:
    every FPS starts at 0), accum, dtype (torch.float64 moves the model
    and the points to float64), timed (steps timed after the others; 0:
    none)."""
    from pointseg_torch.models import create_model
    from pointseg_torch.ops import _kernels
    from pointseg_torch.train.state import TrainState, train_step, train_step_accum

    device = mesh.device
    torch.manual_seed(spec["seed"])
    model = create_model(spec["model"], num_classes=14, **spec.get("model_kwargs", {}))
    if spec.get("state_dict") is not None:
        model.load_state_dict(spec["state_dict"])
    dtype = spec.get("dtype", torch.float32)  # float64: the model moved to it, as tests do
    model.to(device, dtype)
    generator = None
    if spec.get("fps_random", True):
        generator = torch.Generator(device=device)
        generator.manual_seed(spec["seed"])
    state = TrainState(model, _optimizer(model.parameters(), spec.get("optimizer", "sgd"),
                                         spec.get("lr", 1e-3)), generator)
    state = shard_state(mesh, state)
    accum = spec.get("accum", 1)
    batch = tuple(torch.from_numpy(np.asarray(a)) for a in spec["batch"])
    if accum > 1:  # (K, B, ...): this rank's rows of every micro-batch
        batch = tuple(a.transpose(0, 1) for a in shard_batch(mesh, tuple(
            a.transpose(0, 1) for a in batch)))
    else:
        batch = shard_batch(mesh, batch)
    points, labels, lengths = (a.contiguous().to(device) for a in batch)
    batch = (points.to(dtype), labels, lengths)
    step = train_step if accum == 1 else train_step_accum

    grads = {}

    def capture(*_):
        if not grads:
            grads.update(_cpu((k, p.grad) for k, p in model.named_parameters()
                              if p.grad is not None))

    hook = state.optimizer.register_step_pre_hook(capture)
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    picks: list = []
    with recorded_fps(picks):
        first = step(state, *batch)
    hook.remove()
    out = {"rank": mesh.rank, "loss": float(first["loss"]),
           "accuracy": float(first["accuracy"]), "miou": float(first["miou"]),
           "grads": grads, "params": _cpu(model.named_parameters()),
           "buffers": _cpu(model.named_buffers()), "fps": picks,
           "generator": None if generator is None else generator.get_state()}
    losses = [out["loss"]]
    for _ in range(spec.get("steps", 1) - 1):
        losses.append(float(step(state, *batch)["loss"]))
    out["losses"] = losses
    out["final_params"] = _cpu(model.named_parameters())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["launches"] = dict(_kernels.LAUNCHES)
    if spec.get("timed"):
        out.update(timed_steps(state, batch, step, spec["timed"]))
    return out


def train_runs(mesh: Mesh, specs: dict) -> dict:
    """`train_run` of every {name: spec}, in order of the names (every
    rank runs the same ones, so their collectives pair up)."""
    return {name: train_run(mesh, spec) for name, spec in sorted(specs.items())}


def timed_steps(state, batch, step, reps: int) -> dict:
    """On the card: ms a step (CUDA events around `reps` steps), the
    collectives a step and the host ms they held (`mesh.COLLECTIVES`),
    device ms a step (the profiler's kernel time over 3 steps, NCCL's
    kernels apart, since they hold the card while they wait for the other
    ranks; the window opens with a short spin kernel, left out, because
    the profiler can drop a window's first device event) and the peak
    allocated MiB of a step."""
    from torch.profiler import ProfilerActivity, profile

    device = state.device
    if device.type != "cuda":
        return {}
    step(state, *batch)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls, host_s = COLLECTIVES["calls"], COLLECTIVES["host_s"]
    start.record()
    for _ in range(reps):
        step(state, *batch)
    end.record()
    torch.cuda.synchronize(device)
    collectives = (COLLECTIVES["calls"] - calls) / reps
    collective_ms = (COLLECTIVES["host_s"] - host_s) * 1e3 / reps
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(3):
            step(state, *batch)
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and "spin_kernel" not in e.key]
    nccl_us = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower())
    device_us = sum(e.self_device_time_total for e in kernels) - nccl_us
    return {"step_ms": start.elapsed_time(end) / reps, "device_ms": device_us / 3e3,
            "nccl_ms": nccl_us / 3e3, "peak_mib": peak_mib, "collectives": collectives,
            "collective_ms": collective_ms}


def room_run(mesh: Mesh, spec: dict) -> dict:
    """One room's averaged logits, predictions and confidences by the
    streaming path (`utils/sliding_window.py`), window groups shared over
    `mesh`. `spec`: model, model_kwargs, seed, points ((N, 6) xyz + rgb),
    window_size, overlap, bn_stats."""
    from pointseg_torch.cli import whole_room_forward
    from pointseg_torch.models import create_model
    from pointseg_torch.utils import sliding_window as sw

    torch.manual_seed(spec["seed"])
    model = create_model(spec["model"], num_classes=14, **spec.get("model_kwargs", {}))
    model.to(mesh.device)
    forward = whole_room_forward(model, spec.get("bn_stats", "running"))
    points = np.asarray(spec["points"], np.float32)
    n, window, step = len(points), spec["window_size"], spec["window_size"] - spec["overlap"]
    buf = np.zeros((sw._room_pad(n, window, step), points.shape[1]), np.float32)
    buf[:n] = points
    avg = sw.scene_logits_device(forward, sw._to_device(buf, mesh.device), n, window, step, 14,
                                 mesh=mesh if mesh.world_size > 1 else None)[:n]
    preds, conf = sw._predictions(avg)
    return {"logits": avg.cpu(), "preds": preds.cpu().numpy(), "conf": conf.cpu().numpy()}


def batch_norm_f6(mesh: Mesh, spec: dict) -> dict:
    """The training BatchNorm on this rank's rows of the F6 input (mean far
    above the spread): output and input gradient of its rows, the running
    statistics and the parameter gradients summed over the ranks."""
    from pointseg_torch.nn.mlp import BatchNorm

    rows = mesh.rows(spec["x"].shape[0])
    x = torch.from_numpy(spec["x"][rows]).requires_grad_(True)
    dy = torch.from_numpy(spec["dy"][rows])
    bn = BatchNorm(x.shape[1]).train()
    bn.load_state_dict(spec["state"])
    with use(mesh):
        y = bn(x)
        (y * dy).sum().backward()
    reduce_gradients(bn, mesh)
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def edgeconv_f6(mesh: Mesh, spec: dict) -> dict:
    """The fused EdgeConv's training statistics in `spec["dtype"]` on this
    rank's rows of a given graph: its running statistics."""
    from pointseg_torch.nn import EdgeConv

    rows = mesh.rows(spec["x"].shape[0])
    x, idx = spec["x"][rows], spec["idx"][rows]
    block = EdgeConv(x.shape[-1], spec["out"], idx.shape[-1], dtype=spec["dtype"]).train()
    block.load_state_dict(spec["state"])
    with torch.no_grad(), use(mesh):
        block(torch.from_numpy(x), idx=torch.from_numpy(idx))
    return {"running_mean": block.bn.running_mean, "running_var": block.bn.running_var}


def checkpoints(mesh: Mesh, spec: dict) -> dict:
    """A data-parallel run that writes a checkpoint, and one that resumes a
    one-process checkpoint: each takes one SGD step of `spec["model"]` on
    its rows. Rank 0 writes `spec["write_to"]` after every rank has
    stepped; every rank restores `spec["read_from"]` and steps from it."""
    from pointseg_torch.io.checkpoint import restore_train_state, save_checkpoint
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    def state_of(seed):
        torch.manual_seed(seed)
        model = create_model(spec["model"], num_classes=14, **spec["model_kwargs"])
        return create_train_state(model, device="cpu", seed=seed)

    batch = shard_batch(mesh, tuple(torch.from_numpy(a) for a in spec["batch"]))
    state = shard_state(mesh, state_of(spec["seed"]))
    train_step(state, *batch)
    barrier(mesh)
    if mesh.rank == 0:
        save_checkpoint(spec["write_to"], state)
    barrier(mesh)
    written = {k: v.clone() for k, v in state.model.state_dict().items()}
    resumed = shard_state(mesh, restore_train_state(spec["read_from"], state_of(1)))
    restored = {"step": resumed.step, "generator": resumed.generator.get_state(),
                "model": {k: v.clone() for k, v in resumed.model.state_dict().items()}}
    loss = float(train_step(resumed, *batch)["loss"])
    return {"written": written, "restored": restored, "resumed_loss": loss,
            "resumed_params": {k: v.detach().clone()
                               for k, v in resumed.model.named_parameters()}}


def fail_on_rank_one(mesh: Mesh) -> int:
    """Rank 1 raises before the collective that rank 0 waits in."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    barrier(mesh)
    return mesh.rank


TASKS = {"train": train_run, "room": room_run, "batch_norm_f6": batch_norm_f6,
         "edgeconv_f6": edgeconv_f6, "checkpoints": checkpoints}


def suite(mesh: Mesh, jobs: dict) -> dict:
    """Runs every job {name: (task, spec)} on this rank, in order of the
    names (every rank runs the same jobs, so their collectives pair up)."""
    torch.manual_seed(0)
    np.random.seed(0)
    return {name: TASKS[task](mesh, spec) for name, (task, spec) in sorted(jobs.items())}


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def float32_leaves() -> None:
    """Prints each parameter leaf whose two-rank float32 step lies more
    than 2e-5 from the one-process step (`train_spec`, as
    `tests/test_torch_parallel.py` runs it): that gap, the one-process
    step's own distance from its float64 step, the two-rank step's, their
    ratio, and how far the one-process step moves when its rows are put
    in the order (0, 2, 1, 3), which regroups every sum over the rows
    (dropout 0 and FPS from 0, so that the order changes nothing else)."""
    names = ["PointNet++", "DeepGraphCnn", "PointNeXt"]  # PointNet takes no dropout argument

    def fixed(name, **extra):
        return train_spec(name, fps_random=False,
                          model_kwargs=dict(MODELS[name][0], dropout=0.0), **extra)

    jobs = {f"f32 {name}": ("train", train_spec(name)) for name in MODELS}
    ranks = spawn(suite, 2, (jobs,), timeout=600, threads=2)
    for name in MODELS:
        one, two = train_run(Mesh(), train_spec(name)), ranks[0][f"f32 {name}"]
        one64 = train_run(Mesh(), train_spec(name, dtype=torch.float64))
        if name in names:
            base = fixed(name)
            order = np.array([0, 2, 1, 3])
            plain = train_run(Mesh(), base)["params"]
            moved = train_run(Mesh(), fixed(name, batch=tuple(a[order] for a in base["batch"])))
        for k, want in one["params"].items():
            gap = _max_abs(two["params"][k], want)
            if gap <= 2e-5:
                continue
            own = _max_abs(want, one64["params"][k])
            near = _max_abs(two["params"][k], one64["params"][k])
            regroup = (_max_abs(moved["params"][k], plain[k]) if name in names
                       else float("nan"))
            print(f"{name} {k}: two ranks {gap:.3g} from one process; one process {own:.3g} "
                  f"and two ranks {near:.3g} from float64 (ratio {near / own:.2f}); rows "
                  f"regrouped {regroup:.3g}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    float32_leaves()
