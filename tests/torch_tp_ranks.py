"""What each rank of a two-axis mesh runs, for
`tests/test_torch_tensor_parallel.py` and `chip_smoke.py` phase 11,
started by `pointseg_torch.parallel.spawn` (a rank imports this module by
name). Imports torch and the port only, never JAX.

Every job builds its mesh from the world the ranks joined
(`create_mesh(..., axes=, shape=)`), once for each shape a run of jobs
asks for, in order of the job names, so that every rank makes the same
process groups in the same order. On a mesh of one rank (`Mesh(device=
...)`) every job runs the one-process code, which is the reference.

- `tp_train_run`: a train state placed by `shard_state_tp` on a (dp, tp)
  mesh takes `steps` steps on this rank's data rows; returns the first
  loss, the whole parameters and buffers after the first step
  (`full_state_dict`), the placements and the sharded fraction, the
  kernel launches and, on the card, the times of `timed` more steps;
- `points_run`: the point-sharded forward (`forward_points`) of one
  model on this rank's rows, with every selection it made;
- `store_run`: batches of a row-sharded device store, given the block
  ids and uniforms, and drawn from a seeded generator; `store_timing`:
  ms a sampled batch of a large packed table made on the device;
- `tp_checkpoint`: a placed run writes a checkpoint, and a placed state
  restores a one-process one;
- `hybrid_layout`: the mesh `create_hybrid_mesh` gives this rank.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

from pointseg_torch.parallel import (Mesh, axis_all_reduce_, barrier, create_hybrid_mesh,
                                     create_mesh, forward_points, full_state_dict, shard_batch, shard_points,
                                     shard_state_tp, sharded_param_fraction)
from pointseg_torch.parallel.mesh import COLLECTIVES
from pointseg_torch.parallel.tensor_parallel import placed_tensors

_MESHES: dict = {}


def two_axis_mesh(mesh: Mesh, shape: tuple[int, int], axes=("data", "model")) -> Mesh:
    """The (axes, shape) mesh over the ranks of `mesh`'s world, made once a
    process (a mesh of one rank for the one-process reference)."""
    if mesh.size == 1 and mesh.backend is None:
        return create_mesh(mesh.device, axes=axes, shape=(1,) * len(axes))
    key = (tuple(axes), tuple(shape))
    if key not in _MESHES:
        _MESHES[key] = create_mesh(mesh.device, axes=axes, shape=shape)
    return _MESHES[key]


def blocks(B, N, seed=0, lengths=None):
    """A seeded global batch (points, one-hot labels, lengths); row 1 ends
    in 30 points of padding."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    if lengths is None:
        lengths = np.full((B,), N, np.int32)
        lengths[1] = N - 30
    return x, y, np.asarray(lengths, np.int32)


@contextlib.contextmanager
def recorded(picks: dict) -> Iterator[None]:
    """Appends the indices of every FPS, ball query, 3-NN and kNN call in
    the block to `picks[kind]` (the selections the blocks call)."""
    import importlib

    from pointseg_torch import ops

    interpolate = importlib.import_module("pointseg_torch.ops.interpolate")
    saved = {}

    def wrap(owner, name, kind, first):
        plain = getattr(owner, name)
        saved[(owner, name)] = plain

        def call(*args, **kwargs):
            out = plain(*args, **kwargs)
            picks.setdefault(kind, []).append((out[first] if first is not None else out).cpu())
            return out

        setattr(owner, name, call)

    wrap(ops, "farthest_point_sampling", "fps", None)
    wrap(ops, "ball_query", "ball_query", 0)
    wrap(interpolate, "three_nn", "three_nn", 1)
    wrap(ops, "knn_indices", "knn", None)
    try:
        yield
    finally:
        for (owner, name), plain in saved.items():
            setattr(owner, name, plain)


def _model(spec: dict, device, dtype=torch.float32):
    from pointseg_torch.models import create_model

    torch.manual_seed(spec["seed"])
    model = create_model(spec["model"], num_classes=14, dtype=spec.get("compute", torch.float32),
                         **spec.get("model_kwargs", {}))
    if spec.get("state_dict") is not None:
        model.load_state_dict(spec["state_dict"])
    return model.to(device, dtype)


def _state(spec: dict, device, dtype):
    from pointseg_torch.train.state import TrainState, make_optimizer

    model = _model(spec, device, dtype)
    generator = None
    if spec.get("fps_random", True):
        generator = torch.Generator(device=device)
        generator.manual_seed(spec["seed"])
    if spec.get("optimizer", "sgd") == "sgd":
        optimizer = torch.optim.SGD(model.parameters(), lr=spec.get("lr", 1e-3))
    else:
        optimizer = make_optimizer(model.parameters(), spec.get("lr", 1e-3),
                                   grad_clip=spec.get("grad_clip"))
    return TrainState(model, optimizer, generator)


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def tp_train_run(mesh: Mesh, spec: dict) -> dict:
    """Train steps of a TP-placed state on this rank's rows. `spec`: model,
    model_kwargs, seed, state_dict (optional), shape (dp, tp), batch
    (global numpy (points, labels, lengths)), optimizer ('sgd' or
    'adam'), lr, grad_clip, steps, fps_random, dtype (float64 moves the
    model and points to it), compute (the models' compute dtype), timed
    (steps timed after the others, on the card)."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.train.state import train_step

    dtype = spec.get("dtype", torch.float32)
    m2 = two_axis_mesh(mesh, spec["shape"])
    state = _state(spec, m2.device, dtype)
    fraction = sharded_param_fraction(state.model, m2)
    state = shard_state_tp(m2, state)
    points, labels, lengths = (a.contiguous().to(m2.device) for a in shard_batch(
        m2, tuple(torch.from_numpy(np.asarray(a)) for a in spec["batch"])))
    batch = (points.to(dtype), labels, lengths)
    grads: dict = {}

    def capture(*_):  # the gradients the update takes (after any clip), whole
        if not grads:
            for k, t, placement in placed_tensors(state.model):
                g = getattr(t, "grad", None)
                if g is not None:
                    grads[k] = (g if placement is None else
                                placement.whole(g, m2, "model")).detach().cpu().clone()

    hook = state.optimizer.register_step_pre_hook(capture) if spec.get("grads") else None
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    picks: dict = {}
    with recorded(picks):
        first = train_step(state, *batch)
    if hook is not None:
        hook.remove()
    whole = full_state_dict(state.model)
    out = {"rank": m2.global_rank, "index": (m2.rank, m2.axis_index("model")),
           "loss": float(first["loss"]), "fraction": fraction,
           "state": _cpu(whole), "fps": picks.get("fps", []), "grads": grads,
           "placed": sorted(k for k, t in state.model.state_dict(keep_vars=True).items()
                            if getattr(t, "tp_placement", None) is not None),
           "local_shapes": {k: tuple(v.shape) for k, v in state.model.state_dict().items()},
           "param_keys": sorted(k for k, _ in state.model.named_parameters())}
    losses = [out["loss"]]
    for _ in range(spec.get("steps", 1) - 1):
        losses.append(float(train_step(state, *batch)["loss"]))
    out["losses"] = losses
    if m2.device.type == "cuda":
        torch.cuda.synchronize(m2.device)
    out["launches"] = dict(_kernels.LAUNCHES)
    if spec.get("timed"):
        from torch_parallel_ranks import timed_steps

        out.update(timed_steps(state, batch, train_step, spec["timed"]))
    return out


def points_run(mesh: Mesh, spec: dict) -> dict:
    """The eval-mode forward of `spec["model"]` on `spec["points"]` (B, N,
    9), this rank's rows over `spec["axis"]` of a `spec["shape"]` mesh
    (axes `spec["axes"]`), or the whole clouds on a mesh of one rank.
    Returns this rank's logits, every selection made (in call order) and
    the launches."""
    from pointseg_torch.ops import _kernels

    axes = tuple(spec.get("axes", ("data", "model")))
    m2 = two_axis_mesh(mesh, spec["shape"], axes)
    model = _model(spec, m2.device)
    x = torch.from_numpy(np.asarray(spec["points"])).to(m2.device)
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    picks: dict = {}
    with recorded(picks):
        if m2.size == 1:
            with torch.no_grad():
                logits = model.eval()(x)
        else:
            logits = forward_points(model, shard_points(m2, x, spec["axis"]), m2, spec["axis"])
    if m2.device.type == "cuda":
        torch.cuda.synchronize(m2.device)
    return {"logits": logits.cpu(), "picks": picks, "launches": dict(_kernels.LAUNCHES),
            "index": m2.axis_index(spec["axis"]) if m2.size > 1 else 0}


def store_run(mesh: Mesh, spec: dict) -> dict:
    """Batches of a device store (`spec["layout"]` 'flat' or 'compact')
    row-sharded over the data axis of `mesh`, or of the `spec["shape"]`
    mesh where it names one (whole on a mesh of one):
    `sample_from` of every (ids, u) of `spec["draws"]`, and `steps`
    batches of an epoch drawn from a generator seeded `spec["seed"]`.
    Also its resident bytes and launches."""
    from pointseg_torch.data.device import CompactDeviceStore, DeviceBlockStore
    from pointseg_torch.ops import _kernels

    cls = DeviceBlockStore if spec["layout"] == "flat" else CompactDeviceStore
    if spec.get("shape") is not None:  # over the data axis of a two-axis mesh
        mesh = two_axis_mesh(mesh, spec["shape"])
    store = cls(spec["points"], spec["labels"], spec["counts"], spec["num_classes"],
                device=mesh.device, mesh=mesh)
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    given = [tuple(t.cpu() for t in store.sample_from(
        torch.as_tensor(ids, device=mesh.device), torch.as_tensor(u, device=mesh.device)))
        for ids, u in spec["draws"]]
    generator = torch.Generator(device=mesh.device)
    generator.manual_seed(spec["seed"])
    order = store.epoch_order(generator, spec["batch_size"])
    drawn = [tuple(t.cpu() for t in store.sample(order, step, generator, spec["batch_size"],
                                                  spec["npoints"]))
             for step in range(spec["steps"])]
    return {"given": given, "drawn": drawn, "nbytes": store.nbytes,
            "launches": dict(_kernels.LAUNCHES)}


def packed_table(device, rows: int, block: int, seed: int):
    """A (rows, 4) int32 packed table made on `device` from `seed` (xyz
    bits of uniform coordinates, random rgb and label words), blocks of
    `block` points, their centers: the same on every rank."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    table = torch.empty((rows, 4), dtype=torch.int32, device=device)
    for start in range(0, rows, 1 << 24):  # in chunks: no table-sized temporary
        n = min(1 << 24, rows - start)
        table[start:start + n, :3] = (torch.rand((n, 3), generator=gen, device=device)
                                      * 30.0).view(torch.int32)
        table[start:start + n, 3] = torch.randint(0, 2**31 - 1, (n,), generator=gen,
                                                  device=device, dtype=torch.int32)
    counts = np.full(rows // block, block, np.int64)
    counts[-1] += rows - counts.sum()
    centers = torch.rand((len(counts), 3), generator=gen, device=device) * 30.0
    return table, centers, counts


def store_timing(mesh: Mesh, spec: dict) -> dict:
    """ms a sampled batch (`batch_size` x `npoints`) of a compact store over
    a `packed_table` of `rows` rows, row-sharded over the data axis of
    `mesh` (whole on a mesh of one): host clock around `reps` batches
    ending in a synchronise, after `warmup`; each rank's resident bytes
    and its kernel launches in the timed batches."""
    import time

    from pointseg_torch.data.device import CompactDeviceStore
    from pointseg_torch.ops import _kernels

    device = mesh.device
    table, centers, counts = packed_table(device, spec["rows"], spec["block"], spec["seed"])
    store = CompactDeviceStore.from_packed(table, centers, counts, 14, device=device, mesh=mesh)
    del table
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device)
    gen.manual_seed(spec["seed"])
    order = store.epoch_order(gen, spec["batch_size"])
    batches = order.shape[0] // spec["batch_size"]
    for step in range(spec["warmup"]):
        store.sample(order, step % batches, gen, spec["batch_size"], spec["npoints"])
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls, host_s = COLLECTIVES["calls"], COLLECTIVES["host_s"]
    t0 = time.perf_counter()
    for step in range(spec["reps"]):
        batch = store.sample(order, (spec["warmup"] + step) % batches, gen,
                             spec["batch_size"], spec["npoints"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {"ms": 1e3 * seconds / spec["reps"], "nbytes": store.nbytes,
            "launches": dict(_kernels.LAUNCHES), "rows": store.packed.shape[0],
            "collective_ms": 1e3 * (COLLECTIVES["host_s"] - host_s) / spec["reps"],
            "collectives": (COLLECTIVES["calls"] - calls) / spec["reps"],
            "finite": bool(torch.isfinite(batch[0][..., 3:6]).all())}


def tp_checkpoint(mesh: Mesh, spec: dict) -> dict:
    """A TP-placed run that writes a checkpoint after one step (the ranks of
    data rank 0 call `save_checkpoint`), and a TP-placed state that
    restores `spec["read_from"]` (a one-process checkpoint) and steps."""
    from pointseg_torch.io.checkpoint import restore_train_state, save_checkpoint
    from pointseg_torch.train.state import train_step

    m2 = two_axis_mesh(mesh, spec["shape"])
    batch = shard_batch(m2, tuple(torch.from_numpy(a) for a in spec["batch"]))
    state = shard_state_tp(m2, _state(spec, m2.device, torch.float32))
    train_step(state, *batch)
    whole = _cpu(full_state_dict(state.model))
    if m2.rank == 0:
        save_checkpoint(spec["write_to"], state)
    barrier(m2.flat())
    resumed = shard_state_tp(m2, _state(dict(spec, seed=1), m2.device, torch.float32))
    restore_train_state(spec["read_from"], resumed)
    restored = _cpu(full_state_dict(resumed.model))
    loss = float(train_step(resumed, *batch)["loss"])
    return {"written": whole, "restored": restored, "step": resumed.step,
            "resumed_loss": loss, "resumed": _cpu(full_state_dict(resumed.model))}


def hybrid_layout(mesh: Mesh, spec: dict) -> dict:
    """The mesh `create_hybrid_mesh` lays out over the joined world with
    `spec`'s overrides: its grid, this rank's index on each axis, and the
    members of each of its groups, checked by an all-reduce over each
    axis (the sum of the members' ranks)."""
    m = create_hybrid_mesh(mesh.device, axes=tuple(spec["axes"]),
                           process_count=spec["process_count"],
                           local_device_count=spec["local_device_count"])
    sums = {}
    for name in m.axis_names:
        t = torch.tensor([float(m.global_rank)], device=m.device)
        sums[name] = float(axis_all_reduce_(t, m, name))
    return {"grid": m.ranks(), "shape": m.shape, "index": {a: m.axis_index(a)
                                                           for a in m.axis_names},
            "members": {a.name: a.members for a in m.axes}, "sums": sums}


def tp_block_run(mesh: Mesh, spec: dict) -> dict:
    """A GroupedFirstLayer (`spec`: in_features, widths, radius, K, seed,
    and numpy centroids, coords, features, weights of the output) in
    float64, placed on a `spec["shape"]` mesh: its output and the
    gradients of sum(output x weights), whole (the input's, and each
    parameter's gathered over the model axis)."""
    from pointseg_torch.nn.blocks import GroupedFirstLayer
    from pointseg_torch.train.state import TrainState

    m2 = two_axis_mesh(mesh, spec["shape"])
    torch.manual_seed(spec["seed"])
    block = GroupedFirstLayer(spec["in_features"], spec["widths"], spec["radius"],
                              spec["K"]).double().train()
    state = shard_state_tp(m2, TrainState(block, torch.optim.SGD(block.parameters(), lr=0.0),
                                          None))
    centroids, coords, features, weights = (torch.from_numpy(spec[k]).double() for k in
                                            ("centroids", "coords", "features", "weights"))
    features.requires_grad_(True)
    out = state.model(centroids, coords, features)
    (out * weights).sum().backward()
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    whole = {}
    for k, t, placement in placed_tensors(state.model):
        if k in grads:
            whole[k] = (grads[k] if placement is None else
                        placement.whole(grads[k], m2, "model")).cpu()
    return {"out": out.detach().cpu(), "dfeatures": features.grad.cpu(), "grads": whole,
            "modes": {name: m.tp.mode for name, m in state.model.named_modules()
                      if getattr(m, "tp", None) is not None}}


TASKS = {"train": tp_train_run, "block": tp_block_run, "points": points_run, "store": store_run,
         "store_timing": store_timing,
         "checkpoint": tp_checkpoint, "hybrid": hybrid_layout}


def suite(mesh: Mesh, jobs: dict) -> dict:
    """Runs every job {name: (task, spec)} on this rank, in order of the
    names (every rank runs the same jobs, so their collectives and process
    groups pair up); returns {name: result}, and the collectives called."""
    torch.manual_seed(0)
    np.random.seed(0)
    out = {}
    for name, (task, spec) in sorted(jobs.items()):
        out[name] = TASKS[task](mesh, spec)
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    out["collectives"] = dict(COLLECTIVES)
    return out
