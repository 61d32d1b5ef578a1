"""Data parallelism over `torch.distributed` (port of the `data` axis of
`pointseg/parallel/mesh.py`).

The JAX package shards the batch axis of one SPMD program (GSPMD), which
leaves the result unchanged: BatchNorm statistics, the loss's mean and
the metrics stay reductions over the global batch, and XLA makes them
collectives. Here `n` processes (ranks) each hold a whole replica of
the model and rows [r B/n, (r+1) B/n) of every global batch of B rows,
and the code that would see a rank's rows as a batch of their own turns
to the global batch instead:

- the masked losses divide by the global batch's valid-point count
  (`train/loss.py`), so each rank's loss is its share of the global
  loss, and `reduce_gradients` sums the gradients over the ranks: the
  one-process gradient;
- BatchNorm's training statistics are the global batch's, and so are
  the two sums of its backward pass (`nn/mlp.py::_TrainNorm`,
  `nn/blocks.py::EdgeConv`);
- random draws are made for the global batch and each rank keeps its
  rows: FPS starts (`ops/fps.py`) and dropout masks
  (`nn/mlp.py::Dropout`), so the generators advance as in one process;
- the train step's accuracy and mIoU come from all-reduced totals
  (`train/state.py`).

These paths read the mesh from `active()`, which `use(mesh)` sets for a
train step or a sharded sliding-window pass (`utils/sliding_window.py`).
Outside it, and on a mesh of one rank, every one of them is the
one-process code unchanged: a data-parallel step on one rank is the
plain step.

Every collective is a sum `all_reduce` or a `broadcast`, the two that
gloo supports on CUDA tensors, so one code path serves NCCL, gloo on the
card (ranks that share a card: NCCL refuses two ranks on one device) and
gloo on the CPU. On a mesh of one rank no collective is called.

A mesh may have a second axis (`create_mesh(axes=("data", "model"),
shape=(dp, tp))`, or `("data", "points")`; `create_hybrid_mesh` lays one
out over nodes). `rank`, `world_size`, `group` and `rows()` stay those of
the data axis, so the global-batch paths above reduce over it alone;
tensor parallelism over the model axis is `parallel/tensor_parallel.py`,
the point-sharded forward `parallel/points.py`.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from pointseg_torch.utils.trace import span

# a collective that waits longer than this fails the run
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclass(frozen=True)
class Axis:
    """One axis of a mesh as one rank sees it: its name and size, the
    rank's index on it, the global ranks of the rank's line along it (its
    group's members, in axis order) and that group (None: the default
    group, for an axis that spans the world or has one rank)."""

    name: str
    size: int
    index: int
    members: tuple[int, ...]
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh. `rank`, `world_size` and `group` are
    those of the data axis (the data-parallel group: 'data' where the mesh
    has it, else none), so every global-batch path reduces over it alone;
    the backend ('nccl', 'gloo', or None on a mesh of one rank, which has
    no process group) and the rank's device. `axes` describes every axis
    (empty: the one 'data' axis of `world_size` ranks), and
    `grid` the global ranks in mesh order."""

    rank: int = 0
    world_size: int = 1
    backend: str | None = None
    device: torch.device = torch.device("cpu")
    group: Any = None
    axes: tuple[Axis, ...] = ()
    global_rank: int = 0
    grid: tuple = ()

    def _axes(self) -> tuple[Axis, ...]:
        return self.axes or (Axis("data", self.world_size, self.rank,
                                  tuple(range(self.world_size)), self.group),)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self._axes())

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order (the JAX `Mesh.shape`)."""
        return {a.name: a.size for a in self._axes()}

    @property
    def size(self) -> int:
        """The number of ranks in the mesh."""
        return int(np.prod([a.size for a in self._axes()]))

    def axis(self, name: str) -> Axis:
        for a in self._axes():
            if a.name == name:
                return a
        raise KeyError(f"the mesh has no axis {name!r} (axes {self.axis_names})")

    def axis_size(self, name: str) -> int:
        """The size of axis `name` (1 for an axis the mesh lacks)."""
        return self.axis(name).size if name in self.axis_names else 1

    def axis_index(self, name: str) -> int:
        """This rank's index on axis `name`."""
        return self.axis(name).index

    def axis_group(self, name: str):
        """The process group of this rank's line along axis `name`."""
        return self.axis(name).group

    def ranks(self) -> np.ndarray:
        """The global ranks laid out in the mesh's shape (JAX's
        `mesh.devices`)."""
        shape = tuple(a.size for a in self._axes())
        flat = self.grid or tuple(range(self.size))
        return np.asarray(flat, np.int64).reshape(shape)

    def rows(self, global_rows: int) -> slice:
        """This rank's share [r B/n, (r+1) B/n) of `global_rows` rows;
        raises unless the world size divides them."""
        if global_rows % self.world_size:
            raise ValueError(f"{global_rows} rows do not split over {self.world_size} ranks")
        per = global_rows // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def flat(self) -> "Mesh":
        """The one-axis 'data' mesh over every rank of this one, in
        global-rank order, on the default group (JAX's `create_mesh` of
        the same devices)."""
        n = self.size
        if n == 1:
            return Mesh(device=self.device)
        return Mesh(self.global_rank, n, self.backend, self.device, None,
                    global_rank=self.global_rank)


def backend_for(device_type: str, ranks_on_host: int, cards: int) -> str:
    """The backend rule: gloo on the CPU; on the card NCCL when every rank
    of the host has a card of its own, gloo when ranks share one."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if ranks_on_host <= cards else "gloo"


def under_torchrun() -> bool:
    """True in a process that `torchrun` started (RANK, WORLD_SIZE and
    LOCAL_RANK set)."""
    return all(name in os.environ for name in TORCHRUN_ENV)


def _join(device: torch.device, rank: int | None, world_size: int | None,
          store_path: str | None):
    """(global rank, world size, backend, device) of this process, joining
    the default process group where it has not been joined: through a
    `FileStore` at `store_path`, else under `torchrun` through its
    environment. None: one process with no group."""
    if dist.is_available() and dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return dist.get_rank(), dist.get_world_size(), dist.get_backend(), device
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore mesh needs rank and world_size")
        local_rank, local_world = rank, world_size
    elif under_torchrun():
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        return None
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        if cards == 0:
            raise RuntimeError("a data-parallel rank on the card found no CUDA device")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    backend = backend_for(device.type, local_world, cards)
    if world_size == 1:
        return 0, 1, None, device
    options = dict(backend=backend, rank=rank, world_size=world_size,
                   timeout=COLLECTIVE_TIMEOUT)
    if store_path is not None:
        dist.init_process_group(store=dist.FileStore(store_path, world_size), **options)
    else:
        dist.init_process_group(init_method="env://", **options)
    return rank, world_size, backend, device


def _mesh_from_grid(grid: np.ndarray, axes: tuple[str, ...], global_rank: int,
                    backend: str | None, device: torch.device, groups: bool) -> Mesh:
    """The mesh of `grid` (global ranks in mesh order) as `global_rank`
    sees it. With `groups`, one process group is made for every line of
    every axis that has more than one rank and fewer than all (every rank
    makes every group, in the same order: axis by axis, lines in C order);
    an axis that spans the world takes the default group."""
    if len(axes) != grid.ndim or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} do not name the {grid.ndim} axes of a {grid.shape} mesh")
    world = grid.size
    pos = tuple(int(i) for i in np.argwhere(grid == global_rank)[0])
    out = []
    for i, name in enumerate(axes):
        lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        mine = tuple(int(r) for r in grid[pos[:i] + (slice(None),) + pos[i + 1:]])
        group = None
        if groups and 1 < grid.shape[i] < world:
            for line in lines:
                g = dist.new_group([int(r) for r in line], backend=backend,
                                   timeout=COLLECTIVE_TIMEOUT)
                if global_rank in line:
                    group = g
        out.append(Axis(name, int(grid.shape[i]), pos[i], mine, group))
    data = next((a for a in out if a.name == "data"),
                Axis("data", 1, 0, (global_rank,), None))
    if world == 1:
        backend = None
    return Mesh(data.index, data.size, backend, device, data.group, tuple(out), global_rank,
                tuple(int(r) for r in grid.ravel()))


def create_mesh(device: torch.device | str = "cuda", *, axes: tuple[str, ...] = ("data",),
                shape: tuple[int, ...] | None = None, rank: int | None = None,
                world_size: int | None = None, store_path: str | None = None) -> Mesh:
    """This process's rank of a mesh over every rank of the world, joined:

    - where this process has joined a process group already (a rank that
      `parallel/launch.py::spawn` started, or a second mesh in one run),
      that group;
    - else through a `FileStore` at `store_path` as `rank` of `world_size`;
    - else under `torchrun`, through its environment (`env://`);
    - else as the one rank of a mesh of one, with no process group.

    `axes` names the mesh's axes and `shape` their sizes (default: every
    rank on the first axis), laid out as `np.arange(world).reshape(shape)`
    lays them out (JAX's `create_mesh` of `jax.devices()`): with
    ("data", "model") and (dp, tp), rank = data index x tp + model index.
    One process group is made per row and per column (`_mesh_from_grid`).

    The rank's device is `device` on the CPU and card LOCAL_RANK (modulo
    the cards there are) of `device`'s type on the card; the backend
    follows `backend_for`. Raises if the group cannot be joined; a
    collective that waits longer than `COLLECTIVE_TIMEOUT` fails."""
    device = torch.device(device)
    joined = _join(device, rank, world_size, store_path)
    global_rank, world, backend, device = joined or (0, 1, None, device)
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {int(np.prod(shape))} ranks, "
                         f"the world has {world}")
    if axes == ("data",):
        return (Mesh(device=device) if world == 1 else
                Mesh(global_rank, world, backend, device, None, global_rank=global_rank))
    grid = np.arange(world).reshape(shape)
    return _mesh_from_grid(grid, tuple(axes), global_rank, backend, device, groups=True)


def hybrid_grid(axes: tuple[str, ...] = ("data", "model"),
                ici_shape: tuple[int, ...] | None = None, dcn_axis: str = "data", *,
                process_count: int, local_device_count: int,
                ranks: list[int] | None = None) -> np.ndarray:
    """The global ranks of a multi-node mesh in mesh order: the layout of
    `pointseg/parallel/mesh.py::create_hybrid_mesh` (through
    `jax.experimental.mesh_utils.create_hybrid_device_mesh`), with a node
    for a JAX process and its local ranks for the process's devices.

    Each node's `local_device_count` ranks (rank // local_device_count
    names the node, as under `torchrun`) form an `ici_shape` grid in rank
    order; the nodes are laid out along `dcn_axis`, the one axis that
    crosses nodes, and the grids are joined block by block. `ici_shape`
    defaults to all local ranks on the first non-DCN axis (on the first
    axis with one node). One node is `create_mesh`'s layout of
    `ici_shape`."""
    ranks = list(range(process_count * local_device_count)) if ranks is None else list(ranks)
    if len(ranks) != process_count * local_device_count:
        raise ValueError(f"{len(ranks)} ranks for {process_count} nodes of "
                         f"{local_device_count}")
    if ici_shape is None:
        wide = (next((i for i, a in enumerate(axes) if a != dcn_axis), 0)
                if process_count > 1 else 0)
        ici_shape = tuple(local_device_count if i == wide else 1 for i in range(len(axes)))
    if process_count == 1:
        return np.asarray(ranks, np.int64).reshape(ici_shape)
    nodes: dict[int, list[int]] = {}
    for r in ranks:
        nodes.setdefault(r // local_device_count, []).append(r)
    per_node = [np.asarray(nodes[k], np.int64).reshape(ici_shape) for k in sorted(nodes)]
    dcn_shape = tuple(process_count if a == dcn_axis else 1 for a in axes)
    blocks = np.empty(dcn_shape, dtype=object)
    for i, idx in enumerate(np.ndindex(*dcn_shape)):
        blocks[idx] = per_node[i]
    return np.block(blocks.tolist())


def create_hybrid_mesh(device: torch.device | str = "cuda",
                       axes: tuple[str, ...] = ("data", "model"),
                       ici_shape: tuple[int, ...] | None = None, dcn_axis: str = "data", *,
                       process_count: int | None = None,
                       local_device_count: int | None = None,
                       ranks: list[int] | None = None, rank: int | None = None) -> Mesh:
    """Multi-node mesh (port of `pointseg/parallel/mesh.py::create_hybrid_mesh`):
    `dcn_axis` spans nodes, every other axis stays within a node, laid
    out by `hybrid_grid`. The data axis is the one whose collectives (a
    step's few reductions) tolerate the slower link between nodes; the
    model and point axes exchange activations every layer and stay on a
    node.

    The topology comes from the world this process has joined (or joins,
    as `create_mesh` does): under `torchrun` the nodes are WORLD_SIZE /
    LOCAL_WORLD_SIZE and a node's ranks its local ranks; ranks that
    `parallel.spawn` started are one node. `process_count`,
    `local_device_count` and `ranks` override it: where they describe
    another world than the joined one (a test driving two or three nodes
    in one process), the mesh is the layout alone, seen by global rank
    `rank` (default: the grid's first), with no process group (its
    collectives fail). One node is `create_mesh`'s
    mesh of `ici_shape`, as in the JAX package."""
    device = torch.device(device)
    joined = _join(device, None, None, None)
    global_rank, world, backend, device = joined or (0, 1, None, device)
    local = local_device_count or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = process_count or max(world // local, 1)
    grid = hybrid_grid(tuple(axes), ici_shape, dcn_axis, process_count=nodes,
                       local_device_count=local, ranks=ranks)
    if grid.size != world or (ranks is not None and sorted(ranks) != list(range(world))):
        seen = int(grid.ravel()[0]) if rank is None else rank
        return _mesh_from_grid(grid, tuple(axes), seen, None, device, groups=False)
    if nodes == 1:
        return create_mesh(device, axes=tuple(axes), shape=tuple(grid.shape))
    return _mesh_from_grid(grid, tuple(axes), global_rank, backend, device, groups=True)


def close_mesh(mesh: Mesh) -> None:
    """Leaves the process group that `create_mesh` joined (none on a mesh
    of one rank)."""
    if mesh.world_size > 1:
        dist.destroy_process_group(mesh.group)


_ACTIVE: Mesh | None = None


def active() -> Mesh | None:
    """The mesh of the data-parallel step running now, or None: outside a
    `use(mesh)` block, and on a mesh of one rank."""
    return _ACTIVE


@contextlib.contextmanager
def use(mesh: Mesh | None) -> Iterator[None]:
    """Makes `mesh` the active one for the block (None, or a mesh of one
    rank, makes none active)."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.world_size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = saved


# the collectives this process has called and the host seconds they held
# (gloo: the whole exchange, a CUDA tensor's copies included; NCCL: the enqueue)
COLLECTIVES = {"calls": 0, "host_s": 0.0}


def _all_reduce(t: torch.Tensor, group, size: int) -> torch.Tensor:
    if size > 1:
        t0 = time.perf_counter()
        with span("pointseg_torch.collective.all_reduce"):
            dist.all_reduce(t, group=group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["host_s"] += time.perf_counter() - t0
    return t


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sums `t` over the ranks of the data axis, in place, and returns it."""
    return _all_reduce(t, mesh.group, mesh.world_size)


def axis_all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sums `t` over this rank's line along mesh axis `axis`, in place."""
    a = mesh.axis(axis)
    return _all_reduce(t, a.group, a.size)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """The `t` of the data axis's rank `src` on every rank of the axis, in
    place; returns it."""
    if mesh.world_size > 1:
        t0 = time.perf_counter()
        with span("pointseg_torch.collective.broadcast"):
            dist.broadcast(t, src=mesh.axis("data").members[src], group=mesh.group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["host_s"] += time.perf_counter() - t0
    return t


# the integer type whose sum carries a dtype's bits through zeros exactly
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.int32: torch.int32,
         torch.int64: torch.int64}


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int,
               sizes: list[int] | None = None) -> torch.Tensor:
    """The ranks' `x` along mesh axis `axis`, joined along `dim` in axis
    order: each rank's share (`sizes[i]` rows along `dim` for the rank of
    index i; None: every rank's own size, equal) is written into its slot
    of a zero buffer and the buffer is summed over the axis, the one
    all-gather that `all_reduce` alone gives. The sum runs over the bits
    as integers (float32 as int32, float64 as int64; 16-bit floats and
    small integers widened exactly first), so every value comes back bit
    for bit, -0.0 and NaN payloads included. No gradient (see
    `parallel/tensor_parallel.py` for the differentiable forms)."""
    a = mesh.axis(axis)
    dim = dim % x.dim()
    if sizes is None:
        sizes = [x.shape[dim]] * a.size
    if x.shape[dim] != sizes[a.index]:
        raise ValueError(f"rank {a.index} holds {x.shape[dim]} rows, its share is {sizes[a.index]}")
    if a.size == 1:
        return x
    wide = x.dtype if x.dtype in _BITS else (
        torch.float32 if x.is_floating_point() else torch.int32)
    bits = x.detach().to(wide).contiguous().view(_BITS[wide])
    shape = list(x.shape)
    shape[dim] = sum(sizes)
    buf = bits.new_zeros(shape)
    buf.narrow(dim, sum(sizes[:a.index]), sizes[a.index]).copy_(bits)
    _all_reduce(buf, a.group, a.size)
    return buf.view(wide).to(x.dtype)


def barrier(mesh: Mesh | None) -> None:
    """Waits until every rank has come here (one all_reduce, read back)."""
    if mesh is not None and mesh.world_size > 1:
        float(all_reduce_(torch.ones((), device=mesh.device), mesh))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    gradients: each rank's loss share depends on the one global sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable (a new tensor)."""
    return _AllReduceSum.apply(t, mesh)


def shard_batch(mesh: Mesh, batch: tuple) -> tuple:
    """This rank's rows of every array of a global (points, labels,
    lengths, ...) batch, numpy arrays or tensors alike (views, no copy)."""
    return tuple(x[mesh.rows(x.shape[0])] for x in batch)


class ShardedLoader:
    """A loader of global batches seen through one rank: every rank walks
    the same seeded order of global batches and keeps its rows
    (`pointseg/cli.py`'s `_ShardedLoader`). It hides the loader's type, so
    a device-store loader under it takes no `--scan-steps` path, as in the
    JAX package.

    The host loader's reader threads (`--num-workers` > 1) draw each
    block's points in the order they arrive, in one process as in the JAX
    package; then each rank's rows hold the global batch's blocks with
    points of that rank's draw. With one reader (0 or 1), and from the
    device store, every rank's global batch is bit for bit the one that
    one process draws."""

    def __init__(self, loader, mesh: Mesh):
        self._loader = loader
        self.mesh = mesh

    def __len__(self) -> int:
        return len(self._loader)

    def __iter__(self):
        for batch in self._loader:
            with span("pointseg_torch.data.shard"):
                batch = shard_batch(self.mesh, batch)
            yield batch


def _broadcast_generator_state(state: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A generator's (CPU, uint8) state as rank 0 holds it."""
    return broadcast_(state.to(mesh.device), mesh).cpu()


def shard_state(mesh: Mesh, state: Any) -> Any:
    """Makes a TrainState data-parallel on `mesh` and returns it: rank 0's
    parameters, buffers, FPS generator state and torch's default
    generators (dropout) are broadcast to every rank, and `state.mesh` is
    set, which the train steps read. Gradients are reduced by the steps
    themselves (`reduce_gradients`), once an update; the model is not
    wrapped, so its `state_dict` keys stay the one-process ones. The
    optimizer's state is not broadcast: it is empty or restored from the
    same checkpoint on every rank."""
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(state.model.buffers()):
                broadcast_(t.data, mesh)
        if state.generator is not None:
            state.generator.set_state(_broadcast_generator_state(state.generator.get_state(),
                                                                 mesh))
        torch.set_rng_state(_broadcast_generator_state(torch.get_rng_state(), mesh))
        if mesh.device.type == "cuda":
            torch.cuda.set_rng_state(
                _broadcast_generator_state(torch.cuda.get_rng_state(mesh.device), mesh),
                mesh.device)
    state.mesh = mesh
    return state


def reduce_gradients(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Sums every parameter's gradient over the ranks, in one all_reduce
    of their concatenation (no call on a mesh of one rank)."""
    if mesh is None or mesh.world_size == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def global_totals(values: list[torch.Tensor], mesh: Mesh | None) -> list[torch.Tensor]:
    """`values` summed over the ranks in one float64 all_reduce (integer
    counts up to 2^53 stay exact), each back in its own dtype and shape."""
    if mesh is None or mesh.world_size == 1:
        return values
    flat = all_reduce_(torch.cat([v.reshape(-1).to(torch.float64) for v in values]), mesh)
    out, offset = [], 0
    for v in values:
        out.append(flat[offset:offset + v.numel()].view_as(v).to(v.dtype))
        offset += v.numel()
    return out


def refuse_indivisible(batch_size: int, mesh: Mesh) -> None:
    """The JAX package's refusal of a batch that the world size does not
    divide."""
    if batch_size % mesh.world_size != 0:
        raise SystemExit(f"--data-parallel needs train batch size divisible by "
                         f"{mesh.world_size} devices, got {batch_size}")
