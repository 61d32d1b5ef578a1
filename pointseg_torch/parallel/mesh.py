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

Left for later (ROADMAP.md M10): the hybrid multi-host mesh, tensor
parallelism, sharding the point axis and the device store's row-sharded
tables, which the JAX package expresses as GSPMD placements.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from dataclasses import dataclass
from typing import Any, Iterator

import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: its rank, the world
    size, the backend ('nccl', 'gloo', or None on a mesh of one rank,
    which has no process group), its device and the process group (None:
    the default group)."""

    rank: int = 0
    world_size: int = 1
    backend: str | None = None
    device: torch.device = torch.device("cpu")
    group: Any = None

    def rows(self, global_rows: int) -> slice:
        """This rank's share [r B/n, (r+1) B/n) of `global_rows` rows;
        raises unless the world size divides them."""
        if global_rows % self.world_size:
            raise ValueError(f"{global_rows} rows do not split over {self.world_size} ranks")
        per = global_rows // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)


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


def create_mesh(device: torch.device | str = "cuda", *, rank: int | None = None,
                world_size: int | None = None, store_path: str | None = None) -> Mesh:
    """This process's rank of a data-parallel group, joined:

    - through a `FileStore` at `store_path` as `rank` of `world_size`
      (the ranks that `parallel/launch.py::spawn` starts);
    - else under `torchrun`, through its environment (`env://`);
    - else as the one rank of a mesh of one, with no process group.

    The rank's device is `device` on the CPU and card LOCAL_RANK (modulo
    the cards there are) of `device`'s type on the card; the backend
    follows `backend_for`. Raises if the group cannot be joined; a
    collective that waits longer than `COLLECTIVE_TIMEOUT` fails."""
    device = torch.device(device)
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore mesh needs rank and world_size")
        local_rank, local_world = rank, world_size
    elif under_torchrun():
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        return Mesh(device=device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        if cards == 0:
            raise RuntimeError("a data-parallel rank on the card found no CUDA device")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    backend = backend_for(device.type, local_world, cards)
    if world_size == 1:
        return Mesh(device=device)
    options = dict(backend=backend, rank=rank, world_size=world_size,
                   timeout=COLLECTIVE_TIMEOUT)
    if store_path is not None:
        dist.init_process_group(store=dist.FileStore(store_path, world_size), **options)
    else:
        dist.init_process_group(init_method="env://", **options)
    return Mesh(rank, world_size, backend, device, None)


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


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sums `t` over the ranks, in place, and returns it."""
    if mesh.world_size > 1:
        t0 = time.perf_counter()
        dist.all_reduce(t, group=mesh.group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["host_s"] += time.perf_counter() - t0
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank, in place; returns it."""
    if mesh.world_size > 1:
        t0 = time.perf_counter()
        dist.broadcast(t, src=src, group=mesh.group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["host_s"] += time.perf_counter() - t0
    return t


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
            yield shard_batch(self.mesh, batch)


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
