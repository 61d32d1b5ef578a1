"""The point-sharded forward (port of `jax.device_put(points,
NamedSharding(mesh, P(None, "data")))` followed by `model.apply(...,
train=False)`, `__graft_entry__.py::dryrun_multichip` and
`tests/test_parallel.py`).

Each rank of a mesh axis ('data' by default, or 'points' on a ('data',
'points') mesh) holds rows [r N/n, (r+1) N/n) of every cloud, (B, N/n, F),
and `forward_points` returns that rank's rows of the logits. The blocks
read `point_split()` inside `use_points(mesh)` (as the data-parallel
paths read `active()`), so every registry model gets it:

- per-row MLPs and heads run on the rank's own rows;
- global max-pools (PointNet's and its TNets') take the maximum over the
  ranks' maxima, all-gathered (`global_max`);
- `SetAbstraction` and `SetAbstractionMSG` all-gather the level's
  coordinates and features, run FPS on the whole cloud (every rank makes
  the same picks from the same start), take the rank's share of the
  centroids, ball-query them against the whole cloud and group and pool
  them locally;
- `FeaturePropagation` runs 3-NN for the rank's own targets against the
  gathered sources;
- `InvResMLP` and `EdgeConv` query the gathered table for the rank's own
  rows.

A later stage's rows need not divide by the ranks (SA4's 16 centroids over
3 ranks, or more centroids than points): they split unevenly, the first
C mod n ranks taking one row more (`share`). The input's N must divide
(`shard_points`), as the JAX `device_put` requires. Every gather is bit
for bit (`parallel/mesh.py::all_gather`), so the coordinates, and hence
every selection, are the unsharded forward's. Eval mode on running
statistics only, as in the JAX tests and the dry run.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

import torch

from pointseg_torch.parallel.mesh import Mesh, all_gather


@dataclass(frozen=True)
class PointSplit:
    """The mesh axis the point rows are split over."""

    mesh: Mesh
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)


_POINTS: PointSplit | None = None


def point_split() -> PointSplit | None:
    """The split of the point-sharded forward running now, or None."""
    return _POINTS


@contextlib.contextmanager
def use_points(mesh: Mesh, axis: str = "data") -> Iterator[None]:
    """Makes the blocks treat their rows as this rank's share of each
    cloud, split over `axis` (a one-rank axis splits nothing)."""
    global _POINTS
    saved = _POINTS
    _POINTS = PointSplit(mesh, axis) if mesh.axis_size(axis) > 1 else None
    try:
        yield
    finally:
        _POINTS = saved


def share_sizes(total: int, size: int) -> list[int]:
    """Rows of each rank when `total` rows split over `size` ranks: the
    first total mod size ranks take one more."""
    base, extra = divmod(total, size)
    return [base + (i < extra) for i in range(size)]


def share(x: torch.Tensor, split: PointSplit, dim: int = 1) -> torch.Tensor:
    """This rank's rows (along `dim`) of a whole level."""
    sizes = share_sizes(x.shape[dim], split.size)
    return x.narrow(dim, sum(sizes[:split.index]), sizes[split.index])


def gather(split: PointSplit, *xs: torch.Tensor) -> list[torch.Tensor]:
    """The whole level of each of `xs` (this rank's rows along dim 1),
    joined in rank order: one exchange of the ranks' row counts, then one
    bit-exact all-gather a tensor."""
    counts = all_gather(torch.tensor([xs[0].shape[1]], dtype=torch.int64,
                                     device=xs[0].device), split.mesh, split.axis, 0)
    sizes = [int(c) for c in counts.cpu()]
    return [all_gather(x, split.mesh, split.axis, 1, sizes) for x in xs]


def global_max(x: torch.Tensor, split: PointSplit) -> torch.Tensor:
    """The maximum over the ranks of this rank's pooled (B, C) maxima."""
    return all_gather(x[:, None], split.mesh, split.axis, 1).amax(dim=1)


def shard_points(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's rows [r N/n, (r+1) N/n) of clouds (B, N, ...) split over
    `axis` (a view); N must divide by the axis's size."""
    n = mesh.axis_size(axis)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} points do not split over {n} ranks of axis {axis!r}")
    per = x.shape[1] // n
    return x[:, mesh.axis_index(axis) * per:(mesh.axis_index(axis) + 1) * per]


def gather_points(mesh: Mesh, y: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The whole clouds from the ranks' rows (the inverse of
    `shard_points`; every rank gets them)."""
    return all_gather(y, mesh, axis, 1)


@torch.no_grad()
def forward_points(model: torch.nn.Module, points: torch.Tensor, mesh: Mesh,
                   axis: str = "data") -> torch.Tensor:
    """This rank's rows of the logits of `model` in eval mode on clouds
    whose rows are split over `axis` (`points`: this rank's (B, N/n, F),
    `shard_points`). Every rank of the axis calls it with its own rows;
    the model's mode is put back after."""
    training = model.training
    model.eval()
    try:
        with use_points(mesh, axis):
            return model(points)
    finally:
        model.train(training)
