"""Carry JAX-package weights into the port.

`from_jax_variables` is the inverse of
`pointseg/io/torch_import.py::from_torch_state_dict`: it takes a flax
`{"params", "batch_stats"}` tree, as numpy arrays, and returns the port
model's `state_dict`. Each Dense kernel (in, out) becomes a Linear weight
(out, in), a GroupedFirstLayer's `w_rel` / `w_feat` are joined back
into the reference's single (out, 3 + D) weight, and an EdgeConv's
`w_edge` / `w_center` kernels go to the port's two Linears of the same
names. An InvResMLP's `neighbour_mlp` / `point_mlp` and an MSG stage's
`scale_{s}_0` / `scale_{s}` take the port's names (`nn/blocks.py`). A
TNet's `SharedMLP_0` / `SharedMLP_1` / `Dense_0` become the reference's
`conv1..3` / `fc1..2` with `bn1..5`, and `fc3`. Every leaf must be used
exactly once: an unmapped or left-over leaf raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from pointseg_torch.models.pointnext import irmlp_name

__all__ = ["from_jax_variables"]


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


class _Reader:
    """Pops flax leaves by path and writes torch state_dict entries."""

    def __init__(self, variables: Mapping):
        self.leaves = _flatten(variables)
        self.sd: dict[str, torch.Tensor] = {}

    def take(self, path: str) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"JAX variables have no leaf {path!r}")
        return self.leaves.pop(path)

    def put(self, key: str, value: np.ndarray) -> None:
        self.sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))  # a copy

    def dense(self, fpath: str, tkey: str, bias: bool = True) -> None:
        self.put(f"{tkey}.weight", self.take(f"params/{fpath}/kernel").T)
        if bias:
            self.put(f"{tkey}.bias", self.take(f"params/{fpath}/bias"))

    def bn(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.weight", self.take(f"params/{fpath}/scale"))
        self.put(f"{tkey}.bias", self.take(f"params/{fpath}/bias"))
        self.put(f"{tkey}.running_mean", self.take(f"batch_stats/{fpath}/mean"))
        self.put(f"{tkey}.running_var", self.take(f"batch_stats/{fpath}/var"))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def mlp(self, fpath: str, tkey: str, n: int, first: int = 0, bias: bool = True) -> None:
        """flax SharedMLP Dense_i/BatchNorm_i -> conv.(first+i)/batch.(first+i)."""
        for i in range(n):
            self.dense(f"{fpath}/Dense_{i}", f"{tkey}.conv.{first + i}", bias=bias)
            self.bn(f"{fpath}/BatchNorm_{i}", f"{tkey}.batch.{first + i}")

    def grouped_first(self, fpath: str, tkey: str) -> None:
        """flax GroupedFirstLayer -> layer 0 of the port's grouped MLP."""
        w_rel = self.take(f"params/{fpath}/w_rel/kernel")  # (3, h)
        w_feat = self.take(f"params/{fpath}/w_feat/kernel")  # (D, h)
        self.put(f"{tkey}.conv.0.weight", np.concatenate([w_rel, w_feat]).T)
        self.put(f"{tkey}.conv.0.bias", self.take(f"params/{fpath}/w_rel/bias"))
        self.bn(f"{fpath}/bn", f"{tkey}.batch.0")

    def set_abstraction(self, name: str, n_layers: int) -> None:
        self.grouped_first(f"{name}/point_net0", f"{name}.point_net")
        self.mlp(f"{name}/point_net", f"{name}.point_net", n_layers - 1, first=1)

    def set_abstraction_msg(self, name: str, n_scales: int, n_layers: int) -> None:
        for s in range(n_scales):
            self.grouped_first(f"{name}/scale_{s}_0", f"{name}.scales.{s}")
            self.mlp(f"{name}/scale_{s}", f"{name}.scales.{s}", n_layers - 1, first=1)

    def inv_res_mlp(self, name: str) -> None:
        self.grouped_first(f"{name}/neighbour_mlp", f"{name}.neighbour_features_mlp")
        self.mlp(f"{name}/point_mlp", f"{name}.point_features_mlp", 2)

    def edgeconv(self, name: str) -> None:
        self.dense(f"{name}/w_edge", f"{name}.w_edge", bias=False)
        self.dense(f"{name}/w_center", f"{name}.w_center", bias=False)
        self.bn(f"{name}/bn", f"{name}.bn")


SA_STAGES = ("sa1", "sa2", "sa3", "sa4")


def _decoder(r: _Reader) -> None:
    for fp, n in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 4)):
        r.mlp(f"{fp}/point_net", f"{fp}.point_net", n)
    r.dense("conv", "conv")


def _tnet(r: _Reader, fpath: str, tkey: str) -> None:
    for i in range(3):
        r.dense(f"{fpath}/SharedMLP_0/Dense_{i}", f"{tkey}.conv{i + 1}")
        r.bn(f"{fpath}/SharedMLP_0/BatchNorm_{i}", f"{tkey}.bn{i + 1}")
    for i in range(2):
        r.dense(f"{fpath}/SharedMLP_1/Dense_{i}", f"{tkey}.fc{i + 1}")
        r.bn(f"{fpath}/SharedMLP_1/BatchNorm_{i}", f"{tkey}.bn{i + 4}")
    r.dense(f"{fpath}/Dense_0", f"{tkey}.fc3")


def _pointnet_encoder(r: _Reader) -> None:
    """The encoder, with the feature TNet where the variables hold one
    (`feature_transform=True`)."""
    _tnet(r, "feat/stn", "feat.stn")
    if any(path.startswith("params/feat/fstn/") for path in r.leaves):
        _tnet(r, "feat/fstn", "feat.fstn")
    for i, name in ((1, "mlp1"), (2, "mlp2")):
        r.dense(f"feat/{name}/Dense_0", f"feat.conv{i}")
        r.bn(f"feat/{name}/BatchNorm_0", f"feat.bn{i}")
    r.dense("feat/conv3", "feat.conv3")
    r.bn("feat/bn3", "feat.bn3")


def _pointnet(r: _Reader) -> None:
    _pointnet_encoder(r)
    for i in range(3):
        r.dense(f"head/Dense_{i}", f"conv{i + 1}")
        r.bn(f"head/BatchNorm_{i}", f"bn{i + 1}")
    r.dense("conv4", "conv4")


def _pointnet_cls(r: _Reader) -> None:
    _pointnet_encoder(r)
    for i in (1, 2):
        r.dense(f"fc{i}", f"fc{i}")
        r.bn(f"bn{i}", f"bn{i}")
    r.dense("fc3", "fc3")


def _pointnetpp(r: _Reader) -> None:
    for sa in SA_STAGES:
        r.set_abstraction(sa, 3)
    _decoder(r)


def _pointnetpp_msg(r: _Reader) -> None:
    for sa in SA_STAGES:
        r.set_abstraction_msg(sa, 2, 3)
    _decoder(r)


def _pointnext(r: _Reader, blocks: tuple[int, int, int, int]) -> None:
    r.mlp("stem", "mlp", 1)
    for stage, (sa, n_blocks) in enumerate(zip(SA_STAGES, blocks), start=1):
        r.set_abstraction(sa, 3)
        for j in range(n_blocks):
            r.inv_res_mlp(irmlp_name(stage, j))
    _decoder(r)


def _dgcnn(r: _Reader, with_color: bool) -> None:
    for name in ("conv1", "conv2", "conv3", "conv4"):
        r.edgeconv(name)
    for name in (("color_conv",) if with_color else ()) + ("conv5", "conv6", "conv7"):
        r.mlp(name, name, 1, bias=False)
    r.dense("conv8", "conv8")


_IMPORTERS = {
    "PointNet": _pointnet,
    "PointNetCls": _pointnet_cls,
    "PointNet++": _pointnetpp,
    "PointNet++MSG": _pointnetpp_msg,
    "PointNeXt": lambda r: _pointnext(r, (1, 2, 1, 1)),
    "PointNeXt-B": lambda r: _pointnext(r, (2, 3, 2, 2)),
    "PointNeXt-L": lambda r: _pointnext(r, (3, 5, 3, 3)),
    "DGCNN": lambda r: _dgcnn(r, with_color=False),
    "DeepGraphCnn": lambda r: _dgcnn(r, with_color=True),
}


def from_jax_variables(model_name: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """Converts JAX-package variables into the port model's state_dict.

    Args:
        model_name: CLI model name (`pointseg_torch.models.MODELS`) or
            "PointNetCls".
        variables: {"params": ..., "batch_stats": ...} nested mappings of
            arrays (numpy, or anything `np.asarray` takes).

    Returns:
        A state_dict for `pointseg_torch.models.create_model(model_name)`
        (PointNet's and PointNetCls's `feature_transform` as the
        variables have it).
    """
    if model_name not in _IMPORTERS:
        raise ValueError(f"unknown model {model_name!r}; expected one of {sorted(_IMPORTERS)}")
    reader = _Reader(variables)
    _IMPORTERS[model_name](reader)
    if reader.leaves:
        raise ValueError(f"JAX leaves with no home in the port: {sorted(reader.leaves)}")
    return reader.sd

