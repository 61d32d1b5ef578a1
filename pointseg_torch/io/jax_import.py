"""Carry JAX-package weights into the port.

`from_jax_variables` is the inverse of
`pointseg/io/torch_import.py::from_torch_state_dict`: it takes a flax
`{"params", "batch_stats"}` tree, as numpy arrays, and returns the port
model's `state_dict`. Each Dense kernel (in, out) becomes a Linear weight
(out, in), and a GroupedFirstLayer's `w_rel` / `w_feat` are joined back
into the reference's single (out, 3 + D) weight. Every leaf must be used
exactly once: an unmapped or left-over leaf raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

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

    def dense(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.weight", self.take(f"params/{fpath}/kernel").T)
        self.put(f"{tkey}.bias", self.take(f"params/{fpath}/bias"))

    def bn(self, fpath: str, tkey: str) -> None:
        self.put(f"{tkey}.weight", self.take(f"params/{fpath}/scale"))
        self.put(f"{tkey}.bias", self.take(f"params/{fpath}/bias"))
        self.put(f"{tkey}.running_mean", self.take(f"batch_stats/{fpath}/mean"))
        self.put(f"{tkey}.running_var", self.take(f"batch_stats/{fpath}/var"))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def mlp(self, fpath: str, tkey: str, n: int, first: int = 0) -> None:
        """flax SharedMLP Dense_i/BatchNorm_i -> conv.(first+i)/batch.(first+i)."""
        for i in range(n):
            self.dense(f"{fpath}/Dense_{i}", f"{tkey}.conv.{first + i}")
            self.bn(f"{fpath}/BatchNorm_{i}", f"{tkey}.batch.{first + i}")

    def set_abstraction(self, name: str, n_layers: int) -> None:
        first = f"{name}/point_net0"
        w_rel = self.take(f"params/{first}/w_rel/kernel")  # (3, h)
        w_feat = self.take(f"params/{first}/w_feat/kernel")  # (D, h)
        self.put(f"{name}.point_net.conv.0.weight", np.concatenate([w_rel, w_feat]).T)
        self.put(f"{name}.point_net.conv.0.bias", self.take(f"params/{first}/w_rel/bias"))
        self.bn(f"{first}/bn", f"{name}.point_net.batch.0")
        self.mlp(f"{name}/point_net", f"{name}.point_net", n_layers - 1, first=1)


def _pointnetpp(r: _Reader) -> None:
    for sa in ("sa1", "sa2", "sa3", "sa4"):
        r.set_abstraction(sa, 3)
    for fp, n in (("fp4", 2), ("fp3", 2), ("fp2", 2), ("fp1", 4)):
        r.mlp(f"{fp}/point_net", f"{fp}.point_net", n)
    r.dense("conv", "conv")


_IMPORTERS = {"PointNet++": _pointnetpp}


def from_jax_variables(model_name: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """Converts JAX-package variables into the port model's state_dict.

    Args:
        model_name: CLI model name; only "PointNet++" is ported.
        variables: {"params": ..., "batch_stats": ...} nested mappings of
            arrays (numpy, or anything `np.asarray` takes).

    Returns:
        A state_dict for `pointseg_torch.models.create_model(model_name)`.
    """
    if model_name not in _IMPORTERS:
        raise NotImplementedError(
            f"no JAX import for {model_name!r} yet, see ROADMAP.md "
            f"(ported: {sorted(_IMPORTERS)})")
    reader = _Reader(variables)
    _IMPORTERS[model_name](reader)
    if reader.leaves:
        raise ValueError(f"JAX leaves with no home in the port: {sorted(reader.leaves)}")
    return reader.sd
