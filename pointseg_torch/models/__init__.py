"""Model registry (port of `pointseg.models`). PointNet++ SSG and the
two DGCNNs are ported so far; ROADMAP.md lists the order of the rest."""

from __future__ import annotations

from torch import nn

from pointseg_torch.models.dgcnn import DGCNN, DGCNNWithColor, get_model  # noqa: F401
from pointseg_torch.models.pointnetpp import PointNetPP

# CLI names as in the JAX package's registry
MODELS = {"PointNet++": PointNetPP, "DeepGraphCnn": DGCNNWithColor, "DGCNN": DGCNN}


def create_model(name: str, num_classes: int = 14, **kwargs) -> nn.Module:
    """Builds a model by its CLI name."""
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not yet ported to pointseg_torch, see ROADMAP.md "
            f"(ported: {sorted(MODELS)})")
    return MODELS[name](num_classes=num_classes, **kwargs)
