"""Model registry (port of `pointseg.models`). Only PointNet++ SSG is
ported so far; ROADMAP.md lists the order of the rest."""

from __future__ import annotations

from torch import nn

from pointseg_torch.models.pointnetpp import PointNetPP

MODELS = {"PointNet++": PointNetPP}


def create_model(name: str, num_classes: int = 14, **kwargs) -> nn.Module:
    """Builds a model by its CLI name."""
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not yet ported to pointseg_torch, see ROADMAP.md "
            f"(ported: {sorted(MODELS)})")
    return MODELS[name](num_classes=num_classes, **kwargs)
