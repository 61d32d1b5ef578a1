"""Layers and blocks (port of `pointseg.nn`)."""

from pointseg_torch.nn.mlp import BatchNorm, SharedMLP  # noqa: F401
from pointseg_torch.nn.blocks import (  # noqa: F401
    FeaturePropagation,
    GroupedFirstLayer,
    SetAbstraction,
)
