"""Layers and blocks (port of `pointseg.nn`)."""

from pointseg_torch.nn.mlp import BatchNorm, SharedMLP, leaky_relu_02  # noqa: F401
from pointseg_torch.nn.blocks import (  # noqa: F401
    BNStats,
    EdgeConv,
    FeaturePropagation,
    GroupedFirstLayer,
    InvResMLP,
    SetAbstraction,
    SetAbstractionMSG,
)
