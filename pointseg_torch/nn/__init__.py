"""Layers and blocks (port of `pointseg.nn`)."""

from pointseg_torch.nn.mlp import (  # noqa: F401
    BatchNorm,
    Dropout,
    Linear,
    SharedMLP,
    cast,
    leaky_relu_02,
)
from pointseg_torch.nn.blocks import (  # noqa: F401
    EdgeConv,
    FeaturePropagation,
    GroupedFirstLayer,
    InvResMLP,
    SetAbstraction,
    SetAbstractionMSG,
    TNet,
)
