"""Model registry (port of `pointseg.models`): all eight of the JAX
package's names, and `PointNeXt-XL`, which only the port has
(`models/pointnext.py::PointNeXtXL`, the published layout). `PointNetCls`
is exported and, as in the JAX package, not registered: the registry is
the segmentation CLI's ((B, N, C) logits), and it emits per-cloud (B, C)
logits."""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from pointseg_torch.models.dgcnn import DGCNN, DGCNNWithColor, get_model  # noqa: F401
from pointseg_torch.models.pointnet import (  # noqa: F401
    PointNetCls,
    PointNetEncoder,
    PointNetSeg,
)
from pointseg_torch.models.pointnetpp import PointNetPP, PointNetPPMSG
from pointseg_torch.models.pointnext import PointNeXt, PointNeXtXL

# CLI names as in the JAX package's registry, and the port's own PointNeXt-XL
MODELS = {
    "PointNet": PointNetSeg,
    "PointNet++": PointNetPP,
    "PointNet++MSG": PointNetPPMSG,
    "PointNeXt": PointNeXt,
    "PointNeXt-B": partial(PointNeXt, blocks=(2, 3, 2, 2)),
    "PointNeXt-L": partial(PointNeXt, blocks=(3, 5, 3, 3)),
    "PointNeXt-XL": PointNeXtXL,
    "DeepGraphCnn": DGCNNWithColor,
    "DGCNN": DGCNN,
}


def create_model(name: str, num_classes: int = 14, dtype: torch.dtype = torch.float32,
                 in_dim: int = 9, **kwargs) -> nn.Module:
    """Builds a model by its CLI name. `dtype` is the compute dtype
    (`nn/mlp.py`): torch.bfloat16 computes activations in bfloat16 with
    float32 parameters and logits, the JAX package's
    `create_model(name, dtype=jnp.bfloat16)`.

    `in_dim` is the width of the input rows: 9 for the block format, 6 for
    the legacy stack's xyz + rgb rooms. Flax infers each model's first
    layer from its example input; here PointNet takes it as `in_dim`,
    PointNet++ (SSG and MSG) as `in_features = in_dim - 3` (the features
    beside xyz), the PointNeXt family as its stem's width, and the DGCNNs,
    which read xyz (and rgb) only, not at all."""
    if name not in MODELS:
        raise ValueError(f"Unknown model '{name}'. Choices: {sorted(MODELS)}")
    if name in ("PointNet++", "PointNet++MSG"):
        kwargs["in_features"] = in_dim - 3
    elif name not in ("DeepGraphCnn", "DGCNN"):
        kwargs["in_dim"] = in_dim
    return MODELS[name](num_classes=num_classes, dtype=dtype, **kwargs)
