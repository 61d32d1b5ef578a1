"""DGCNN (dynamic graph CNN) for semantic segmentation (port of
`pointseg/models/dgcnn.py`).

Four EdgeConv layers (3 -> 64 -> 64 -> 64 -> 128) whose kNN graph is
rebuilt from the features of every layer (the "dynamic" graph), their
concat (320), a Linear -> `emb_dims` per-point embedding, and a
512-256-classes head with dropout. `DGCNNWithColor` adds a parallel
Linear(3 -> 64) colour branch to the concat (384).

Input is channels-last, (B, N, 3), (B, N, 6) or the block format
(B, N, 9): xyz = [..., :3] builds the first graph, rgb = [..., 3:6] feeds
the colour branch. Returns float32 logits (B, N, classes), or
(logits, embedding) with `return_features=True`.

`static_graph=True` computes the kNN graph once on xyz and reuses it in
every EdgeConv; parameters and checkpoints are the same in both modes.

The models take `generator=` like `PointNetPP`, so one train step serves
all, and ignore it: nothing here samples. `dtype` is the compute dtype
(`nn/mlp.py`); under bfloat16 the static graph is built on the
bfloat16-rounded coordinates, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from pointseg_torch import ops
from pointseg_torch.nn import Dropout, EdgeConv, Linear, SharedMLP, cast, leaky_relu_02
from pointseg_torch.parallel.points import gather, point_split, share


def _conv(in_features: int, width: int, dtype: torch.dtype) -> SharedMLP:
    return SharedMLP(in_features, [width], act=leaky_relu_02, use_bias=False, dtype=dtype)


class DGCNN(nn.Module):
    """Geometry-only DGCNN."""

    color_width = 0

    def __init__(self, num_classes: int = 14, k: int = 20, emb_dims: int = 1024,
                 dropout: float = 0.5, static_graph: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.static_graph = static_graph
        self.dtype = dtype
        self.conv1 = EdgeConv(3, 64, k, dtype=dtype)
        self.conv2 = EdgeConv(64, 64, k, dtype=dtype)
        self.conv3 = EdgeConv(64, 64, k, dtype=dtype)
        self.conv4 = EdgeConv(64, 128, k, dtype=dtype)
        if self.color_width:
            self.color_conv = _conv(3, self.color_width, dtype)
        cat = 64 + 64 + 64 + 128 + self.color_width
        self.conv5 = _conv(cat, emb_dims, dtype)
        self.conv6 = _conv(cat + emb_dims, 512, dtype)
        self.conv7 = _conv(512, 256, dtype)
        self.dropout = Dropout(dropout)
        self.conv8 = Linear(256, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, return_features: bool = False):
        need = 6 if self.color_width else 3
        if x.shape[-1] < need:
            raise ValueError(f"{type(self).__name__} expects >= {need} channels "
                             f"(xyz{'+rgb' if self.color_width else ''}), got {x.shape[-1]}")
        xyz = x[..., :3]
        idx = None
        if self.static_graph:
            split = point_split()  # point-sharded: this rank's rows of the whole graph
            on = cast(xyz, self.dtype) if split is None else gather(split, cast(xyz, self.dtype))[0]
            idx = ops.knn_indices(on, self.k, mask=mask)
            if split is not None:
                idx = share(idx, split)
        x1 = self.conv1(xyz, mask=mask, idx=idx)
        x2 = self.conv2(x1, mask=mask, idx=idx)
        x3 = self.conv3(x2, mask=mask, idx=idx)
        x4 = self.conv4(x3, mask=mask, idx=idx)
        parts = [x1, x2, x3, x4]
        if self.color_width:
            parts.append(self.color_conv(x[..., 3:6]))
        x_cat = torch.cat(parts, dim=-1)  # (B, N, 320 or 384)
        x5 = self.conv5(x_cat)
        h = self.conv6(torch.cat([x_cat, x5], dim=-1))
        h = self.conv7(self.dropout(h))
        logits = self.conv8(self.dropout(h)).to(torch.float32)
        if return_features:
            return logits, x5
        return logits


class DGCNNWithColor(DGCNN):
    """DGCNN + a parallel RGB branch; needs >= 6 input channels."""

    color_width = 64


def get_model(num_classes: int = 14, use_color: bool = True, **kwargs) -> DGCNN:
    """Factory mirroring the reference's get_model."""
    return (DGCNNWithColor if use_color else DGCNN)(num_classes=num_classes, **kwargs)


def get_loss():
    """Loss factory, for API parity with the reference: the masked
    cross-entropy every model trains with."""
    from pointseg_torch.train.loss import masked_onehot_cross_entropy

    return masked_onehot_cross_entropy
