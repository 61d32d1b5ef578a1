"""PointNet for semantic segmentation and classification (port of
`pointseg/models/pointnet.py`).

TNet(k=in_dim) input transform, per-point MLP 64 -> (optional TNet(64)
feature transform) -> 128 -> 1024 (Linear and BatchNorm, no ReLU before
the pool), a global max-pool, the global feature tiled and concatenated
with the 64-wide point features (1088), and the segmentation head
512-256-128-classes. No kernel of the port runs here: Linear,
BatchNorm, ReLU, a per-cloud matrix product and max-pools.

Input (B, N, in_dim) channels-last; the models return float32 logits.
`mask` (B, N) keeps padded points out of every max-pool. The models take
the `generator` keyword that the train step passes to every model and
ignore it (PointNet samples nothing). The state_dict keys are the
reference torch model's (`feat.stn.*`, `feat.fstn.*`, `feat.conv1..3`,
`feat.bn1..3`, then `conv1..4` / `bn1..3` for segmentation, `fc1..3` /
`bn1..2` for classification), so `pointseg/io/torch_import.py` loads
them into the JAX models and `pointseg_torch/io/jax_import.py` goes back.
`dtype` is the compute dtype (`nn/mlp.py`): under bfloat16 the input
transform's product runs in bfloat16, as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointseg_torch import ops
from pointseg_torch.nn import BatchNorm, Dropout, Linear, TNet
from pointseg_torch.parallel.points import global_max, point_split


class PointNetEncoder(nn.Module):
    """Input TNet, shared MLP and the optional feature TNet; returns
    cat(global, local) per point (B, N, 1088), or with `global_feat` the
    pooled (B, 1024) feature of the classification model."""

    def __init__(self, in_dim: int = 9, feature_transform: bool = False,
                 global_feat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.global_feat = global_feat
        self.stn = TNet(in_dim, dtype=dtype)
        self.conv1, self.bn1 = Linear(in_dim, 64, dtype=dtype), BatchNorm(64, dtype=dtype)
        self.fstn = TNet(64, dtype=dtype) if feature_transform else None
        self.conv2, self.bn2 = Linear(64, 128, dtype=dtype), BatchNorm(128, dtype=dtype)
        self.conv3, self.bn3 = Linear(128, 1024, dtype=dtype), BatchNorm(1024, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        trans = self.stn(x, mask)
        x = torch.bmm(x.to(trans.dtype), trans)
        x = F.relu(self.bn1(self.conv1(x)))
        if self.fstn is not None:
            x = torch.bmm(x, self.fstn(x, mask))
        point_feat = x  # (B, N, 64)
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))  # no ReLU before the pool, as the reference
        pooled = (torch.amax(x, dim=1) if mask is None
                  else ops.masked_reduce(x, mask, "max", dim=1))  # (B, 1024)
        split = point_split()
        if split is not None:  # point-sharded: the whole cloud's maximum
            pooled = global_max(pooled, split)
        if self.global_feat:
            return pooled
        tiled = pooled[:, None, :].expand(-1, x.shape[1], -1)
        return torch.cat([tiled, point_feat], dim=-1)


class PointNetSeg(nn.Module):
    """PointNet segmentation: encoder, then 512-256-128 (Linear,
    BatchNorm, ReLU) and `conv4` to per-point logits (B, N, classes)."""

    def __init__(self, num_classes: int = 14, in_dim: int = 9,
                 feature_transform: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat = PointNetEncoder(in_dim, feature_transform, dtype=dtype)
        self.conv1, self.bn1 = Linear(1088, 512, dtype=dtype), BatchNorm(512, dtype=dtype)
        self.conv2, self.bn2 = Linear(512, 256, dtype=dtype), BatchNorm(256, dtype=dtype)
        self.conv3, self.bn3 = Linear(256, 128, dtype=dtype), BatchNorm(128, dtype=dtype)
        self.conv4 = Linear(128, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.feat(x, mask)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = F.relu(self.bn3(self.conv3(h)))
        return self.conv4(h).to(torch.float32)


class PointNetCls(nn.Module):
    """PointNet classification: the encoder's global feature, then fc
    512 -> 256 with BatchNorm, ReLU and Dropout(0.3), then `fc3` to
    per-cloud logits (B, classes). Kept out of the model registry, as in
    the JAX package: the registry is the segmentation CLI's."""

    def __init__(self, num_classes: int = 40, in_dim: int = 9,
                 feature_transform: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat = PointNetEncoder(in_dim, feature_transform, global_feat=True, dtype=dtype)
        self.fc1, self.bn1 = Linear(1024, 512, dtype=dtype), BatchNorm(512, dtype=dtype)
        self.fc2, self.bn2 = Linear(512, 256, dtype=dtype), BatchNorm(256, dtype=dtype)
        self.dropout = Dropout(0.3)
        self.fc3 = Linear(256, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.feat(x, mask)
        h = self.dropout(F.relu(self.bn1(self.fc1(h))))
        h = self.dropout(F.relu(self.bn2(self.fc2(h))))
        return self.fc3(h).to(torch.float32)
