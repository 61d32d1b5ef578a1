"""PointNet++ for semantic segmentation, SSG and MSG (port of
`pointseg/models/pointnetpp.py`).

SSG encoder SA(1024, r=0.1, [32,32,64]) -> SA(256, 0.2, [64,64,128]) ->
SA(64, 0.4, [128,128,256]) -> SA(16, 0.8, [256,256,512]); decoder
FP(768,[256,256]) -> FP(384,[256,256]) -> FP(320,[256,128]) ->
FP(128,[128,128,128,128]) -> Dropout(0.5) -> Linear(classes).

Input (B, N, 9) channels-last: coords = [..., :3], features = [..., 3:].
Returns float32 logits (B, N, classes). The SSG state_dict keys are the
reference torch model's, so `pointseg/io/torch_import.py` loads them
into the JAX model and `pointseg_torch/io/jax_import.py` goes back.

The MSG variant groups every stage at two nested radii (K = 16 and 32)
with an MLP each and concatenates them; the decoder is the same.

`ball_select` ('flat' or 'two_level') names the CUDA ball-query kernel
and `filler` ('repeat' or 'index') what fills a sparse ball
(`pointseg_torch/ops/ballquery.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from pointseg_torch.nn import FeaturePropagation, SetAbstraction, SetAbstractionMSG


class PointNetPP(nn.Module):
    """Single-scale-grouping PointNet++."""

    def __init__(self, num_classes: int = 14, dropout: float = 0.5, in_features: int = 6,
                 ball_select: str = "flat", filler: str = "repeat"):
        super().__init__()
        w1, w2, w3, w4 = self._build_encoder(in_features, ball_select=ball_select, filler=filler)
        self.fp4 = FeaturePropagation(w3 + w4, [256, 256])
        self.fp3 = FeaturePropagation(w2 + 256, [256, 256])
        self.fp2 = FeaturePropagation(w1 + 256, [256, 128])
        self.fp1 = FeaturePropagation(128, [128, 128, 128, 128])
        self.dropout = nn.Dropout(dropout)
        self.conv = nn.Linear(128, num_classes)

    def _build_encoder(self, in_features: int, **ball) -> tuple[int, int, int, int]:
        """Creates sa1..sa4; returns their output widths."""
        self.sa1 = SetAbstraction(1024, 0.1, in_features, [32, 32, 64], **ball)
        self.sa2 = SetAbstraction(256, 0.2, 64, [64, 64, 128], **ball)
        self.sa3 = SetAbstraction(64, 0.4, 128, [128, 128, 256], **ball)
        self.sa4 = SetAbstraction(16, 0.8, 256, [256, 256, 512], **ball)
        return 64, 128, 256, 512

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`mask` (B, N) reaches the first stage only, as in the JAX
        model; `generator` draws every stage's FPS start (else 0)."""
        coords0, feats0 = x[..., :3], x[..., 3:]
        c1, f1 = self.sa1(coords0, feats0, mask=mask, generator=generator)
        c2, f2 = self.sa2(c1, f1, generator=generator)
        c3, f3 = self.sa3(c2, f2, generator=generator)
        c4, f4 = self.sa4(c3, f3, generator=generator)

        f3 = self.fp4(c3, c4, f3, f4)
        f2 = self.fp3(c2, c3, f2, f3)
        f1 = self.fp2(c1, c2, f1, f2)
        f0 = self.fp1(coords0, c1, None, f1)
        return self.conv(self.dropout(f0)).to(torch.float32)


class PointNetPPMSG(PointNetPP):
    """Multi-scale-grouping PointNet++ (radius-nested ball queries)."""

    def _build_encoder(self, in_features: int, **ball) -> tuple[int, int, int, int]:
        self.sa1 = SetAbstractionMSG(1024, (0.05, 0.1), (16, 32), in_features,
                                     ([16, 16, 32], [32, 32, 64]), **ball)
        self.sa2 = SetAbstractionMSG(256, (0.1, 0.2), (16, 32), 96,
                                     ([64, 64, 128], [64, 96, 128]), **ball)
        self.sa3 = SetAbstractionMSG(64, (0.2, 0.4), (16, 32), 256,
                                     ([128, 196, 256], [128, 196, 256]), **ball)
        self.sa4 = SetAbstractionMSG(16, (0.4, 0.8), (16, 32), 512,
                                     ([256, 256, 512], [256, 384, 512]), **ball)
        return 96, 256, 512, 1024
