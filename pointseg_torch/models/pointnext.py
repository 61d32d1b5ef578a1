"""PointNeXt for semantic segmentation (port of
`pointseg/models/pointnext.py`).

A per-point stem MLP(9 -> width) on all nine input channels, four SA
stages (PointNet++'s centroid counts and radii, relative coordinates
divided by the radius) each followed by `blocks[i]` InvResMLP blocks,
the PointNet++ FeaturePropagation decoder with the stem's output as the
last skip, Dropout and a class head. The default `blocks=(1, 2, 1, 1)`
is the reference model, whose stage-2 pair groups at radii 0.1 then
0.2; extra blocks repeat their stage's last radius. Stage 4 groups
K = 16 because only 16 points remain. `PointNeXt-B` is
`blocks=(2, 3, 2, 2)` and `PointNeXt-L` `(3, 5, 3, 3)` at width 32.

Input (B, N, 9) channels-last; returns float32 logits (B, N, classes).
The module names are the reference torch model's (`mlp` for the stem,
`irmlp2_1` for stage 2's second block), so the default model's
state_dict loads into the JAX model through
`pointseg/io/torch_import.py`.

`ball_select` ('flat' or 'two_level') names the CUDA ball-query kernel
and `filler` ('repeat' or 'index') what fills a sparse ball
(`pointseg_torch/ops/ballquery.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from pointseg_torch.nn import FeaturePropagation, InvResMLP, SetAbstraction, SharedMLP

STAGE_RADII = ((0.1,), (0.1, 0.2), (0.4,), (0.8,))  # the InvResMLP radii per stage
STAGE_K = (32, 32, 32, 16)


def irmlp_name(stage: int, j: int) -> str:
    """Name of stage `stage`'s j-th InvResMLP (stages count from 1)."""
    return f"irmlp{stage}" if j == 0 else f"irmlp{stage}_{j}"


class PointNeXt(nn.Module):
    def __init__(self, num_classes: int = 14, width: int = 32,
                 blocks: tuple[int, int, int, int] = (1, 2, 1, 1), dropout: float = 0.5,
                 ball_select: str = "flat", filler: str = "repeat"):
        super().__init__()
        w = width
        self.blocks = tuple(blocks)
        ball = dict(ball_select=ball_select, filler=filler)
        self.mlp = SharedMLP(9, [w])
        self.sa1 = SetAbstraction(1024, 0.1, w, [w, w, 2 * w], grouping_norm=True, **ball)
        self.sa2 = SetAbstraction(256, 0.2, 2 * w, [2 * w, 2 * w, 4 * w],
                                  grouping_norm=True, **ball)
        self.sa3 = SetAbstraction(64, 0.4, 4 * w, [4 * w, 4 * w, 8 * w],
                                  grouping_norm=True, **ball)
        self.sa4 = SetAbstraction(16, 0.8, 8 * w, [8 * w, 8 * w, 16 * w],
                                  grouping_norm=True, **ball)
        for stage, (n_blocks, radii, k) in enumerate(zip(self.blocks, STAGE_RADII, STAGE_K), 1):
            for j in range(n_blocks):
                self.add_module(irmlp_name(stage, j), InvResMLP(
                    radii[min(j, len(radii) - 1)], (2 ** stage) * w, k, **ball))
        self.fp4 = FeaturePropagation(8 * w + 16 * w, [256, 256])
        self.fp3 = FeaturePropagation(4 * w + 256, [256, 256])
        self.fp2 = FeaturePropagation(2 * w + 256, [256, 128])
        self.fp1 = FeaturePropagation(w + 128, [128, 128, 128, 128])
        self.dropout = nn.Dropout(dropout)
        self.conv = nn.Linear(128, num_classes)

    def _irmlp_stack(self, stage: int, coords, feats):
        for j in range(self.blocks[stage - 1]):
            coords, feats = getattr(self, irmlp_name(stage, j))(coords, feats)
        return coords, feats

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`mask` (B, N) reaches the first SA stage only, as in the JAX
        model; `generator` draws every stage's FPS start (else 0)."""
        coords0 = x[..., :3]
        f0 = self.mlp(x)  # (B, N, w)
        c1, f1 = self._irmlp_stack(1, *self.sa1(coords0, f0, mask=mask, generator=generator))
        c2, f2 = self._irmlp_stack(2, *self.sa2(c1, f1, generator=generator))
        c3, f3 = self._irmlp_stack(3, *self.sa3(c2, f2, generator=generator))
        c4, f4 = self._irmlp_stack(4, *self.sa4(c3, f3, generator=generator))

        f3 = self.fp4(c3, c4, f3, f4)
        f2 = self.fp3(c2, c3, f2, f3)
        f1 = self.fp2(c1, c2, f1, f2)
        f0 = self.fp1(coords0, c1, f0, f1)
        return self.conv(self.dropout(f0)).to(torch.float32)
