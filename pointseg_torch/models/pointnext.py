"""PointNeXt for semantic segmentation (port of
`pointseg/models/pointnext.py`).

A per-point stem MLP(in_dim -> width) on every input channel (nine in
the block format, six for the legacy stack's xyz + rgb rooms), four SA
stages (PointNet++'s centroid counts and radii, relative coordinates
divided by the radius) each followed by `blocks[i]` InvResMLP blocks,
the PointNet++ FeaturePropagation decoder with the stem's output as the
last skip, Dropout and a class head. The default `blocks=(1, 2, 1, 1)`
is the reference model, whose stage-2 pair groups at radii 0.1 then
0.2; extra blocks repeat their stage's last radius. Stage 4 groups
K = 16 because only 16 points remain. `PointNeXt-B` is
`blocks=(2, 3, 2, 2)` and `PointNeXt-L` `(3, 5, 3, 3)` at width 32.

Input (B, N, in_dim) channels-last; returns float32 logits (B, N, classes).
The module names are the reference torch model's (`mlp` for the stem,
`irmlp2_1` for stage 2's second block), so the default model's
state_dict loads into the JAX model through
`pointseg/io/torch_import.py`.

`PointNeXtXL` (`PointNeXt-XL`, a port-only registry name: the JAX
package has no such model) is the published layout instead (Qian et al.
2022, arXiv:2206.04670; openpoints' `cfgs/s3dis/pointnext-xl.yaml`):
class docstring.

`filler` ('repeat' or 'index') names what fills a sparse ball
(`pointseg_torch/ops/ballquery.py`). `dtype` is the compute dtype
(`nn/mlp.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from pointseg_torch.nn import (Dropout, FeaturePropagation, InvResMLP, Linear, SetAbstraction,
                                SharedMLP)

STAGE_RADII = ((0.1,), (0.1, 0.2), (0.4,), (0.8,))  # the InvResMLP radii per stage
STAGE_K = (32, 32, 32, 16)
XL_BLOCKS = (3, 6, 3, 3)  # InvResMLPs after each SA: openpoints' blocks [1, 4, 7, 4, 4], less 1
XL_K = 32  # neighbours of every grouped layer
XL_RADIUS = 0.1  # the first SA's radius, doubling a stage


def irmlp_name(stage: int, j: int) -> str:
    """Name of stage `stage`'s j-th InvResMLP (stages count from 1)."""
    return f"irmlp{stage}" if j == 0 else f"irmlp{stage}_{j}"


class PointNeXt(nn.Module):
    def __init__(self, num_classes: int = 14, width: int = 32,
                 blocks: tuple[int, int, int, int] = (1, 2, 1, 1), dropout: float = 0.5,
                 filler: str = "repeat", in_dim: int = 9, dtype: torch.dtype = torch.float32):
        super().__init__()
        w = width
        self.blocks = tuple(blocks)
        ball = dict(filler=filler, dtype=dtype)
        self.mlp = SharedMLP(in_dim, [w], dtype=dtype)
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
        self.fp4 = FeaturePropagation(8 * w + 16 * w, [256, 256], dtype=dtype)
        self.fp3 = FeaturePropagation(4 * w + 256, [256, 256], dtype=dtype)
        self.fp2 = FeaturePropagation(2 * w + 256, [256, 128], dtype=dtype)
        self.fp1 = FeaturePropagation(w + 128, [128, 128, 128, 128], dtype=dtype)
        self.dropout = Dropout(dropout)
        self.conv = Linear(128, num_classes, dtype=dtype)

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


class PointNeXtXL(nn.Module):
    """PointNeXt-XL as published for S3DIS (openpoints' `PointNextEncoder`,
    `PointNextDecoder` and `SegHead` under `cfgs/s3dis/pointnext-xl.yaml`):
    width 64, strides 4, one grouped layer a set abstraction, InvResMLP
    expansion 4, 32 neighbours everywhere, relative positions over the
    radius, max reduction, conv-norm-act with ReLU, and every layer that a
    BatchNorm follows bias-free.

    - Stem: `mlp`, Linear(in_dim -> width) with a bias, no BatchNorm or
      activation.
    - Stage s = 1..4 at width C = 2^s width: `sa{s}`, FPS to N // 4
      points, ball query of 32 at radius r_s = 0.1 * 2^(s - 1), then
      max_j ReLU(BN(W cat((p_j - p_c) / r_s, f_j))); then 3, 6, 3, 3
      InvResMLPs (`irmlp{s}`, `irmlp{s}_{j}`) at radius 2 r_s in the
      published order, f <- ReLU(BN(W_2 ReLU(BN(W_1 g))) + f) with g the
      grouped layer's max over the ball around every point. The radii are
      openpoints' `_to_full_list` rule: a strided stage's SA takes the
      running radius, its blocks twice that, and the running radius
      doubles. At N = 4096 stage 4 holds 16 points, so its balls of 32
      repeat their nearest member (`ops.ball_query`).
    - Decoder: `fp4`..`fp1`, 3-NN inverse-distance interpolation (the
      port's 1/d² weights, where openpoints weighs by 1/d), cat(skip,
      up), two ReLU(BN(Linear)) layers of the skip's width: 512, 256,
      128, then the stem's width.
    - Head: `head`, ReLU(BN(Linear(width -> width))), Dropout, then
      `conv`, Linear(width -> classes).

    41.58 M parameters at width 64, in_dim 9 and 14 classes. Takes
    `in_dim`, `dtype` and `filler` as the family does.
    """

    def __init__(self, num_classes: int = 14, width: int = 64, dropout: float = 0.5,
                 filler: str = "repeat", in_dim: int = 9, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = XL_BLOCKS
        ball = dict(filler=filler, dtype=dtype, bias=False)
        self.mlp = Linear(in_dim, width, dtype=dtype)
        widths = [width * 2 ** s for s in range(5)]
        for stage in range(1, 5):
            r = XL_RADIUS * 2 ** (stage - 1)
            c_in, c = widths[stage - 1], widths[stage]
            self.add_module(f"sa{stage}", SetAbstraction(
                None, r, c_in, [c], XL_K, grouping_norm=True, stride=4, **ball))
            for j in range(self.blocks[stage - 1]):
                self.add_module(irmlp_name(stage, j), InvResMLP(
                    2 * r, c, XL_K, residual_act=True, **ball))
        for stage in range(4, 0, -1):  # cat(skip, the level above's output)
            self.add_module(f"fp{stage}", FeaturePropagation(
                widths[stage - 1] + widths[stage], [widths[stage - 1]] * 2, dtype=dtype,
                bias=False))
        self.head = SharedMLP(width, [width], use_bias=False, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.conv = Linear(width, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`mask` (B, N) reaches the first SA stage only, as in the family;
        `generator` draws every stage's FPS start (else 0)."""
        levels = [(x[..., :3], self.mlp(x))]
        for stage in range(1, 5):
            sa = getattr(self, f"sa{stage}")
            level = sa(*levels[-1], mask=mask if stage == 1 else None, generator=generator)
            for j in range(self.blocks[stage - 1]):
                level = getattr(self, irmlp_name(stage, j))(*level)
            levels.append(level)
        f = levels[4][1]
        for stage in range(4, 0, -1):
            (tgt, skip), src = levels[stage - 1], levels[stage][0]
            f = getattr(self, f"fp{stage}")(tgt, src, skip, f)
        return self.conv(self.dropout(self.head(f))).to(torch.float32)
