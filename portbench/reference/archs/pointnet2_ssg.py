"""PointNet++ SSG for semantic segmentation (Qi et al. 2017,
arXiv:1706.02413) at its published S3DIS widths: four set abstractions,
each FPS -> ball query -> MLP over cat(xyz_j - xyz_c, f_j) of every
(centroid, neighbour) -> max over the ball, then four feature
propagations (3-NN inverse-distance interpolation, skip concat, MLP),
dropout 0.5 and a Linear to the classes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import select
from portbench.reference.models import _mlp, _mlp_specs
from portbench.work import mlp_flops

# (centroids, radius, widths) of the set abstractions; K = 32
SA = ((1024, 0.1, (32, 32, 64)), (256, 0.2, (64, 64, 128)),
      (64, 0.4, (128, 128, 256)), (16, 0.8, (256, 256, 512)))
FP = ((768, (256, 256)), (384, (256, 256)), (320, (256, 128)), (128, (128, 128, 128, 128)))
K = 32


def specs(in_features: int = 6, num_classes: int = 14):
    out, width = [], in_features
    for s, (_, _, widths) in enumerate(SA, start=1):
        out += _mlp_specs(f"sa{s}.point_net", 3 + width, widths)
        width = widths[-1]
    for i, (fin, widths) in enumerate(FP):
        out += _mlp_specs(f"fp{4 - i}.point_net", fin, widths)
    out += [("conv.weight", (num_classes, 128), 128), ("conv.bias", (num_classes,), 128)]
    return out


def forward(p, x: torch.Tensor, fps_gen: torch.Generator, dropout: bool = True):
    """(B, N, 9) -> (B, N, classes) logits. FPS starts are drawn from
    `fps_gen`, one (B,) draw a stage, uniform over the stage's points."""
    xyz, feats = x[..., :3], x[..., 3:]
    levels = [(xyz, feats)]
    for s, (C, radius, widths) in enumerate(SA, start=1):
        B, N, _ = xyz.shape
        start = torch.randint(0, N, (B,), generator=fps_gen, device=fps_gen.device)
        centroids = select.gather(xyz, select.fps(xyz, C, start.to(xyz.device)))
        idx = select.ball_query(centroids, xyz, radius, K)
        rel = select.gather(xyz, idx) - centroids[:, :, None, :]
        grouped = torch.cat([rel, select.gather(feats, idx)], dim=-1)
        feats = _mlp(p, f"sa{s}.point_net", grouped, len(widths)).amax(dim=2)
        xyz = centroids
        levels.append((xyz, feats))
    f = levels[4][1]
    for i, (_, widths) in enumerate(FP):
        tgt, skip = levels[3 - i]
        src = levels[4 - i][0]
        d2, idx = select.three_nn(tgt, src)
        w = 1.0 / (d2 + 1e-9)
        w = w / w.sum(dim=-1, keepdim=True)
        up = (w[..., None] * select.gather(f, idx)).sum(dim=2)
        f = up if i == 3 else torch.cat([skip, up], dim=-1)
        f = _mlp(p, f"fp{4 - i}.point_net", f, len(widths))
    if dropout:
        f = F.dropout(f, 0.5, training=True)
    return F.linear(f, p["conv.weight"], p["conv.bias"])


def forward_flops(B: int, N: int, in_features: int = 6, num_classes: int = 14) -> float:
    flops, n_in, width = 0.0, N, in_features
    for C, _, widths in SA:
        first = widths[0]
        flops += 2.0 * B * n_in * width * first  # features, once a point
        flops += 2.0 * B * C * K * 3 * first  # relative xyz, once a pair
        flops += mlp_flops(B * C * K, first, widths[1:])
        n_in, width = C, widths[-1]
    # FP4..FP1 upsample onto the third, second and first level's centroids, then the points
    targets = [C for C, _, _ in SA[-2::-1]] + [N]
    for n_out, (fin, widths) in zip(targets, FP):
        flops += mlp_flops(B * n_out, fin, widths)
    return flops + 2.0 * B * N * 128 * num_classes
