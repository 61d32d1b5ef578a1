"""PointNeXt-XL for semantic segmentation (Qian et al. 2022,
arXiv:2206.04670) as openpoints configures it for S3DIS
(`cfgs/s3dis/pointnext-xl.yaml`: `PointNextEncoder`, `PointNextDecoder`,
`SegHead`), at width 64:

- stem: Linear(in -> 64) with a bias, no BatchNorm, no activation;
- stages s = 1..4 at widths 128, 256, 512, 1024: a set abstraction (FPS
  to N // 4 points, a ball of 32 at radius r_s = 0.1 * 2^(s - 1), then
  max over the ball of ReLU(BN(W cat((p_j - p_c) / r_s, f_j)))), then
  3, 6, 3, 3 InvResMLP blocks at radius 2 r_s: g = max_j ReLU(BN(W_a
  cat((p_j - p_i) / (2 r_s), f_j))) over the ball around every point,
  f <- ReLU(BN(W_2 ReLU(BN(W_1 g))) + f), W_1 4C x C, W_2 C x 4C;
- decoder: four feature propagations (3-NN interpolation, cat(skip, up),
  two ReLU(BN(Linear)) layers) to 512, 256, 128, 64;
- head: ReLU(BN(Linear(64 -> 64))), dropout 0.5, Linear(64 -> classes).

Every Linear that a BatchNorm follows is bias-free, as openpoints'
`create_convblock1d` / `create_convblock2d` make it. The grouped layers
are computed as written, over cat(rel, f_j) of every (centre,
neighbour) pair.

Departures from openpoints, each the program's too:

- interpolation weights 1/d² (PointNet++'s form, the port's
  `ops.interpolate`), where openpoints weighs by 1/d;
- a ball's empty slots repeat its nearest member (openpoints repeats the
  first member its scan finds), and where the level has fewer points
  than the ball's 32 slots (stage 4 at N = 4096: 16 points), the ball is
  taken over all of them and the rest of its slots repeat slot 0;
- the input is the block format's 9 features (openpoints: colour and
  height, 4), the stem's Linear taking all nine;
- FPS starts at a random point of each cloud (openpoints: index 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import select
from portbench.reference.models import _mlp, _mlp_specs, batch_norm
from portbench.work import mlp_flops

BLOCKS = (3, 6, 3, 3)  # InvResMLPs after each set abstraction
K = 32
RADIUS = 0.1  # the first set abstraction's; doubles a stage
STRIDE = 4
EXPANSION = 4


def _irmlp(stage: int, j: int) -> str:
    return f"irmlp{stage}" if j == 0 else f"irmlp{stage}_{j}"


def specs(in_dim: int = 9, num_classes: int = 14, width: int = 64):
    widths = [width * 2 ** s for s in range(5)]
    out = [("mlp.weight", (width, in_dim), in_dim), ("mlp.bias", (width,), in_dim)]
    for s in range(1, 5):
        c = widths[s]
        out += _mlp_specs(f"sa{s}.point_net", 3 + widths[s - 1], (c,), bias=False)
        for j in range(BLOCKS[s - 1]):
            name = _irmlp(s, j)
            out += _mlp_specs(f"{name}.neighbour_features_mlp", 3 + c, (c,), bias=False)
            out += _mlp_specs(f"{name}.point_features_mlp", c, (EXPANSION * c, c), bias=False)
    for s in range(4, 0, -1):
        out += _mlp_specs(f"fp{s}.point_net", widths[s - 1] + widths[s], (widths[s - 1],) * 2,
                          bias=False)
    out += _mlp_specs("head", width, (width,), bias=False)
    return out + [("conv.weight", (num_classes, width), width),
                  ("conv.bias", (num_classes,), width)]


def _grouped(p, prefix: str, centres, xyz, feats, radius: float):
    """max over the ball of ReLU(BN(W cat((p_j - p_c) / r, f_j)))."""
    N = xyz.shape[1]
    idx = select.ball_query(centres, xyz, radius, min(K, N))
    if K > N:
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], K - N)], dim=-1)
    rel = (select.gather(xyz, idx) - centres[:, :, None, :]) / radius
    grouped = torch.cat([rel, select.gather(feats, idx)], dim=-1)
    return _mlp(p, prefix, grouped, 1, bias=False).amax(dim=2)


def forward(p, x: torch.Tensor, fps_gen: torch.Generator, dropout: bool = True):
    """(B, N, in_dim) -> (B, N, classes) logits. FPS starts are drawn from
    `fps_gen`, one (B,) draw a stage, uniform over the stage's points."""
    xyz = x[..., :3]
    f = F.linear(x, p["mlp.weight"], p["mlp.bias"])
    levels = [(xyz, f)]
    for s in range(1, 5):
        B, N, _ = xyz.shape
        r = RADIUS * 2 ** (s - 1)
        start = torch.randint(0, N, (B,), generator=fps_gen, device=fps_gen.device)
        centres = select.gather(xyz, select.fps(xyz, N // STRIDE, start.to(xyz.device)))
        f = _grouped(p, f"sa{s}.point_net", centres, xyz, f, r)
        xyz = centres
        for j in range(BLOCKS[s - 1]):
            name = _irmlp(s, j)
            g = _grouped(p, f"{name}.neighbour_features_mlp", xyz, xyz, f, 2 * r)
            h = _mlp(p, f"{name}.point_features_mlp", g, 1, bias=False)
            h = F.linear(h, p[f"{name}.point_features_mlp.conv.1.weight"])
            h = batch_norm(h, p[f"{name}.point_features_mlp.batch.1.weight"],
                           p[f"{name}.point_features_mlp.batch.1.bias"])
            f = F.relu(h + f)
        levels.append((xyz, f))
    f = levels[4][1]
    for s in range(4, 0, -1):
        (tgt, skip), src = levels[s - 1], levels[s][0]
        d2, idx = select.three_nn(tgt, src)
        w = 1.0 / (d2 + 1e-9)
        w = w / w.sum(dim=-1, keepdim=True)
        up = (w[..., None] * select.gather(f, idx)).sum(dim=2)
        f = _mlp(p, f"fp{s}.point_net", torch.cat([skip, up], dim=-1), 2, bias=False)
    f = _mlp(p, "head", f, 1, bias=False)
    if dropout:
        f = F.dropout(f, 0.5, training=True)
    return F.linear(f, p["conv.weight"], p["conv.bias"])


def forward_flops(B: int, N: int, in_dim: int = 9, num_classes: int = 14,
                  width: int = 64) -> float:
    """The program's factorised form: a grouped layer's feature product
    once a point of its input level, its relative-coordinate product once
    a (centre, neighbour) pair."""
    widths = [width * 2 ** s for s in range(5)]
    flops = 2.0 * B * N * in_dim * width
    sizes = [N]
    for s in range(1, 5):
        c, m = widths[s], sizes[-1] // STRIDE
        flops += 2.0 * B * sizes[-1] * widths[s - 1] * c + 2.0 * B * m * K * 3 * c
        flops += BLOCKS[s - 1] * (2.0 * B * m * c * c + 2.0 * B * m * K * 3 * c
                                  + mlp_flops(B * m, c, (EXPANSION * c, c)))
        sizes.append(m)
    for s in range(4, 0, -1):
        flops += mlp_flops(B * sizes[s - 1], widths[s - 1] + widths[s], (widths[s - 1],) * 2)
    return flops + mlp_flops(B * N, width, (width, num_classes))
