"""Plain PyTorch PointNet++ SSG and DGCNN for semantic segmentation: the
benchmark's reference. Imports nothing of the program.

Each model is a list of parameter specifications (name, shape, init)
and a function of a parameter dict. The names are the reference torch
models' state_dict keys, which the program keeps, so one dict of weights
made by the benchmark loads into both. Every layer is written in its
published form:

- PointNet++ SSG (Qi et al. 2017, arXiv:1706.02413): four set
  abstractions, each FPS -> ball query -> MLP over cat(xyz_j - xyz_c,
  f_j) of every (centroid, neighbour) -> max over the ball, then four
  feature propagations (3-NN inverse-distance interpolation, skip concat,
  MLP), dropout 0.5 and a Linear to the classes.
- DGCNN with colour (Wang et al. 2019, arXiv:1801.07829; the reference
  repo's DeepGraphCnn): four EdgeConvs, each kNN on the layer's input ->
  a bias-free Linear over the (B, N, k, 2F) edge features cat(x_j - x_i,
  x_i) -> BatchNorm over every edge -> LeakyReLU(0.2) -> max over the
  neighbours, a colour branch, and the 1024-wide embedding and the
  512-256-classes head with dropout.

BatchNorm in training mode takes the batch's biased variance, as the
program's does; the layers' widths are the published ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import select

BN_EPS = 1e-5

# (centroids, radius, widths) of PointNet++ SSG's set abstractions; K = 32
PNPP_SA = ((1024, 0.1, (32, 32, 64)), (256, 0.2, (64, 64, 128)),
           (64, 0.4, (128, 128, 256)), (16, 0.8, (256, 256, 512)))
PNPP_FP = ((768, (256, 256)), (384, (256, 256)), (320, (256, 128)), (128, (128, 128, 128, 128)))
PNPP_K = 32


def _mlp_specs(prefix: str, in_features: int, widths, bias: bool = True):
    specs = []
    for i, w in enumerate(widths):
        specs.append((f"{prefix}.conv.{i}.weight", (w, in_features), in_features))
        if bias:
            specs.append((f"{prefix}.conv.{i}.bias", (w,), in_features))
        specs.append((f"{prefix}.batch.{i}.weight", (w,), "ones"))
        specs.append((f"{prefix}.batch.{i}.bias", (w,), "zeros"))
        in_features = w
    return specs


def pointnet2_ssg_specs(in_features: int = 6, num_classes: int = 14):
    specs, width = [], in_features
    for s, (_, _, widths) in enumerate(PNPP_SA, start=1):
        specs += _mlp_specs(f"sa{s}.point_net", 3 + width, widths)
        width = widths[-1]
    for i, (fin, widths) in enumerate(PNPP_FP):
        specs += _mlp_specs(f"fp{4 - i}.point_net", fin, widths)
    specs += [("conv.weight", (num_classes, 128), 128), ("conv.bias", (num_classes,), 128)]
    return specs


def dgcnn_specs(k: int = 20, emb_dims: int = 1024, num_classes: int = 14):
    specs = []
    for i, (fin, fout) in enumerate(((3, 64), (64, 64), (64, 64), (64, 128)), start=1):
        specs += [(f"conv{i}.w_edge.weight", (fout, fin), 2 * fin),
                  (f"conv{i}.w_center.weight", (fout, fin), 2 * fin),
                  (f"conv{i}.bn.weight", (fout,), "ones"), (f"conv{i}.bn.bias", (fout,), "zeros")]
    specs += _mlp_specs("color_conv", 3, (64,), bias=False)
    specs += _mlp_specs("conv5", 384, (emb_dims,), bias=False)
    specs += _mlp_specs("conv6", 384 + emb_dims, (512,), bias=False)
    specs += _mlp_specs("conv7", 512, (256,), bias=False)
    specs += [("conv8.weight", (num_classes, 256), 256), ("conv8.bias", (num_classes,), 256)]
    return specs


def make_weights(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights from `seed`, made on `device` in one draw: a Linear's weight
    and bias uniform in +-1/sqrt(fan_in) (PyTorch's default), BatchNorm's
    scale 1 and shift 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, init in specs if not isinstance(init, str)]
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = ((2.0 * u[at:at + n] - 1.0) / math.sqrt(init)).reshape(shape)
            at += n
    return out


def batch_norm(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """Training-mode BatchNorm over every axis but the last, biased variance."""
    rows = x.reshape(-1, x.shape[-1])
    mean = rows.mean(dim=0)
    var = (rows - mean).square().mean(dim=0)
    y = (rows - mean) * torch.rsqrt(var + BN_EPS) * weight + bias
    return y.reshape(x.shape)


def _mlp(p, prefix: str, x: torch.Tensor, n: int, act=F.relu, bias: bool = True):
    for i in range(n):
        x = F.linear(x, p[f"{prefix}.conv.{i}.weight"],
                     p[f"{prefix}.conv.{i}.bias"] if bias else None)
        x = act(batch_norm(x, p[f"{prefix}.batch.{i}.weight"], p[f"{prefix}.batch.{i}.bias"]))
    return x


def pointnet2_ssg(p, x: torch.Tensor, fps_gen: torch.Generator, dropout: bool = True):
    """(B, N, 9) -> (B, N, classes) logits. FPS starts are drawn from
    `fps_gen`, one (B,) draw a stage, uniform over the stage's points."""
    xyz, feats = x[..., :3], x[..., 3:]
    levels = [(xyz, feats)]
    for s, (C, radius, widths) in enumerate(PNPP_SA, start=1):
        B, N, _ = xyz.shape
        start = torch.randint(0, N, (B,), generator=fps_gen, device=fps_gen.device)
        centroids = select.gather(xyz, select.fps(xyz, C, start.to(xyz.device)))
        idx = select.ball_query(centroids, xyz, radius, PNPP_K)
        rel = select.gather(xyz, idx) - centroids[:, :, None, :]
        grouped = torch.cat([rel, select.gather(feats, idx)], dim=-1)
        feats = _mlp(p, f"sa{s}.point_net", grouped, len(widths)).amax(dim=2)
        xyz = centroids
        levels.append((xyz, feats))
    f = levels[4][1]
    for i, (_, widths) in enumerate(PNPP_FP):
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


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _edge_conv(p, i: int, x: torch.Tensor, k: int) -> torch.Tensor:
    idx = select.knn(x, k)
    nbrs = select.gather(x, idx)
    center = x[:, :, None, :].expand_as(nbrs)
    edges = torch.cat([nbrs - center, center], dim=-1)
    w = torch.cat([p[f"conv{i}.w_edge.weight"], p[f"conv{i}.w_center.weight"]], dim=1)
    e = batch_norm(F.linear(edges, w), p[f"conv{i}.bn.weight"], p[f"conv{i}.bn.bias"])
    return _lrelu(e).amax(dim=2)


def dgcnn(p, x: torch.Tensor, fps_gen=None, k: int = 20, dropout: bool = True):
    """(B, N, 9) -> (B, N, classes) logits (xyz builds the first graph, rgb
    feeds the colour branch)."""
    x1 = _edge_conv(p, 1, x[..., :3], k)
    x2 = _edge_conv(p, 2, x1, k)
    x3 = _edge_conv(p, 3, x2, k)
    x4 = _edge_conv(p, 4, x3, k)
    color = _mlp(p, "color_conv", x[..., 3:6], 1, _lrelu, bias=False)
    cat = torch.cat([x1, x2, x3, x4, color], dim=-1)
    x5 = _mlp(p, "conv5", cat, 1, _lrelu, bias=False)
    h = _mlp(p, "conv6", torch.cat([cat, x5], dim=-1), 1, _lrelu, bias=False)
    if dropout:
        h = F.dropout(h, 0.5, training=True)
    h = _mlp(p, "conv7", h, 1, _lrelu, bias=False)
    if dropout:
        h = F.dropout(h, 0.5, training=True)
    return F.linear(h, p["conv8.weight"], p["conv8.bias"])


ARCHS = {
    "pointnet2_ssg": (pointnet2_ssg_specs, pointnet2_ssg),
    "dgcnn": (dgcnn_specs, dgcnn),
}
