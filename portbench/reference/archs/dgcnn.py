"""DGCNN with colour for semantic segmentation (Wang et al. 2019,
arXiv:1801.07829; the reference repo's DeepGraphCnn): four EdgeConvs,
each kNN on the layer's input -> a bias-free Linear over the (B, N, k,
2F) edge features cat(x_j - x_i, x_i) -> BatchNorm over every edge ->
LeakyReLU(0.2) -> max over the neighbours, a colour branch, and the
1024-wide embedding and the 512-256-classes head with dropout."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import select
from portbench.reference.models import _mlp, _mlp_specs, batch_norm

EDGE_CONVS = ((3, 64), (64, 64), (64, 64), (64, 128))


def specs(k: int = 20, emb_dims: int = 1024, num_classes: int = 14):
    out = []
    for i, (fin, fout) in enumerate(EDGE_CONVS, start=1):
        out += [(f"conv{i}.w_edge.weight", (fout, fin), 2 * fin),
                (f"conv{i}.w_center.weight", (fout, fin), 2 * fin),
                (f"conv{i}.bn.weight", (fout,), "ones"), (f"conv{i}.bn.bias", (fout,), "zeros")]
    out += _mlp_specs("color_conv", 3, (64,), bias=False)
    out += _mlp_specs("conv5", 384, (emb_dims,), bias=False)
    out += _mlp_specs("conv6", 384 + emb_dims, (512,), bias=False)
    out += _mlp_specs("conv7", 512, (256,), bias=False)
    out += [("conv8.weight", (num_classes, 256), 256), ("conv8.bias", (num_classes,), 256)]
    return out


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


def forward(p, x: torch.Tensor, fps_gen=None, k: int = 20, dropout: bool = True):
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


def forward_flops(B: int, N: int, k: int = 20, emb_dims: int = 1024,
                  num_classes: int = 14) -> float:
    """`k` changes no Linear's work: an EdgeConv's two products run once a
    point, and the kNN's Gram products are the op's work."""
    rows = B * N
    flops = 0.0
    for fin, fout in EDGE_CONVS:
        flops += 2.0 * rows * fin * fout * 2  # W_e x_j and W_c x_i, once a point each
    flops += 2.0 * rows * 3 * 64  # colour branch
    flops += 2.0 * rows * (384 * emb_dims + (384 + emb_dims) * 512 + 512 * 256
                           + 256 * num_classes)
    return flops
