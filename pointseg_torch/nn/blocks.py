"""Network blocks (port of `GroupedFirstLayer`, `SetAbstraction`,
`FeaturePropagation`, `_BNStats` and `EdgeConv` from
`pointseg/nn/blocks.py`).

FPS takes its start from the `generator` a caller passes (the training
step passes one; evaluation passes none and starts at 0), where the JAX
package reads the flax 'fps' stream.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pointseg_torch import ops
from pointseg_torch.nn.mlp import BatchNorm, SharedMLP, leaky_relu_02


class GroupedFirstLayer(SharedMLP):
    """Shared MLP over ball-query regions whose first layer runs in
    pre-gather form.

    The first Linear acts on cat(rel_coords, features) (3 + D inputs) and
    distributes over the concatenation, W·cat(rel, f_j) = W_r·rel + W_f·f_j,
    so the feature product runs once per point before the gather instead
    of once per (centroid, neighbour) after it; `pointseg/nn/blocks.py`
    explains the saving. W_r and W_f are column slices of the one weight
    `conv.0.weight` (out, 3 + D), the reference's layout, so the gradient
    is that of the unsplit layer. W_r carries the bias.

    Where the JAX GroupedFirstLayer is that first layer alone and
    SetAbstraction adds a SharedMLP for the rest, this module carries all
    of the region MLP's layers (`widths`), so that its keys are the
    reference's `point_net.conv.i` / `point_net.batch.i`. With one width
    it is exactly the JAX GroupedFirstLayer.

    forward(centroids (B, C, 3), coords (B, N, 3), features (B, N, D))
    -> (B, C, K, widths[-1]).
    """

    def __init__(self, in_features: int, widths: Sequence[int], radius: float,
                 K: int, normalize: bool = False):
        super().__init__(3 + in_features, widths)
        self.radius = radius
        self.K = K
        self.normalize = normalize

    def forward(self, centroids, coords, features, mask=None):
        idx, _ = ops.ball_query(centroids, coords, self.radius, self.K, mask=mask)
        first = self.conv[0]
        w_rel, w_feat = first.weight[:, :3], first.weight[:, 3:]
        hfeat = F.linear(features, w_feat)  # (B, N, h): per point, before the gather
        gfeat, gcoords = ops.gather_rows_with_coords(hfeat, coords, idx)
        rel = gcoords - centroids[:, :, None, :]
        if self.normalize:
            rel = rel / self.radius
        x = F.relu(self.batch[0](gfeat + F.linear(rel, w_rel, first.bias)))
        for conv, bn in zip(self.conv[1:], self.batch[1:]):
            x = F.relu(bn(conv(x)))
        return x


class SetAbstraction(torch.nn.Module):
    """FPS -> ball-query regions -> shared MLP -> max/avg pool.

    forward(coords (B, N, 3), features (B, N, D)) ->
    (centroids (B, C, 3), features (B, C, mlps[-1])).
    """

    def __init__(self, num_centroids: int, radius: float, in_features: int,
                 mlps: Sequence[int], K: int = 32, pooling: str = "max",
                 grouping_norm: bool = False):
        super().__init__()
        self.num_centroids = num_centroids
        self.pooling = pooling
        self.point_net = GroupedFirstLayer(in_features, mlps, radius, K,
                                           normalize=grouping_norm)

    def forward(self, coords, features, mask=None, generator=None):
        idx = ops.farthest_point_sampling(
            coords, self.num_centroids, generator=generator, mask=mask)
        centroids = ops.gather_rows(coords, idx)
        regions = self.point_net(centroids, coords, features, mask=mask)
        return centroids, ops.reduce(regions, self.pooling, dim=2)


class FeaturePropagation(torch.nn.Module):
    """3-NN inverse-distance upsampling + skip concat + per-point MLP.

    forward(coords_tgt, coords_src, skip, features) follows the JAX
    block's argument order.
    """

    def __init__(self, in_features: int, mlps: Sequence[int]):
        super().__init__()
        self.point_net = SharedMLP(in_features, mlps)

    def forward(self, coords_tgt, coords_src, skip, features):
        upsampled = ops.interpolate(features, coords_tgt, coords_src)
        if skip is not None:
            upsampled = torch.cat([skip, upsampled], dim=-1)
        return self.point_net(upsampled)


class BNStats(BatchNorm):
    """BatchNorm parameters and running statistics for a block that
    computes its batch statistics analytically instead of from a
    materialised input (port of `_BNStats`).

    `stats(batch_mean, batch_var)` returns (scale, bias, mean, var): in
    training mode the given batch statistics, folded into the running
    ones by `BatchNorm`'s rule (biased variance, momentum 0.1 = flax's
    0.9); in eval mode, or with no batch statistics, the running ones.
    Called on a tensor it is the ordinary `BatchNorm`, so one module and
    one set of state_dict keys (`nn.BatchNorm1d`'s) serve both forms of
    `EdgeConv`.
    """

    def stats(self, batch_mean: torch.Tensor | None, batch_var: torch.Tensor | None):
        if not self.training or batch_mean is None:
            return self.weight, self.bias, self.running_mean, self.running_var
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(batch_mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(batch_var, alpha=m)
            self.num_batches_tracked.add_(1)
        return self.weight, self.bias, batch_mean, batch_var


class EdgeConv(torch.nn.Module):
    """DGCNN edge convolution: kNN graph -> edge features
    cat(x_j - x_i, x_i) -> bias-free Linear + BatchNorm + LeakyReLU(0.2)
    -> max over the neighbours (port of `EdgeConv`).

    Pre-gather form: the bias-free Linear distributes over the concat,
    W·cat(x_j - x_i, x_i) = W_e·x_j + (W_c - W_e)·x_i, so both products
    run per point before the neighbour gather and the gathered rows carry
    `out_channels`. The parameters stay in the reference's (W_e, W_c)
    coordinates, two bias-free Linears `w_edge` and `w_center`, and the
    centre offset is formed as d = w_center(x) - w_edge(x): storing
    W_c - W_e instead computes the same function with other gradients,
    hence another Adam trajectory.

    `fused=True` (default) never forms the (B, N, k, out) edge tensor
    e_ij = p_j + d_i. BatchNorm + LeakyReLU is a per-channel monotone
    map, increasing or decreasing with the sign of the BatchNorm slope,
    so max_j act(bn(p_j + d_i)) = act(bn(M_i + d_i)) with M_i the max or
    the min of p_j over the neighbourhood, and the training statistics
    over all B·N·k edges follow from the neighbour sums
    s_i = sum_j p_j and q_i = sum_j p_j²:
        sum e  = sum_i (s_i + k d_i),
        sum e² = sum_i (q_i + 2 d_i s_i + k d_i²),
    with var = max(E[e²] - E[e]², 0), the JAX block's form. `fused=False`
    gathers, adds, normalises and reduces the edge tensor itself. Both
    give the same output and running statistics up to reassociation.

    `remat=True` re-gathers in the backward pass
    (`torch.utils.checkpoint`) instead of keeping the gathered
    (B, N, k, out) rows.

    forward(x (B, N, F)) -> (B, N, out_channels). `idx` (B, N, k) reuses
    a graph (the static-graph mode); `knn_on` builds the graph from
    another array than `x`; `mask` (B, N) reaches the kNN only.
    """

    def __init__(self, in_features: int, out_channels: int, k: int = 20,
                 fused: bool = True, remat: bool = False, knn_select: str = "flat"):
        super().__init__()
        self.k = k
        self.fused = fused
        self.remat = remat
        self.knn_select = knn_select
        self.w_edge = torch.nn.Linear(in_features, out_channels, bias=False)
        self.w_center = torch.nn.Linear(in_features, out_channels, bias=False)
        self.bn = BNStats(out_channels)

    def _gather_reduce(self, p: torch.Tensor, idx: torch.Tensor):
        gp = ops.gather_neighbors(p, idx)  # (B, N, k, out)
        out = (gp.amax(dim=2), gp.amin(dim=2))
        if self.training:
            out += (gp.sum(dim=2), (gp * gp).sum(dim=2))
        return out

    def forward(self, x, knn_on=None, mask=None, idx=None):
        if idx is None:
            idx = ops.knn_indices(x if knn_on is None else knn_on, self.k, mask=mask,
                                  select=self.knn_select)
        p = self.w_edge(x)  # (B, N, out)
        d = self.w_center(x) - p
        if not self.fused:
            edges = ops.gather_neighbors(p, idx) + d[:, :, None, :]
            return leaky_relu_02(self.bn(edges)).amax(dim=2)

        if self.remat:
            reduced = checkpoint(self._gather_reduce, p, idx, use_reentrant=False)
        else:
            reduced = self._gather_reduce(p, idx)
        g_max, g_min = reduced[0], reduced[1]
        mean = var = None
        if self.training:
            s, q = reduced[2], reduced[3]
            count = p.shape[0] * p.shape[1] * self.k
            mean = (s + self.k * d).sum(dim=(0, 1)) / count
            ex2 = (q + 2.0 * d * s + self.k * d * d).sum(dim=(0, 1)) / count
            var = torch.clamp_min(ex2 - mean * mean, 0.0)
        scale, bias, mean, var = self.bn.stats(mean, var)
        t = scale * torch.rsqrt(var + self.bn.eps)  # per-channel slope
        extreme = torch.where(t >= 0, g_max, g_min) + d  # where the affine map peaks
        return leaky_relu_02((extreme - mean) * t + bias)
