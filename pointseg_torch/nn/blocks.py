"""Network blocks (port of `GroupedFirstLayer`, `SetAbstraction`,
`SetAbstractionMSG`, `FeaturePropagation`, `InvResMLP`, `_BNStats`,
`EdgeConv` and `TNet` from `pointseg/nn/blocks.py`).

FPS takes its start from the `generator` a caller passes (the training
step passes one; evaluation passes none and starts at 0), where the JAX
package reads the flax 'fps' stream. The blocks that group by ball query
take `filler` ('repeat' or 'index', what fills a sparse ball) and hand it
to `ops.ball_query`; the JAX package sets it process-wide.

Every block takes `dtype`, the compute dtype of `nn/mlp.py`. Under
bfloat16 features flow in bfloat16 and coordinates stay float32: FPS,
ball query and 3-NN see only coordinates, and relative coordinates are
cast after the division by the radius, as in the JAX blocks.

Inside `parallel.points.use_points(mesh)` (the point-sharded forward,
eval mode) each block takes and returns this rank's rows of every cloud
and gathers the whole level where it needs neighbours
(`parallel/points.py` says which block does what). A layer split by
tensor parallelism (`parallel/tensor_parallel.py`) computes with its
shard inside `nn/mlp.py`'s Linear and BatchNorm; the GroupedFirstLayer's
first layer, which distributes over the gather, does so here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pointseg_torch import ops
from pointseg_torch.nn.mlp import BatchNorm, Linear, SharedMLP, cast, leaky_relu_02
from pointseg_torch.parallel import points as pts
from pointseg_torch.parallel import tensor_parallel as tp_ops
from pointseg_torch.parallel.mesh import active, all_reduce_sum
from pointseg_torch.utils.trace import span


class GroupedFirstLayer(SharedMLP):
    """Shared MLP over ball-query regions whose first layer runs in
    pre-gather form.

    The first Linear acts on cat(rel_coords, features) (3 + D inputs) and
    distributes over the concatenation, W·cat(rel, f_j) = W_r·rel + W_f·f_j,
    so the feature product runs once per point before the gather instead
    of once per (centroid, neighbour) after it; `pointseg/nn/blocks.py`
    explains the saving. W_r and W_f are column slices of the one weight
    `conv.0.weight` (out, 3 + D), the reference's layout, so the gradient
    is that of the unsplit layer. W_r carries the bias; `bias=False` makes
    every layer bias-free (openpoints' convolutions before a BatchNorm).

    Where the JAX GroupedFirstLayer is that first layer alone and
    SetAbstraction adds a SharedMLP for the rest, this module carries all
    of the region MLP's layers (`widths`), so that its keys are the
    reference's `point_net.conv.i` / `point_net.batch.i`. With one width
    it is exactly the JAX GroupedFirstLayer.

    forward(centroids (B, C, 3), coords (B, N, 3), features (B, N, D))
    -> (B, C, K, widths[-1]).
    """

    def __init__(self, in_features: int, widths: Sequence[int], radius: float,
                 K: int, normalize: bool = False, filler: str = "repeat",
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(3 + in_features, widths, use_bias=bias, dtype=dtype)
        self.radius = radius
        self.K = K
        self.normalize = normalize
        self.filler = filler

    def forward(self, centroids, coords, features, mask=None):
        idx, _ = ops.ball_query(centroids, coords, self.radius, self.K, mask=mask,
                                filler=self.filler)
        first, dtype, plan = self.conv[0], self.dtype, self.conv[0].tp
        weight = cast(first.weight, dtype)
        w_rel, w_feat = weight[:, :3], weight[:, 3:]
        features = cast(features, dtype)
        # (B, N, h): per point, before the gather; split over a model axis, the
        # rank's output channels of both products ('column', gathered after the
        # sum) or w_feat's partial product over the rank's input channels
        if plan is not None and plan.mode == "column":
            hfeat = F.linear(tp_ops.sum_grad(features, plan), w_feat)
        elif plan is not None:
            hfeat = tp_ops.reduce_sum(F.linear(tp_ops.take_share(features, plan), w_feat), plan)
        else:
            hfeat = F.linear(features, w_feat)
        gfeat, gcoords = ops.gather_rows_with_coords(hfeat, coords, idx)
        rel = gcoords - centroids[:, :, None, :]
        if self.normalize:
            rel = rel / self.radius
        rel = cast(rel, dtype)  # float32 up to here, as in the JAX block
        x = gfeat + F.linear(rel, w_rel, None if first.bias is None else cast(first.bias, dtype))
        if plan is not None and plan.mode == "column":
            x = tp_ops.gather(x, plan)
        x = F.relu(self.batch[0](x))
        for conv, bn in zip(self.conv[1:], self.batch[1:]):
            x = F.relu(bn(conv(x)))
        return x


class SetAbstraction(torch.nn.Module):
    """FPS -> ball-query regions -> shared MLP -> max/avg pool.

    `num_centroids` is C; with `stride` (and `num_centroids` None) C is
    each level's N // stride, openpoints' strided stages. `bias=False`
    makes the region MLP bias-free.

    forward(coords (B, N, 3), features (B, N, D)) ->
    (centroids (B, C, 3), features (B, C, mlps[-1])).
    """

    def __init__(self, num_centroids: int | None, radius: float, in_features: int,
                 mlps: Sequence[int], K: int = 32, pooling: str = "max",
                 grouping_norm: bool = False, filler: str = "repeat",
                 dtype: torch.dtype = torch.float32, stride: int | None = None,
                 bias: bool = True):
        super().__init__()
        if (num_centroids is None) == (stride is None):
            raise ValueError("give num_centroids or stride, not both or neither")
        self.num_centroids = num_centroids
        self.stride = stride
        self.pooling = pooling
        self.point_net = GroupedFirstLayer(in_features, mlps, radius, K,
                                           normalize=grouping_norm, filler=filler,
                                           dtype=dtype, bias=bias)

    def forward(self, coords, features, mask=None, generator=None):
        centroids, coords, features, mask = _centroids(self.num_centroids, coords, features,
                                                       mask, generator, self.stride)
        regions = self.point_net(centroids, coords, features, mask=mask)
        return centroids, ops.reduce(regions, self.pooling, dim=2)


def _centroids(num_centroids, coords, features, mask, generator, stride=None):
    """FPS and its centroids (`num_centroids`, or the whole level's
    N // `stride`). Point-sharded (`parallel/points.py`): on the whole
    level, gathered, the centroids this rank's share; returns (centroids,
    coords, features, mask) with the level whole."""
    split = pts.point_split()
    if split is not None:
        if mask is not None:
            raise ValueError("the point-sharded forward takes no mask")
        coords, features = pts.gather(split, coords, features)
    if stride is not None:
        num_centroids = coords.shape[1] // stride
    idx = ops.farthest_point_sampling(coords, num_centroids, generator=generator, mask=mask)
    centroids = ops.gather_rows(coords, idx)
    if split is not None:
        centroids = pts.share(centroids, split)
    return centroids, coords, features, mask


class SetAbstractionMSG(torch.nn.Module):
    """Multi-scale grouping: one FPS, one ball query and region MLP per
    (radius, K, widths) scale, each pooled, the scales concatenated.

    forward(coords (B, N, 3), features (B, N, D)) ->
    (centroids (B, C, 3), features (B, C, sum of the scales' last widths)).
    The JAX block's `scale_{s}_0` and `scale_{s}` are `scales.{s}` here.
    """

    def __init__(self, num_centroids: int, radii: Sequence[float], Ks: Sequence[int],
                 in_features: int, mlps: Sequence[Sequence[int]], pooling: str = "max",
                 filler: str = "repeat", dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(radii) == len(Ks) == len(mlps):
            raise ValueError("radii, Ks and mlps need one entry per scale, got "
                             f"{len(radii)}, {len(Ks)} and {len(mlps)}")
        self.num_centroids = num_centroids
        self.pooling = pooling
        self.scales = torch.nn.ModuleList(
            GroupedFirstLayer(in_features, widths, r, k, filler=filler, dtype=dtype)
            for r, k, widths in zip(radii, Ks, mlps))

    def forward(self, coords, features, mask=None, generator=None):
        centroids, coords, features, mask = _centroids(self.num_centroids, coords, features,
                                                       mask, generator)
        pooled = [ops.reduce(scale(centroids, coords, features, mask=mask), self.pooling, dim=2)
                  for scale in self.scales]
        return centroids, torch.cat(pooled, dim=-1)


class FeaturePropagation(torch.nn.Module):
    """3-NN inverse-distance upsampling + skip concat + per-point MLP.

    forward(coords_tgt, coords_src, skip, features) follows the JAX
    block's argument order. `bias=False` makes the MLP bias-free.
    """

    def __init__(self, in_features: int, mlps: Sequence[int],
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.point_net = SharedMLP(in_features, mlps, use_bias=bias, dtype=dtype)

    def forward(self, coords_tgt, coords_src, skip, features):
        split = pts.point_split()
        if split is not None:  # this rank's targets against the whole sources
            coords_src, features = pts.gather(split, coords_src, features)
        upsampled = ops.interpolate(features, coords_tgt, coords_src)
        if skip is not None:
            upsampled = torch.cat([skip, upsampled], dim=-1)
        return self.point_net(upsampled)


class InvResMLP(torch.nn.Module):
    """PointNeXt inverted-residual block: ball-query regions around every
    point itself (centroids == coords, relative coordinates divided by the
    radius) -> one grouped layer -> pool -> point MLP (4m -> m) ->
    residual add.

    By default both point layers end in ReLU and the sum has none (the
    reference repo's block). `residual_act=True` is the published order
    (Qian et al. 2022; openpoints' `InvResMLP`): the second point layer
    ends at its BatchNorm and ReLU follows the residual add.
    `bias=False` makes every layer bias-free. Each forward runs inside the
    span `pointseg_torch.model.invres` (`utils/trace.py`).

    forward(coords (B, N, 3), features (B, N, m)) -> (coords, (B, N, m)).
    The submodule names are the reference torch model's.
    """

    def __init__(self, radius: float, mlp_size: int, K: int, pooling: str = "max",
                 filler: str = "repeat", dtype: torch.dtype = torch.float32,
                 residual_act: bool = False, bias: bool = True):
        super().__init__()
        self.pooling = pooling
        self.residual_act = residual_act
        self.neighbour_features_mlp = GroupedFirstLayer(
            mlp_size, [mlp_size], radius, K, normalize=True, filler=filler, dtype=dtype,
            bias=bias)
        self.point_features_mlp = SharedMLP(mlp_size, [4 * mlp_size, mlp_size],
                                            use_bias=bias, dtype=dtype,
                                            last_act=not residual_act)

    def forward(self, coords, features, mask=None):
        with span("pointseg_torch.model.invres"):
            table, table_features = coords, features
            split = pts.point_split()
            if split is not None:  # this rank's points against the whole level
                table, table_features = pts.gather(split, coords, features)
            h = self.neighbour_features_mlp(coords, table, table_features, mask=mask)
            h = self.point_features_mlp(ops.reduce(h, self.pooling, dim=2)) + features
            return coords, F.relu(h) if self.residual_act else h


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
    `EdgeConv`. The batch statistics it is given are float32, whatever
    the block's compute dtype.
    """

    def stats(self, batch_mean: torch.Tensor | None, batch_var: torch.Tensor | None):
        if not self.training or batch_mean is None:
            return self.whole(True)
        self.fold(batch_mean, batch_var)
        weight, bias, _, _ = self.whole(False)
        return weight, bias, batch_mean, batch_var


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
    e_ij = p_j + d_i, and on the card not the gathered rows p_j either
    (`ops.edge_reduce`: one kernel for the max, the min and the sums over
    the neighbours, one for their backward). BatchNorm + LeakyReLU is a
    per-channel monotone map, increasing or decreasing with the sign of
    the BatchNorm slope, so max_j act(bn(p_j + d_i)) = act(bn(M_i + d_i))
    with M_i the max or the min of p_j over the neighbourhood, and the
    training statistics over all B·N·k edges follow from the neighbour
    sums s_i = sum_j p_j and q_i = sum_j p_j²:
        sum e  = sum_i (s_i + k d_i),
        sum e² = sum_i (q_i + 2 d_i s_i + k d_i²),
    with var = max(E[e²] - E[e]², 0), the JAX block's form. Inside a
    data-parallel step (`parallel/mesh.py`) the two channel sums and the
    edge count are the global batch's, all-reduced with the gradient
    flowing through the sum; `fused=False` takes its statistics from
    `BatchNorm`, global there too. `fused=False`
    gathers, adds, normalises and reduces the edge tensor itself. Both
    give the same output and running statistics up to reassociation.

    Under bfloat16 (`dtype`) `x` is cast first, so the kNN of layers 2-4
    ranks bfloat16-rounded features (in float32), p, d and the neighbour
    maxima and minima are bfloat16, and the output is bfloat16. The sums
    s and q are taken in float32, as flax's BatchNorm takes every other
    layer's statistics: the JAX block sums them into bfloat16, where
    E[e²] - E[e]² cancels.

    `remat=True` re-runs the gather-reduce in the backward pass
    (`torch.utils.checkpoint`) instead of keeping what it saves: on the
    card the table, max, min and tie counts, on the CPU the gathered
    (B, N, k, out) rows.

    forward(x (B, N, F)) -> (B, N, out_channels). `idx` (B, N, k) reuses
    a graph (the static-graph mode); `knn_on` builds the graph from
    another array than `x`; `mask` (B, N) reaches the kNN only.
    """

    def __init__(self, in_features: int, out_channels: int, k: int = 20,
                 fused: bool = True, remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.fused = fused
        self.remat = remat
        self.dtype = dtype
        self.w_edge = Linear(in_features, out_channels, bias=False, dtype=dtype)
        self.w_center = Linear(in_features, out_channels, bias=False, dtype=dtype)
        self.bn = BNStats(out_channels, dtype=dtype)

    def forward(self, x, knn_on=None, mask=None, idx=None):
        x = cast(x, self.dtype)
        split = pts.point_split()
        if split is not None:  # this rank's rows' neighbours in the whole table
            if mask is not None:
                raise ValueError("the point-sharded forward takes no mask")
            table = pts.gather(split, x)[0]
            if idx is None:
                on = table if knn_on is None else pts.gather(split, knn_on)[0]
                idx = pts.share(ops.knn_indices(on, self.k), split)
            p_table = self.w_edge(table)
            p = pts.share(p_table, split)
        else:
            if idx is None:
                idx = ops.knn_indices(x if knn_on is None else knn_on, self.k, mask=mask)
            p_table = p = self.w_edge(x)  # (B, N, out)
        d = self.w_center(x) - p
        if not self.fused:
            edges = ops.gather_neighbors(p_table, idx) + d[:, :, None, :]
            return leaky_relu_02(self.bn(edges)).amax(dim=2)

        # max and min over the neighbours, and in training the sums (float32)
        if self.remat:
            reduced = checkpoint(ops.edge_reduce, p_table, idx, self.bn.training,
                                 use_reentrant=False)
        else:
            reduced = ops.edge_reduce(p_table, idx, self.bn.training)
        g_max, g_min = reduced[0], reduced[1]
        mean = var = None
        if self.bn.training:  # batch statistics follow the BatchNorm's mode
            s, q = reduced[2], reduced[3]
            count = p.shape[0] * p.shape[1] * self.k
            df = d.to(s.dtype)
            sum_e = (s + self.k * df).sum(dim=(0, 1))
            sum_e2 = (q + 2.0 * df * s + self.k * df * df).sum(dim=(0, 1))
            mesh = active()
            if mesh is not None:  # the global batch's sums and edge count
                sum_e, sum_e2, count = all_reduce_sum(
                    torch.cat([sum_e, sum_e2, sum_e.new_full((1,), count)]), mesh
                ).split([sum_e.shape[0], sum_e.shape[0], 1])
            mean = sum_e / count
            ex2 = sum_e2 / count
            var = torch.clamp_min(ex2 - mean * mean, 0.0)
        scale, bias, mean, var = self.bn.stats(mean, var)
        t = scale * torch.rsqrt(var + self.bn.eps)  # per-channel slope
        extreme = torch.where(t >= 0, g_max, g_min) + d  # where the affine map peaks
        # float32 statistics promote the tail; the output is in the compute dtype
        return cast(leaky_relu_02((extreme - mean) * t + bias), self.dtype)


class TNet(torch.nn.Module):
    """PointNet's spatial transformer: per-point MLP 64-128-1024 with
    BatchNorm and ReLU, a max-pool over the points (masked with `mask`
    (B, N)), FC 512-256 with BatchNorm and ReLU, then Linear(k*k) plus
    the identity: (B, N, k) -> (B, k, k).

    The JAX TNet holds two SharedMLPs and a Dense; this one holds named
    layers (`conv1..3`, `fc1..3`, `bn1..5`), the reference torch key
    layout that `pointseg/io/torch_import.py` reads. The FC layers'
    BatchNorm normalises over the B rows of the pooled (B, C) feature.
    """

    def __init__(self, k: int = 9, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.dtype = dtype

        def linear(i, o):
            return Linear(i, o, dtype=dtype)

        def norm(c):
            return BatchNorm(c, dtype=dtype)

        self.conv1, self.conv2, self.conv3 = linear(k, 64), linear(64, 128), linear(128, 1024)
        self.fc1, self.fc2, self.fc3 = linear(1024, 512), linear(512, 256), linear(256, k * k)
        self.bn1, self.bn2, self.bn3 = norm(64), norm(128), norm(1024)
        self.bn4, self.bn5 = norm(512), norm(256)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(cast(x, self.dtype))))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = torch.amax(x, dim=1) if mask is None else ops.masked_reduce(x, mask, "max", dim=1)
        split = pts.point_split()
        if split is not None:  # the whole cloud's maximum
            x = pts.global_max(x, split)
        x = F.relu(self.bn4(self.fc1(x)))
        x = F.relu(self.bn5(self.fc2(x)))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, self.k * self.k)
        return (self.fc3(x) + eye).reshape(-1, self.k, self.k)
