"""EdgeConv's gather-reduce kernel pair (`csrc/edgereduce.cu`) against its
plain version, on the card, with and without the per-centre offset that
PointNeXt's InvResMLP grouped layer passes.

Every test here needs a CUDA device and skips without one. The file
imports no JAX; run it on the card with the other kernel tests:

    python -m pytest --noconftest -m cuda tests/test_torch_edgereduce_cuda.py

The max and the min are values of the table, so they must be equal bit
for bit, and the tie counts exactly; the float32 sums are taken in
another order than `torch.sum`'s (relative 1e-5). The backward adds with
atomics in float32 on both sides (`index_add_` in the plain version), so
float32 gradients are compared to 1e-5 of their largest; a bfloat16
table's gradient is held to the float64 gradient of the same bf16 rows
within one bfloat16 rounding. Ties are forced: integer-valued rows (many
equal values a channel), duplicated table rows and a repeated index in
every neighbour list, so that the even split of the max's and the min's
gradient is exercised. With an offset the table and the offset are both
integer-valued, so every row x = p + d is exact and the ties survive.
"""

import numpy as np
import pytest
import torch

from pointseg_torch.models import create_model
from pointseg_torch.nn import EdgeConv, InvResMLP
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.edgereduce import (
    _edge_reduce_cuda,
    count_dtype,
    edge_reduce,
    edge_reduce_plain,
)
from pointseg_torch.ops.gather import gather_rows_plain
from pointseg_torch.train.state import STEP_GRAPHS, create_train_state, train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, M, N, k, C, ties, device):
    """(table (B, N, C), idx (B, M, k) int32, four output weights (B, M, C))."""
    rng = np.random.default_rng(seed)
    if ties:  # small integers: many equal values in a channel's neighbourhood
        table = rng.integers(-3, 4, size=(B, N, C)).astype(np.float32)
        table[:, N // 2:] = table[:, : N - N // 2]  # duplicated rows
    else:
        table = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, (B, M, k)).astype(np.int32)
    if ties and k > 1:
        idx[..., 1] = idx[..., 0]  # a repeated index in every list
    # multiples of 1/8 below 32 in magnitude: exact in bfloat16
    weights = [np.round(rng.normal(size=(B, M, C)) * 8) / 8 for _ in range(4)]
    return (torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device),
            [torch.from_numpy(w.astype(np.float32)).to(device) for w in weights])


# (B, M, N, k, C): the cell's widths at 1,024 points, M != N (a rank's rows
# against the gathered table), the enhanced trainer's k, C = 13 and 6 (narrow
# vectors), one channel, and k > 255 (4-byte tie counts)
SHAPES = [(2, 1024, 1024, 20, 64), (2, 1024, 1024, 20, 128), (2, 512, 2048, 20, 64),
          (2, 1024, 1024, 40, 64), (2, 1024, 1024, 20, 13), (3, 100, 300, 7, 6),
          (2, 64, 64, 5, 1), (1, 64, 512, 300, 16)]


def _counts(table, idx, vmax, vmin):
    gp = gather_rows_plain(table, idx)
    return ((gp == vmax[:, :, None]).sum(2), (gp == vmin[:, :, None]).sum(2))


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,N,k,C", SHAPES)
def test_edge_reduce_forward_matches_plain(device, B, M, N, k, C, dtype, ties, sums):
    table, idx, _ = _inputs(1, B, M, N, k, C, ties, device)
    table = table.to(dtype)
    before = dict(_kernels.LAUNCHES)
    got = _edge_reduce_cuda(table, idx, sums, counts=True)
    assert _kernels.LAUNCHES["edge_reduce"] == before["edge_reduce"] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    want = edge_reduce_plain(table, idx, sums)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == dtype and got[0].shape == (B, M, C)
    if sums:
        for g, w in zip(got[2:4], want[2:4]):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    else:
        assert got[2] is None and got[3] is None
    cmax, cmin = _counts(table, idx, want[0], want[1])
    assert got[4].dtype == got[5].dtype == count_dtype(k)
    assert torch.equal(got[4].long(), cmax) and torch.equal(got[5].long(), cmin)
    if ties:
        assert int(cmax.max()) > 1 and int(cmin.max()) > 1
    # the public call without a gradient: the same values, no counts kept
    for g, w in zip(edge_reduce(table, idx, sums), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,M,N,k,C", SHAPES)
def test_edge_reduce_backward_matches_autograd_of_plain(device, B, M, N, k, C, ties, sums):
    table, idx, weights = _inputs(2, B, M, N, k, C, ties, device)
    n_out = 4 if sums else 2
    t1 = table.clone().requires_grad_(True)
    before = _kernels.LAUNCHES["edge_reduce"]
    got = edge_reduce(t1, idx, sums)
    assert _kernels.LAUNCHES["edge_reduce"] == before + 1
    sum((o * w).sum() for o, w in zip(got, weights[:n_out])).backward()
    assert _kernels.LAUNCHES["edge_reduce"] == before + 2
    t2 = table.clone().requires_grad_(True)
    want = edge_reduce_plain(t2, idx, sums)
    sum((o * w).sum() for o, w in zip(want, weights[:n_out])).backward()
    scale = float(t2.grad.abs().max())
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("B,M,N,k,C", [(2, 1024, 1024, 20, 64), (2, 512, 2048, 20, 128),
                                       (2, 1024, 1024, 20, 13)])
def test_edge_reduce_bf16_backward_within_one_rounding_of_float64(device, B, M, N, k, C, sums):
    """bf16 rows, float32 sums and a float32 gradient cast once: within
    one bfloat16 rounding of the float64 gradient of the same rows."""
    table, idx, weights = _inputs(3, B, M, N, k, C, True, device)
    n_out = 4 if sums else 2
    t1 = table.to(torch.bfloat16).requires_grad_(True)
    got = edge_reduce(t1, idx, sums)
    assert got[0].dtype == torch.bfloat16
    sum((o.float() * w).sum() for o, w in zip(got, weights[:n_out])).backward()
    t2 = table.to(torch.bfloat16).double().requires_grad_(True)
    want = edge_reduce_plain(t2, idx, sums)
    sum((o * w.double()).sum() for o, w in zip(want, weights[:n_out])).backward()
    assert t1.grad.dtype == torch.bfloat16
    scale = float(t2.grad.abs().max())
    torch.testing.assert_close(t1.grad.double(), t2.grad, rtol=2.0 ** -8,
                               atol=1e-5 * max(scale, 1.0))


def test_edge_reduce_on_a_table_that_is_not_16_byte_aligned(device):
    """A table 4 bytes past a 16-byte boundary takes narrower vectors and
    gives the same values and gradient."""
    table, idx, weights = _inputs(4, 2, 256, 256, 20, 64, True, device)
    shifted = torch.empty(table.numel() + 1, device=device)[1:].view_as(table).copy_(table)
    assert shifted.data_ptr() % 16 != 0
    got = _edge_reduce_cuda(shifted, idx, True, counts=True)
    want = _edge_reduce_cuda(table, idx, True, counts=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    shifted.requires_grad_(True)
    sum((o * w).sum() for o, w in zip(edge_reduce(shifted, idx, True), weights))\
        .backward()
    t2 = table.clone().requires_grad_(True)
    sum((o * w).sum() for o, w in zip(edge_reduce_plain(t2, idx, True), weights))\
        .backward()
    torch.testing.assert_close(shifted.grad, t2.grad, rtol=1e-5,
                               atol=1e-5 * float(t2.grad.abs().max()))


def test_edge_reduce_routes_float64_to_the_plain_composition(device):
    table, idx, _ = _inputs(5, 2, 128, 128, 8, 16, False, device)
    before = dict(_kernels.LAUNCHES)
    got = edge_reduce(table.double(), idx, True)
    assert _kernels.LAUNCHES["edge_reduce"] == before["edge_reduce"]
    assert _kernels.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    for g, w in zip(got, edge_reduce_plain(table.double(), idx, True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("remat", [False, True])
def test_edgeconv_on_the_card_matches_the_cpu(device, train, remat):
    """The block's output, running statistics and gradients through the
    kernel pair against the plain composition on the CPU, on a given
    graph (no kNN near-tie can flip)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 1024, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 1024, (2, 1024, 20)).astype(np.int32))
    torch.manual_seed(0)
    cpu = EdgeConv(16, 64, 20, remat=remat).train(train)
    with torch.no_grad():
        cpu.bn.weight.copy_(torch.from_numpy(rng.uniform(-1.5, 1.5, 64).astype(np.float32)))
    card = EdgeConv(16, 64, 20, remat=remat).train(train)
    card.load_state_dict(cpu.state_dict())
    card.to(device)
    weight = torch.from_numpy(rng.normal(size=(2, 1024, 64)).astype(np.float32))
    outs, grads = [], []
    for block, where in ((cpu, torch.device("cpu")), (card, device)):
        tx = x.to(where, copy=True).requires_grad_(True)
        before = _kernels.LAUNCHES["edge_reduce"]
        out = block(tx, idx=idx.to(where))
        (out * weight.to(where)).sum().backward()
        launched = _kernels.LAUNCHES["edge_reduce"] - before
        assert launched == (0 if where.type == "cpu" else 3 if remat else 2)
        outs.append(out.detach().cpu())
        grads.append([t.cpu() for t in (tx.grad, block.w_edge.weight.grad,
                                        block.w_center.weight.grad, block.bn.weight.grad)])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    for g, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * max(1.0, float(w.abs().max())))
    torch.testing.assert_close(card.bn.running_mean.cpu(), cpu.bn.running_mean,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card.bn.running_var.cpu(), cpu.bn.running_var,
                               rtol=1e-4, atol=1e-5)


def test_edgeconv_keeps_nothing_of_the_gathered_size(device):
    """Forward and backward of one EdgeConv at (4, 4096, k 20, C 128): the
    rise of allocated memory stays below one (B, N, k, C) float32 tensor,
    which the plain composition saves for the backward."""
    B, N, k, C = 4, 4096, 20, 128
    block = EdgeConv(64, C, k).to(device).train()
    x = torch.randn(B, N, 64, device=device, requires_grad=True)
    idx = torch.randint(0, N, (B, N, k), device=device, dtype=torch.int32)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    block(x, idx=idx).square().sum().backward()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - start
    gathered = B * N * k * C * 4
    print(f"EdgeConv (4, 4096, 20, 128) forward and backward: peak rise {rise / 2**20:.1f} "
          f"MiB against {gathered / 2**20:.1f} MiB of gathered rows")
    assert rise < gathered


def test_dgcnn_train_step_launches_edge_reduce_and_no_gather(device):
    """One DeepGraphCnn training step on the card: four kNN, 4 + 4 edge_reduce
    (forward and backward) and no batched row gather."""
    torch.manual_seed(0)
    state = create_train_state(create_model("DeepGraphCnn"), device=device, seed=0)
    rng = np.random.default_rng(7)
    points = torch.from_numpy(rng.random((2, 1024, 9)).astype(np.float32)).to(device)
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 14, (2, 1024))), 14).float().to(device)
    lengths = torch.full((2,), 1024, device=device)
    train_step(state, points, labels, lengths)
    torch.cuda.synchronize()
    before = dict(_kernels.LAUNCHES)
    metrics = train_step(state, points, labels, lengths)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
    assert ran == {"knn": 4, "edge_reduce": 8}, ran
    assert np.isfinite(float(metrics["loss"]))


# (B, M, N, k, C) with an offset: PointNeXt-XL's widths 128-1024 at k 32,
# M != N, a level of 16 points under balls of 32 (repeated indices), and a
# narrow C (vectors of one element)
OFFSET_SHAPES = [(2, 1024, 1024, 32, 128), (2, 256, 1024, 32, 256), (2, 64, 256, 32, 512),
                 (4, 16, 16, 32, 1024), (3, 100, 300, 7, 13)]


def _offset(seed, B, M, C, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2, 3, (B, M, C)).astype(np.float32)).to(device)


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,N,k,C", OFFSET_SHAPES)
def test_edge_reduce_with_an_offset_matches_plain(device, B, M, N, k, C, dtype, ties, sums):
    """Over x = p[idx] + d (rounded to the table's dtype): max and min
    bit-equal to the plain composition's, tie counts exact, sums within
    1e-5, one launch."""
    table, idx, _ = _inputs(11, B, M, N, k, C, ties, device)
    d = _offset(12, B, M, C, device) if ties else torch.randn(B, M, C, device=device)
    table, d = table.to(dtype), d.to(dtype)
    before = dict(_kernels.LAUNCHES)
    got = _edge_reduce_cuda(table, idx, sums, True, d)
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    want = edge_reduce_plain(table, idx, sums, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if sums:
        for g, w in zip(got[2:4], want[2:4]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    rows = gather_rows_plain(table, idx) + d[:, :, None, :]
    cmax = (rows == want[0][:, :, None]).sum(2)
    cmin = (rows == want[1][:, :, None]).sum(2)
    assert torch.equal(got[4].long(), cmax) and torch.equal(got[5].long(), cmin)
    if ties:
        assert int(cmax.max()) > 1 and int(cmin.max()) > 1
    for g, w in zip(edge_reduce(table, idx, sums, d), got):  # no gradient: no counts kept
        assert torch.equal(g, w)


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,M,N,k,C", OFFSET_SHAPES)
def test_edge_reduce_with_an_offset_backward_matches_autograd_of_plain(device, B, M, N, k, C,
                                                                       ties, sums):
    """The table's gradient (the backward kernel, each x recomputed with
    the offset) and the offset's (`offset_grad`) against autograd of the
    plain composition, within 1e-5 of their largest; one launch each way."""
    table, idx, weights = _inputs(13, B, M, N, k, C, ties, device)
    d = _offset(14, B, M, C, device) if ties else torch.randn(B, M, C, device=device)
    n_out = 4 if sums else 2
    t1, d1 = table.clone().requires_grad_(True), d.clone().requires_grad_(True)
    before = _kernels.LAUNCHES["edge_reduce"]
    got = edge_reduce(t1, idx, sums, d1)
    sum((o * w).sum() for o, w in zip(got, weights[:n_out])).backward()
    assert _kernels.LAUNCHES["edge_reduce"] == before + 2
    t2, d2 = table.clone().requires_grad_(True), d.clone().requires_grad_(True)
    want = edge_reduce_plain(t2, idx, sums, d2)
    sum((o * w).sum() for o, w in zip(want, weights[:n_out])).backward()
    for g, w in ((t1.grad, t2.grad), (d1.grad, d2.grad)):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_invres_on_the_card_matches_the_cpu(device, train, bias):
    """PointNeXt-XL's block form (published order) at width 128, K 32: on
    the card through `edge_reduce` with the offset (one launch a forward,
    one a backward, no grouped-row gather), on the CPU from the
    materialised rows; output, running statistics and the features'
    gradient within 1e-4, each parameter's gradient within 1e-4 of the
    larger of its norm and the median parameter's (a bias before a
    BatchNorm has a gradient of rounding alone), BatchNorm slopes of both
    signs, the cloud 3 m from the origin."""
    rng = np.random.default_rng(15)
    coords = torch.from_numpy(rng.random((2, 1024, 3)).astype(np.float32) + 3.0)
    feats = torch.from_numpy(rng.normal(size=(2, 1024, 128)).astype(np.float32))
    torch.manual_seed(0)
    cpu = InvResMLP(0.2, 128, 32, residual_act=True, bias=bias).train(train)
    with torch.no_grad():
        bn = cpu.neighbour_features_mlp.batch[0]
        bn.weight.copy_(torch.from_numpy(rng.uniform(-1.5, 1.5, 128).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, 128).astype(np.float32)))
    card = InvResMLP(0.2, 128, 32, residual_act=True, bias=bias).train(train)
    card.load_state_dict(cpu.state_dict())
    card.to(device)
    weight = torch.from_numpy(rng.normal(size=(2, 1024, 128)).astype(np.float32))
    outs, grads = [], []
    for block, where in ((cpu, torch.device("cpu")), (card, device)):
        tf = feats.to(where, copy=True).requires_grad_(True)
        before = dict(_kernels.LAUNCHES)
        out = block(coords.to(where), tf)[1]
        (out * weight.to(where)).sum().backward()
        ran = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
        assert ran == ({} if where.type == "cpu" else {"ball_query": 1, "edge_reduce": 2}), ran
        outs.append(out.detach().cpu())
        grads.append([tf.grad.cpu(), *(p.grad.cpu().double() for p in block.parameters())])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-4,
                               atol=1e-4 * max(1.0, float(grads[0][0].abs().max())))
    norms = [float(w.norm()) for w in grads[0][1:]]
    median = sorted(norms)[len(norms) // 2]
    for g, w, norm in zip(grads[1][1:], grads[0][1:], norms):
        assert float((g - w).norm()) <= 1e-4 * max(norm, median)
    for a, b in zip(card.buffers(), cpu.buffers()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_pointnext_xl_train_step_captures_and_replays_edge_reduce(device):
    """PointNeXt-XL's train steps on the card at B 2 x 1,024: the captured
    step launches from Python 4 FPS, 19 ball queries, 4 three-NN, 12 row
    gathers (the 4 SAs' grouped rows, 4 centroid and 4 interpolation
    gathers) and 15 + 15 `edge_reduce` (the 15 InvResMLPs' grouped layers,
    forward and backward); the replays after it launch nothing from
    Python, and the losses stay finite."""
    torch.manual_seed(0)
    state = create_train_state(create_model("PointNeXt-XL"), device=device, seed=0)
    rng = np.random.default_rng(16)
    points = torch.from_numpy(rng.random((2, 1024, 9)).astype(np.float32)).to(device)
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 14, (2, 1024))), 14).to(torch.uint8).to(device)
    lengths = torch.full((2,), 1024, dtype=torch.int32, device=device)
    train_step(state, points, labels, lengths)  # eager: the optimizer's first update
    torch.cuda.synchronize()
    launches, graphs = dict(_kernels.LAUNCHES), dict(STEP_GRAPHS)
    losses = [train_step(state, points, labels, lengths)["loss"]]
    torch.cuda.synchronize()
    ran = {k: v - launches[k] for k, v in _kernels.LAUNCHES.items() if v != launches[k]}
    assert ran == {"fps": 4, "ball_query": 19, "three_nn": 4, "gather_rows": 12,
                   "edge_reduce": 30}, ran
    assert {k: v - graphs[k] for k, v in STEP_GRAPHS.items()} == {
        "captured": 1, "replayed": 0, "eager": 0}
    launches = dict(_kernels.LAUNCHES)
    losses += [train_step(state, points, labels, lengths)["loss"] for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES == launches
    assert {k: v - graphs[k] for k, v in STEP_GRAPHS.items()} == {
        "captured": 1, "replayed": 2, "eager": 0}
    assert all(np.isfinite(float(loss)) for loss in losses)
