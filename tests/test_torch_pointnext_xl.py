"""pointseg_torch's PointNeXt-XL (`models/pointnext.py::PointNeXtXL`, a
port-only registry name) against the benchmark's plain reference
(`portbench/reference/archs/pointnext_xl_s3dis.py`) on the CPU, on weights
that the reference's `make_weights` draws from its `specs`.

The size is B 2 x 1,024 points at width 8, the published layout: stage
sizes 256/64/16/4, so stage 4's balls of 32 repeat their nearest member.
There the InvResMLPs' BatchNorms normalise 8 rows, and each of stage 4's
blocks multiplies a rounding error about tenfold: the port in float32
lies up to 1.3% from float64 at the logits, and the plain reference in
float32 as far (measured over three seeds). So the port is held to the
reference in float64, where the comparison sees the mathematics:

- logits (dropout off): the model returns float32 logits, so the gap is
  their rounding (3e-8 to 4e-8 of the largest measured); tolerance 1e-6;
- the loss of a train step: the masked cross-entropy of those float32
  logits on both sides (read 0); tolerance 1e-6;
- every leaf's gradient: |g - g_ref| over the larger of |g_ref| and the
  median leaf's (a bias before a BatchNorm has a gradient of rounding
  alone), read up to 1e-8; tolerance 1e-6;
- the parameters after one Adam step through `train_step`, the change of
  each leaf over a full step (lr x sqrt(size)), leaving out the leaves
  whose gradient is under 1e-3 of the median leaf's (Adam moves them by
  the sign of rounding); tolerance 1e-5.

The float32 path, the cell's, is held to the reference's own float32
noise: its median logit gap to the float64 reference within three times
the plain reference's float32 one (ratio read 1.04-1.32 over seeds 1-3).
Computing in bfloat16 fails both comparisons (its median logit gap reads
30-43 times the plain reference's float32 one).
"""

import math
import os
import sys
from copy import deepcopy

import pytest
import torch
import torch.nn.functional as F

from pointseg_torch import cli, ops
from pointseg_torch.data import synthetic
from pointseg_torch.models import MODELS, PointNeXtXL, create_model
from pointseg_torch.nn import GroupedFirstLayer, InvResMLP
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.edgereduce import edge_reduce_plain, offset_grad
from pointseg_torch.train.state import create_train_state, train_step
from portbench.reference.archs import pointnext_xl_s3dis as ref
from portbench.reference.models import make_weights
from portbench.reference.train import reference_steps

torch.set_num_threads(2)

B, N, WIDTH, CLASSES = 2, 1024, 8, 14
LR = 1e-3
FPS_SEED, DROPOUT_SEED = 11, 12
LOGIT_TOL = 1e-6  # the float32 rounding of the returned logits, 3e-8 to 4e-8
LOSS_TOL = 1e-6
GRAD_TOL = 1e-6  # read up to 1e-8
UPDATE_TOL = 1e-5  # of a full step
NOISE_RATIO = 3.0  # float32 against the plain reference's float32


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, N, 9, generator=g, dtype=torch.float64)
    x[..., 3:6] *= 255  # rgb 0-255, as in the block format
    labels = F.one_hot(torch.randint(0, CLASSES, (B, N), generator=g), CLASSES)
    return x, labels.to(torch.uint8), torch.tensor([N, N - 100], dtype=torch.int32)


def _weights(seed):
    return make_weights(ref.specs(width=WIDTH), seed, "cpu")


def _port(weights, compute=torch.float64, dropout=0.5):
    """The port's model with `weights`: float64 parameters and arithmetic
    for `compute` float64, else float32 parameters computing in `compute`."""
    dtype = torch.float32 if compute == torch.float64 else compute
    model = create_model("PointNeXt-XL", width=WIDTH, dropout=dropout, dtype=dtype)
    model.load_state_dict({**model.state_dict(), **weights}, strict=True)
    return model.double() if compute == torch.float64 else model


def _gen():
    return torch.Generator().manual_seed(FPS_SEED)


def _rel_max(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def _leaf_gaps(got, want):
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {n: float((got[n].double() - w.double()).norm()) / max(norms[n], median)
            for n, w in want.items()}


def _port_step(weights, x, labels, lengths):
    """One float64 `train_step` of the port: loss, gradients, parameters."""
    model = _port(weights)
    state = create_train_state(model, device="cpu", learning_rate=LR, seed=FPS_SEED)
    torch.manual_seed(DROPOUT_SEED)
    out = train_step(state, x, labels, lengths)
    return {"loss": float(out["loss"]),
            "grads": {n: p.grad.detach() for n, p in model.named_parameters()},
            "params": {n: p.detach() for n, p in model.named_parameters()}}


def _reference_step(weights, x, labels, lengths):
    return reference_steps("pointnext_xl_s3dis", weights, [(x, labels, lengths)],
                           fps_seed=FPS_SEED, dropout_seed=DROPOUT_SEED, lr=LR, device="cpu")


def test_published_widths_have_the_reference_names_and_41_6_m_parameters():
    model = create_model("PointNeXt-XL")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {name: shape for name, shape, _ in ref.specs()}
    assert 41.5e6 <= sum(p.numel() for p in model.parameters()) <= 41.7e6
    assert isinstance(model, PointNeXtXL) and model.blocks == (3, 6, 3, 3)
    assert sum(isinstance(m, InvResMLP) for m in model.modules()) == 15
    assert "PointNeXt-XL" in MODELS and "PointNeXt-XL" in cli.MODEL_CHOICES


def test_rooms_width_six_feeds_the_stem():
    model = create_model("PointNeXt-XL", num_classes=13, in_dim=6, width=WIDTH)
    assert tuple(model.mlp.weight.shape) == (WIDTH, 6)
    with torch.no_grad():
        out = model.eval()(torch.rand(B, N, 6))
    assert out.shape == (B, N, 13) and torch.isfinite(out).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_logits_equal_the_reference_in_float64(seed):
    x, _, _ = _batch(seed)
    weights = _weights(seed + 100)
    got = _port(weights, dropout=0.0)(x, generator=_gen())
    want = ref.forward({n: w.double() for n, w in weights.items()}, x, _gen(), dropout=False)
    assert got.shape == want.shape == (B, N, CLASSES)
    assert _rel_max(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("seed", [1, 2])
def test_train_step_equals_the_reference_in_float64(seed):
    x, labels, lengths = _batch(seed)
    weights = {n: w.double() for n, w in _weights(seed + 100).items()}
    got = _port_step(weights, x, labels, lengths)
    want = _reference_step(weights, x, labels, lengths)
    assert abs(got["loss"] - want["losses"][0]) <= LOSS_TOL * abs(want["losses"][0])
    assert max(_leaf_gaps(got["grads"], want["grads"]).values()) <= GRAD_TOL
    gnorm = {n: float(g.norm()) for n, g in want["grads"].items()}
    floor = 1e-3 * sorted(gnorm.values())[len(gnorm) // 2]
    for name, w in weights.items():
        if gnorm[name] < floor:
            continue
        full = LR * math.sqrt(w.numel())
        gap = float((got["params"][name] - want["params"][name].double()).norm())
        assert gap <= UPDATE_TOL * full, name


def _logit_median_gap(got, want):
    return float((got.double() - want).abs().median() / want.abs().median())


def _float_gaps(seed, compute):
    """(the port's median logit gap to the float64 reference when computing
    in `compute`, the plain reference's in float32)."""
    x, _, _ = _batch(seed)
    weights = _weights(seed + 100)
    truth = ref.forward({n: w.double() for n, w in weights.items()}, x, _gen(),
                        dropout=False).detach()
    plain = ref.forward(weights, x.float(), _gen(), dropout=False).detach()
    with torch.no_grad():
        got = _port(weights, compute, dropout=0.0).train()(x.float(), generator=_gen())
    return _logit_median_gap(got, truth), _logit_median_gap(plain, truth)


def test_float32_is_no_farther_from_float64_than_the_plain_reference():
    got, plain = _float_gaps(3, torch.float32)
    assert got <= NOISE_RATIO * plain


def test_bfloat16_fails_the_tolerances():
    got, plain = _float_gaps(3, torch.bfloat16)
    assert got > NOISE_RATIO * plain
    x, _, _ = _batch(3)
    weights = _weights(103)
    with torch.no_grad():
        logits = _port(weights, torch.bfloat16, dropout=0.0)(x.float(), generator=_gen())
    want = ref.forward({n: w.double() for n, w in weights.items()}, x, _gen(), dropout=False)
    assert _rel_max(logits, want.detach()) > LOGIT_TOL


def _parent_grouped(layer, centroids, coords, features):
    """`GroupedFirstLayer.forward` as it was before the bias argument."""
    idx, _ = ops.ball_query(centroids, coords, layer.radius, layer.K, filler=layer.filler)
    first = layer.conv[0]
    w_rel, w_feat = first.weight[:, :3], first.weight[:, 3:]
    gfeat, gcoords = ops.gather_rows_with_coords(F.linear(features, w_feat), coords, idx)
    rel = gcoords - centroids[:, :, None, :]
    if layer.normalize:
        rel = rel / layer.radius
    x = F.relu(layer.batch[0](gfeat + F.linear(rel, w_rel, first.bias)))
    for conv, bn in zip(layer.conv[1:], layer.batch[1:]):
        x = F.relu(bn(conv(x)))
    return x


def _parent_invres(block, coords, features):
    """`InvResMLP.forward` as it was before the published order."""
    h = _parent_grouped(block.neighbour_features_mlp, coords, coords, features)
    return block.point_features_mlp(ops.reduce(h, block.pooling, dim=2)) + features


def _same_forward_and_backward(module, parent_forward, args):
    twin = deepcopy(module)
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    twin_leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    out = module(*leaves)
    out = out[1] if isinstance(out, tuple) else out
    want = parent_forward(twin, *twin_leaves)
    assert torch.equal(out, want)
    out.square().sum().backward()
    want.square().sum().backward()
    for (name, p), q in zip(module.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for a, b in zip(leaves, twin_leaves):
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad)
    for a, b in zip(module.buffers(), twin.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("filler", ["repeat", "index"])
def test_default_blocks_are_the_parents_bit_for_bit(filler):
    torch.manual_seed(0)
    coords = torch.rand(B, 256, 3)
    feats = torch.randn(B, 256, 16)
    layer = GroupedFirstLayer(16, [24, 32], 0.2, 16, normalize=True, filler=filler)
    _same_forward_and_backward(layer, _parent_grouped, (coords[:, :64], coords, feats))
    block = InvResMLP(0.2, 16, 32, filler=filler)
    _same_forward_and_backward(block, _parent_invres, (coords, feats))


@pytest.mark.parametrize("filler", ["repeat", "index"])
def test_a_ball_wider_than_its_level_repeats_slot_0(filler):
    """K > N: `ops.ball_query` takes all N points and fills slots N..K-1
    with slot 0, as non-members, so the grouped layer's pooled maximum is
    that of the K = N ball and its statistics count slot 0 K - N more
    times."""
    torch.manual_seed(1)
    coords, feats = torch.rand(B, 6, 3), torch.randn(B, 6, 4)
    wide = GroupedFirstLayer(4, [8], 0.5, 10, normalize=True, filler=filler, bias=False)
    got = wide(coords, coords, feats)
    idx, in_ball = ops.ball_query(coords, coords, 0.5, 6, filler=filler)
    wide_idx, wide_in = ops.ball_query(coords, coords, 0.5, 10, filler=filler)
    idx = torch.cat([idx, idx[..., :1].expand(B, 6, 4)], dim=-1)
    assert torch.equal(wide_idx, idx)
    assert torch.equal(wide_in, torch.cat([in_ball, torch.zeros(B, 6, 4, dtype=torch.bool)], -1))
    rel = (ops.gather_rows(coords, idx) - coords[:, :, None, :]) / 0.5
    rows = torch.cat([rel, ops.gather_rows(feats, idx)], dim=-1)
    want = F.relu(deepcopy(wide.batch[0])(F.linear(rows, wide.conv[0].weight)))
    assert got.shape == (B, 6, 10, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _blocks_state(block, coords, feats, dtype, reduces):
    """A copy of `block` in `dtype` run on (coords, feats), through
    `GroupedFirstLayer.pool`'s reduction route where `reduces` (on the
    CPU `ops.edge_reduce` is `edge_reduce_plain`, called with an offset
    here: the spy checks it), else from the materialised rows: (output,
    {parameter: gradient of a fixed readout}, the block's buffers)."""
    block = deepcopy(block).to(dtype)
    x, f = coords.to(dtype), feats.to(dtype)
    calls = []

    def spy(p_table, idx, sums, offset=None):
        assert offset is not None and offset.shape == (*idx.shape[:2], p_table.shape[2])
        calls.append(1)
        return edge_reduce_plain(p_table, idx, sums, offset)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(GroupedFirstLayer, "reduces", lambda self, features: reduces)
        patch.setattr(ops, "edge_reduce", spy)
        out = block(x, f)[1]
    assert len(calls) == (1 if reduces else 0)
    readout = torch.linspace(-1, 1, out.numel(), dtype=dtype).reshape(out.shape)
    (out * readout).sum().backward()
    return (out.detach().double(), {n: p.grad.double() for n, p in block.named_parameters()},
            [t.double() for t in block.buffers()])


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", ["base", "shifted_25m", "wide_ball", "feature_mean_100"])
def test_invres_reduction_route_equals_the_materialised_block(case, train, bias):
    """The InvResMLP grouped layer as table + per-centre offset reduced by
    `edge_reduce` (the card's route, here through `edge_reduce_plain`)
    against the materialised rows on the same weights, BatchNorm slopes
    of both signs (the min is pooled where the slope is negative). In
    float64 the two are one function: output, running statistics and
    every parameter's gradient within 1e-10 (read up to 2e-14; the
    gradient over the larger of its and the median leaf's, as a bias
    before a BatchNorm has one of rounding alone). In float32 against
    float64 of the same float32 coordinates, the route is no farther than
    3 times the materialised layer's own rounding, also with the cloud 25
    m from the origin: there the anchor holds the error at 0.7-1.2 times
    it, and without one (t_j = W_f·f_j + W_r·p_j / r) the rows cancel to
    17-29 times it (three seeds). `wide_ball`: K 32 over a 12-point
    cloud, so slot 0 repeats. `feature_mean_100`: features of mean 100
    and spread 1, so the grouped layer's channel means lie about 100
    times above their spread, as post-ReLU residual features may: the
    batch statistics from s and q hold only because the rows are
    centred before they are reduced."""
    n, k = (12, 32) if case == "wide_ball" else (64, 16)
    g = torch.Generator().manual_seed(5)
    coords = torch.rand(2, n, 3, generator=g) + (25.0 if case == "shifted_25m" else 0.0)
    feats = torch.randn(2, n, 16, generator=g, dtype=torch.float64)
    if case == "feature_mean_100":
        feats = feats + 100.0
    torch.manual_seed(0)
    block = InvResMLP(0.2, 16, k, residual_act=True, bias=bias).train(train)
    with torch.no_grad():
        bn = block.neighbour_features_mlp.batch[0]
        sign = torch.where(torch.arange(16) % 2 == 0, 1.0, -1.0)
        bn.weight.copy_(sign * (0.5 + torch.rand(16, generator=g)))
        bn.bias.copy_(0.1 * torch.randn(16, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(16, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(16, generator=g))
    want, want_grads, want_bufs = _blocks_state(block, coords, feats, torch.float64, False)
    got, got_grads, got_bufs = _blocks_state(block, coords, feats, torch.float64, True)
    assert _rel_max(got, want) <= 1e-10
    assert all(torch.allclose(a, b, rtol=1e-10, atol=0) for a, b in zip(got_bufs, want_bufs))
    assert max(_leaf_gaps(got_grads, want_grads).values()) <= 1e-10
    own, _, _ = _blocks_state(block, coords, feats, torch.float32, False)
    route, _, _ = _blocks_state(block, coords, feats, torch.float32, True)
    assert _rel_max(route, want) <= 3.0 * _rel_max(own, want)


@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("offset", [False, True])
def test_edge_reduce_plain_with_and_without_an_offset(offset, sums):
    """`edge_reduce_plain` over rows p[idx] (+ d): values against the
    rows reduced by hand, and in float64 the offset's gradient against
    `offset_grad`'s closed form (the card's backward), ties forced
    (integer rows, a repeated index) so that max and min split theirs."""
    g = torch.Generator().manual_seed(3)
    table = torch.randint(-3, 4, (2, 20, 8), generator=g).double().requires_grad_(True)
    idx = torch.randint(0, 20, (2, 10, 6), generator=g)
    idx[..., 1] = idx[..., 0]
    d = (torch.randint(-2, 3, (2, 10, 8), generator=g).double().requires_grad_(True)
         if offset else None)
    got = edge_reduce_plain(table, idx, sums, d)
    rows = torch.stack([table[b][idx[b]] for b in range(2)])
    if offset:
        rows = rows + d[:, :, None, :]
    want = [rows.amax(2), rows.amin(2)] + ([rows.sum(2), rows.square().sum(2)] if sums else [])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((rows == want[0][:, :, None]).sum(2).max()) > 1
    weights = [torch.randn(a.shape, generator=g, dtype=torch.float64) for a in got]
    sum((a * w).sum() for a, w in zip(got, weights)).backward()
    if offset:
        closed = offset_grad(*weights[:2], *(weights[2:] if sums else (None, None)),
                             got[2].detach() if sums else None, idx.shape[2])
        torch.testing.assert_close(d.grad, closed, rtol=1e-12, atol=1e-12)
        assert table.grad is not None


def test_each_invres_forward_is_a_span_inside_the_step_forward():
    from torch.profiler import ProfilerActivity, profile

    x, labels, lengths = _batch(1)
    state = create_train_state(_port(_weights(5), torch.float32), device="cpu", seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, x.float(), labels, lengths)
    events = prof.events()
    (forward,) = [e for e in events if e.name == "pointseg_torch.step.forward"]
    blocks = [e for e in events if e.name == "pointseg_torch.model.invres"]
    assert len(blocks) == 15
    assert all(forward.time_range.start <= e.time_range.start
               and e.time_range.end <= forward.time_range.end for e in blocks)


@pytest.fixture(scope="module")
def five_blocks(tmp_path_factory):
    """A synthetic block set cut to one block an area: one train step of 5
    clouds and one evaluation batch."""
    root = synthetic.make_block_dataset(str(tmp_path_factory.mktemp("blocks")),
                                        rooms_per_area=1, points_per_room=1500, seed=0,
                                        rgb_u8=True)
    for area in range(1, 7):
        folder = os.path.join(root, f"area_{area}")
        for name in sorted(os.listdir(folder))[1:]:
            os.remove(os.path.join(folder, name))
    return root


def test_cli_trains_pointnext_xl_one_step(five_blocks, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the CSV logger only
    args = cli.build_parser().parse_args(
        ["train", "PointNeXt-XL", "--data-dir", five_blocks, "--device", "cpu", "--epochs", "1",
         "--train-sampling", "1024", "--test-sampling", "1024", "--train-batch-size", "8",
         "--num-workers", "0", "--log-dir", str(tmp_path / "logs"),
         "--model-dir", str(tmp_path / "models")])
    state, records = cli.train_from_args(args)
    assert state.step == 1 and isinstance(state.model, PointNeXtXL)
    assert sum(p.numel() for p in state.model.parameters()) > 41.5e6
    assert math.isfinite(records["train_loss"][0]) and math.isfinite(records["val_loss"][0])
    assert "Epoch 1 completed" in capsys.readouterr().out


@pytest.mark.cuda
def test_one_forward_launches_on_the_card(monkeypatch):
    """One forward at B 2 x 4,096: 4 FPS, 19 ball queries, 4 three-NN, 12
    row gathers (the 4 SAs' grouped rows with their coordinates, 4
    centroid gathers and 4 interpolation gathers) and 15 `edge_reduce`,
    the 15 InvResMLPs' grouped layers, which form no rows. A forward
    called directly, not a train step, so every launch is from Python (a
    replayed train step's are not counted; `chip_smoke.py` counts the
    captured one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    model = create_model("PointNeXt-XL").to(device)
    x = torch.rand(B, 4096, 9, device=device)
    calls = []
    real = ops.gather_rows_with_coords
    monkeypatch.setattr(ops, "gather_rows_with_coords",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _kernels.build()
    before = dict(_kernels.LAUNCHES)
    with torch.no_grad():
        model(x, generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
    assert ran == {"fps": 4, "ball_query": 19, "three_nn": 4, "gather_rows": 12,
                   "edge_reduce": 15}
    assert len(calls) == 4
