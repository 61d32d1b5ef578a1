"""pointseg_torch's SharedMLP options, BatchNorm.stats and EdgeConv against
pointseg's on the CPU: same numpy inputs, the JAX block's weights copied
into the port's.

Tolerances: outputs and gradients rtol/atol 1e-4 (the same float32
formulas, reduced in another order; the fused form's E[x²] - mean² loses
a few digits on its own), running statistics 1e-4. The neighbour graph
is given (`idx`) where the comparison is about values, so that no
near-tie of the kNN can flip a neighbour; one test lets both build their
own graph and first requires the two graphs equal.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointseg import ops as jops
from pointseg.nn import EdgeConv as JaxEdgeConv
from pointseg.nn import SharedMLP as JaxSharedMLP
from pointseg.nn import leaky_relu_02 as jax_leaky
from pointseg.ops.dispatch import set_use_pallas
from pointseg_torch import ops as tops
from pointseg_torch.nn import BatchNorm, EdgeConv, SharedMLP, leaky_relu_02

torch.set_num_threads(2)

B, N, F_IN, OUT, K = 2, 256, 6, 16, 8


@pytest.fixture(autouse=True)
def _jax_oracle():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, F_IN)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    return x, idx


def _jax_variables(seed, negative_scale):
    """EdgeConv variables with every leaf off its init value."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, OUT)
    if negative_scale:
        scale[::2] *= -1.0  # the fused form switches to the min there
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {
        "params": {
            "w_edge": {"kernel": f32(rng.normal(0, 0.4, (F_IN, OUT)))},
            "w_center": {"kernel": f32(rng.normal(0, 0.4, (F_IN, OUT)))},
            "bn": {"scale": f32(scale), "bias": f32(rng.normal(0, 0.1, OUT))},
        },
        "batch_stats": {"bn": {"mean": f32(rng.normal(0, 0.1, OUT)),
                               "var": f32(rng.uniform(0.5, 1.5, OUT))}},
    }


def _port_block(v, **kwargs):
    block = EdgeConv(F_IN, OUT, K, **kwargs)
    p, s = v["params"], v["batch_stats"]
    block.load_state_dict({
        "w_edge.weight": torch.from_numpy(p["w_edge"]["kernel"].T.copy()),
        "w_center.weight": torch.from_numpy(p["w_center"]["kernel"].T.copy()),
        "bn.weight": torch.from_numpy(p["bn"]["scale"].copy()),
        "bn.bias": torch.from_numpy(p["bn"]["bias"].copy()),
        "bn.running_mean": torch.from_numpy(s["bn"]["mean"].copy()),
        "bn.running_var": torch.from_numpy(s["bn"]["var"].copy()),
        "bn.num_batches_tracked": torch.tensor(0),
    })
    return block


@pytest.mark.parametrize("negative_scale", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_edgeconv_eval_matches_jax(data, fused, negative_scale):
    x, idx = data
    v = _jax_variables(1, negative_scale)
    want = JaxEdgeConv(OUT, K, fused=fused).apply(v, jnp.asarray(x), train=False,
                                                  idx=jnp.asarray(idx))
    block = _port_block(v, fused=fused).eval()
    with torch.no_grad():
        got = block(torch.from_numpy(x), idx=torch.from_numpy(idx))
    assert got.shape == (B, N, OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("negative_scale", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_edgeconv_train_output_gradients_and_running_stats_match_jax(data, fused,
                                                                     negative_scale):
    """Continuous random rows: no two neighbours tie exactly, so the max
    and the min over k send their gradient to one neighbour in both."""
    x, idx = data
    v = _jax_variables(2, negative_scale)
    weight = np.random.default_rng(3).normal(size=(B, N, OUT)).astype(np.float32)
    jblock = JaxEdgeConv(OUT, K, fused=fused)

    def loss_fn(params, xj):
        out, upd = jblock.apply({"params": params, "batch_stats": v["batch_stats"]}, xj,
                                train=True, idx=jnp.asarray(idx), mutable=["batch_stats"])
        return jnp.sum(out * weight), (out, upd["batch_stats"])

    (_, (want, stats)), (g_params, g_x) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    torch.use_deterministic_algorithms(True)
    try:
        block = _port_block(v, fused=fused).train()
        tx = torch.from_numpy(x).requires_grad_(True)
        got = block(tx, idx=torch.from_numpy(idx))
        (got * torch.from_numpy(weight)).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    def close(t, j, name):
        j = np.asarray(j)
        tol = 1e-4 * max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=tol, err_msg=name)

    close(tx.grad, g_x, "x")
    close(block.w_edge.weight.grad.T, g_params["w_edge"]["kernel"], "w_edge")
    close(block.w_center.weight.grad.T, g_params["w_center"]["kernel"], "w_center")
    close(block.bn.weight.grad, g_params["bn"]["scale"], "scale")
    close(block.bn.bias.grad, g_params["bn"]["bias"], "bias")
    np.testing.assert_allclose(block.bn.running_mean.numpy(), np.asarray(stats["bn"]["mean"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(block.bn.running_var.numpy(), np.asarray(stats["bn"]["var"]),
                               rtol=1e-4, atol=1e-5)
    assert int(block.bn.num_batches_tracked) == 1


@pytest.mark.parametrize("train", [False, True])
def test_edgeconv_fused_equals_unfused_and_remat(data, train):
    x, idx = data
    v = _jax_variables(4, negative_scale=True)
    outs, grads, stats = [], [], []
    for kwargs in ({"fused": True}, {"fused": False}, {"fused": True, "remat": True}):
        block = _port_block(v, **kwargs).train(train)
        tx = torch.from_numpy(x).requires_grad_(True)
        out = block(tx, idx=torch.from_numpy(idx))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(tx.grad)
        stats.append((block.bn.running_mean.clone(), block.bn.running_var.clone()))
    for i in (1, 2):
        torch.testing.assert_close(outs[i], outs[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(grads[i], grads[0], rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(stats[i][0], stats[0][0], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(stats[i][1], stats[0][1], rtol=1e-4, atol=1e-5)
    if not train:  # eval leaves the running statistics alone
        np.testing.assert_array_equal(stats[0][0].numpy(), v["batch_stats"]["bn"]["mean"])


@pytest.mark.parametrize("use_knn_on,use_mask", [(False, False), (True, False), (False, True)])
def test_edgeconv_builds_the_same_graph_as_jax(use_knn_on, use_mask):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, N, F_IN)).astype(np.float32)
    pos = rng.random((B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) > 0.2
    v = _jax_variables(6, negative_scale=False)
    kw_j, kw_t = {}, {}
    if use_knn_on:
        kw_j["knn_on"], kw_t["knn_on"] = jnp.asarray(pos), torch.from_numpy(pos)
    if use_mask:
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    src = pos if use_knn_on else x
    graph_kw_j = {"mask": kw_j["mask"]} if use_mask else {}
    graph_kw_t = {"mask": kw_t["mask"]} if use_mask else {}
    np.testing.assert_array_equal(
        tops.knn_indices(torch.from_numpy(src), K, **graph_kw_t).numpy(),
        np.asarray(jops.knn_indices(jnp.asarray(src), K, **graph_kw_j)))
    want = JaxEdgeConv(OUT, K).apply(v, jnp.asarray(x), train=False, **kw_j)
    with torch.no_grad():
        got = _port_block(v).eval()(torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bnstats_keys_update_rule_and_eval():
    bn = BatchNorm(4)
    assert set(bn.state_dict()) == set(torch.nn.BatchNorm1d(4).state_dict())
    mean, var = torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([4.0, 3.0, 2.0, 1.0])
    bn.train()
    scale, bias, m, v = bn.stats(mean, var)
    assert m is mean and v is var and scale is bn.weight and bias is bn.bias
    # momentum 0.1 (flax's 0.9) from the init (0, 1); the variance as given
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    assert int(bn.num_batches_tracked) == 1
    _, _, m, v = bn.stats(None, None)  # no batch statistics: the running ones
    assert m is bn.running_mean and v is bn.running_var
    bn.eval()
    _, _, m, v = bn.stats(mean, var)
    assert m is bn.running_mean and int(bn.num_batches_tracked) == 1
    # called on a tensor it is the port's BatchNorm
    x = torch.randn(3, 5, 4, generator=torch.Generator().manual_seed(0))
    want = (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5)
    torch.testing.assert_close(bn(x), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_bias", [True, False])
def test_shared_mlp_act_and_bias_options_match_jax(use_bias):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 40, 5)).astype(np.float32)
    jm = JaxSharedMLP([8, 6], act=jax_leaky, use_bias=use_bias)
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    v = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.05), v)  # off the init
    want_eval = jm.apply(v, jnp.asarray(x), train=False)
    want_train, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])

    mlp = SharedMLP(5, [8, 6], act=leaky_relu_02, use_bias=use_bias)
    assert (mlp.conv[0].bias is None) == (not use_bias)
    sd = {}
    for i in range(2):
        p = v["params"]
        sd[f"conv.{i}.weight"] = torch.from_numpy(p[f"Dense_{i}"]["kernel"].T.copy())
        if use_bias:
            sd[f"conv.{i}.bias"] = torch.from_numpy(p[f"Dense_{i}"]["bias"].copy())
        sd[f"batch.{i}.weight"] = torch.from_numpy(p[f"BatchNorm_{i}"]["scale"].copy())
        sd[f"batch.{i}.bias"] = torch.from_numpy(p[f"BatchNorm_{i}"]["bias"].copy())
        s = v["batch_stats"][f"BatchNorm_{i}"]
        sd[f"batch.{i}.running_mean"] = torch.from_numpy(s["mean"].copy())
        sd[f"batch.{i}.running_var"] = torch.from_numpy(s["var"].copy())
        sd[f"batch.{i}.num_batches_tracked"] = torch.tensor(0)
    mlp.load_state_dict(sd)
    with torch.no_grad():
        got_eval = mlp.eval()(torch.from_numpy(x))
        got_train = mlp.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mlp.batch[1].running_var.numpy(),
                               np.asarray(upd["batch_stats"]["BatchNorm_1"]["var"]),
                               rtol=1e-4, atol=1e-6)
    x_neg = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(leaky_relu_02(x_neg).numpy(),
                               np.asarray(fnn.leaky_relu(jnp.asarray(x_neg.numpy()), 0.2)))


def _old_gather_reduce(p, idx, training):
    """The composition EdgeConv ran itself before `ops.edge_reduce`."""
    gp = tops.gather_neighbors(p, idx)  # (B, N, k, out)
    out = (gp.amax(dim=2), gp.amin(dim=2))
    if training:  # the sums in float32 (or wider)
        g = gp.to(torch.promote_types(gp.dtype, torch.float32))
        out += (g.sum(dim=2), (g * g).sum(dim=2))
    return out


@pytest.mark.parametrize("rows", [N, 3 * N])  # M = N, and a table of more rows (point-sharded)
@pytest.mark.parametrize("sums", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
def test_edge_reduce_plain_equals_the_old_composition(data, ties, dtype, sums, rows):
    """Values and gradients of `edge_reduce_plain`, and of `edge_reduce` on
    the CPU, bit-equal to the composition they replace; ties forced by
    integer rows, duplicated rows and a repeated index in every list."""
    _, idx = data
    rng = np.random.default_rng(8)
    if ties:
        table = rng.integers(-2, 3, size=(B, rows, OUT)).astype(np.float32)
        table[:, rows // 2:] = table[:, : rows - rows // 2]
        idx = idx.copy()
        idx[..., 1] = idx[..., 0]
    else:
        table = rng.normal(size=(B, rows, OUT)).astype(np.float32)
    table = torch.from_numpy(table).to(dtype)
    idx = torch.from_numpy(idx)
    weights = [torch.from_numpy(rng.normal(size=(B, N, OUT)).astype(np.float32))
               for _ in range(4)]
    results = []
    for fn in (_old_gather_reduce, tops.edge_reduce_plain, tops.edge_reduce):
        t = table.clone().requires_grad_(True)
        out = fn(t, idx, sums)
        assert len(out) == (4 if sums else 2)
        sum((o.double() * w.double()).sum() for o, w in zip(out, weights)).backward()
        results.append(([o.detach() for o in out], t.grad))
    (want, want_grad) = results[0]
    assert want[0].dtype == dtype and (not sums or want[2].dtype == (
        torch.float64 if dtype == torch.float64 else torch.float32))
    for got, got_grad in results[1:]:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(got_grad, want_grad)


@pytest.mark.parametrize("fused,train", [(True, True), (True, False), (False, True)])
def test_edgeconv_reduces_through_ops_edge_reduce(data, monkeypatch, fused, train):
    """The fused block's one call site: sums in training, none in eval;
    the unfused block forms its edge tensor and never calls it."""
    x, idx = data
    seen = []
    real = tops.edge_reduce

    def spy(p_table, i, sums):
        seen.append((tuple(p_table.shape), sums))
        return real(p_table, i, sums)

    monkeypatch.setattr(tops, "edge_reduce", spy)
    block = _port_block(_jax_variables(9, negative_scale=True), fused=fused).train(train)
    block(torch.from_numpy(x), idx=torch.from_numpy(idx)).sum().backward()
    assert seen == ([((B, N, OUT), train)] if fused else [])


@pytest.mark.parametrize("table_shape,idx_shape,table_dtype,idx_dtype", [
    ((B, N), (B, N, K), torch.float32, torch.int32),        # no channel axis
    ((B, N, OUT), (B, N, 0), torch.float32, torch.int32),   # no neighbour
    ((B, N, OUT), (B + 1, N, K), torch.float32, torch.int32),  # batches differ
    ((B, N, OUT), (B, N, K), torch.float32, torch.float32),    # float indices
    ((B, N, OUT), (B, N, K), torch.float64, torch.int32),      # a dtype the kernel lacks
    ((B, N, OUT), (B, N, K), torch.float32, torch.int32),      # sound, but not on the card
])
def test_edge_reduce_kernel_refuses_what_it_does_not_take(table_shape, idx_shape, table_dtype,
                                                          idx_dtype):
    """The launch's checks run before anything reaches the card."""
    from pointseg_torch.ops.edgereduce import _edge_reduce_cuda

    table = torch.zeros(table_shape, dtype=table_dtype)
    idx = torch.zeros(idx_shape, dtype=idx_dtype)
    with pytest.raises(ValueError):
        _edge_reduce_cuda(table, idx, True, counts=True)


def test_edge_reduce_counts_fit_k():
    from pointseg_torch.ops.edgereduce import count_dtype

    assert count_dtype(20) == count_dtype(255) == torch.uint8
    assert count_dtype(256) == torch.int32
