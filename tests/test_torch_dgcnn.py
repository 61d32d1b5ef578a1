"""pointseg_torch's DGCNN and DGCNNWithColor against pointseg's on the
CPU, with the JAX model's weights carried over by `from_jax_variables`.

conv2-4 build their graphs from activations, so a last-bit difference in
conv1 can flip a neighbour in conv2 and then move a point's logits far
beyond any value tolerance. Each dynamic-graph test therefore first
replays the four graphs in both packages and requires them equal (the
input seed is pinned to a draw where they are), then compares values;
the static-graph tests depend on the xyz graph only. Dropout is 0 for
the train step: the two packages draw different masks by construction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg import ops as jops
from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import create_model as jax_create_model
from pointseg.nn import EdgeConv as JaxEdgeConv
from pointseg.ops.dispatch import set_use_pallas
from pointseg.train.loss import masked_onehot_cross_entropy as jax_ce
from pointseg.train.state import TrainState as JaxTrainState
from pointseg.train.state import bn_batch_apply as jax_bn_batch_apply
from pointseg.train.state import make_eval_step as jax_make_eval_step
from pointseg_torch import ops as tops
from pointseg_torch.io import from_jax_variables
from pointseg_torch.models import DGCNN, DGCNNWithColor, create_model, get_model
from pointseg_torch.models.dgcnn import get_loss
from pointseg_torch.train.loss import masked_onehot_cross_entropy
from pointseg_torch.train.state import (TrainState, bn_batch_apply, make_eval_step,
                                        make_optimizer, train_step)

torch.set_num_threads(2)

B, N, K, EMB = 2, 256, 8, 64
NAMES = ("DeepGraphCnn", "DGCNN")
CONVS = ("conv1", "conv2", "conv3", "conv4")
# Pinned to a draw where all four graphs of both models agree between the
# packages, in train and eval mode. XLA's CPU code sums the 64-term Gram
# product in another order than the port, so at most seeds a near-tie
# swaps one or two of the 4096 neighbour slots of a layer (seeds 0-15
# tried: 5 and 15 agree everywhere).
SEED = 5


@pytest.fixture(autouse=True)
def _jax_oracle():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(SEED)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N, N - 40], np.int32)
    return x, y, lengths


def _jax_model(name, **kwargs):
    return jax_create_model(name, num_classes=14, k=K, emb_dims=EMB, **kwargs)


@pytest.fixture(scope="module")
def jax_variables(batch):
    """Per model: JAX-initialised variables with BatchNorm off its init
    and a few negative BatchNorm scales (the fused EdgeConv's min branch)."""
    out = {}
    for name in NAMES:
        v = _jax_model(name).init({"params": jax.random.key(0)}, jnp.asarray(batch[0]),
                                  train=False)
        rng = np.random.default_rng(4)
        tree = {}
        for col, sub in v.items():
            flat = flatten_dict(jax.tree.map(np.asarray, sub))
            for path, leaf in flat.items():
                is_bn = path[-2] == "bn" or path[-2].startswith("BatchNorm")
                if path[-1] in ("scale", "var"):
                    leaf = rng.uniform(0.5, 1.5, leaf.shape)
                    if path[-1] == "scale" and path[-2] == "bn":
                        leaf[::5] *= -1.0
                elif path[-1] == "mean" or (path[-1] == "bias" and is_bn):
                    leaf = rng.normal(0, 0.1, leaf.shape)
                flat[path] = np.asarray(leaf, np.float32)
            tree[col] = unflatten_dict(flat)
        out[name] = tree
    return out


def to_reference_state_dict(name, state_dict):
    """A port DGCNN `state_dict` (or any mapping with its keys, gradients
    for example) under the reference torch model's keys, as
    `from_torch_state_dict` reads them: `convN.{w_edge,w_center}.weight`
    join into `convN.conv.0.weight` (out, 2F), and `X.conv.0` /
    `X.batch.0` become the reference's Sequential entries `X.0` / `X.1`."""
    out = dict(state_dict)
    for conv in CONVS:
        out[f"{conv}.conv.0.weight"] = torch.cat(
            [out.pop(f"{conv}.w_edge.weight"), out.pop(f"{conv}.w_center.weight")], dim=1)
        for key in [k for k in out if k.startswith(f"{conv}.bn.")]:
            out[f"{conv}.conv.1.{key.rsplit('.', 1)[1]}"] = out.pop(key)
    mlps = (("color_conv",) if name == "DeepGraphCnn" else ()) + ("conv5", "conv6", "conv7")
    for mlp in mlps:
        for key in [k for k in out if k.startswith((f"{mlp}.conv.0.", f"{mlp}.batch.0."))]:
            slot = "0" if ".conv.0." in key else "1"
            out[f"{mlp}.{slot}.{key.rsplit('.', 1)[1]}"] = out.pop(key)
    return out


def _port_model(name, variables, **kwargs):
    model = create_model(name, k=K, emb_dims=EMB, **kwargs)
    model.load_state_dict(from_jax_variables(name, variables))
    return model


def _graphs_jax(variables, x, train):
    """The graph each EdgeConv builds, replayed layer by layer."""
    out, h = {}, jnp.asarray(x[..., :3])
    for name, width in zip(CONVS, (64, 64, 64, 128)):
        out[name] = np.asarray(jops.knn_indices(h, K))
        v = {"params": variables["params"][name],
             "batch_stats": variables["batch_stats"][name]}
        h = JaxEdgeConv(width, K).apply(v, h, train=train, mutable=["batch_stats"])[0]
    return out


def _graphs_port(model, x, train):
    out, h = {}, torch.from_numpy(x[..., :3].copy())
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train(train)
    with torch.no_grad():
        for name in CONVS:
            out[name] = tops.knn_indices(h, K).numpy()
            h = getattr(model, name)(h)
    model.load_state_dict(state)  # the replay must not move the running statistics
    return out


def _assert_same_graphs(name, variables, model, x, train):
    want, got = _graphs_jax(variables, x, train), _graphs_port(model, x, train)
    for conv in CONVS:
        np.testing.assert_array_equal(got[conv], want[conv], err_msg=f"{name} {conv}")


@pytest.mark.parametrize("name", NAMES)
def test_dgcnn_weights_round_trip_exactly(name, jax_variables):
    v = jax_variables[name]
    sd = from_jax_variables(name, v)
    model = create_model(name, k=K, emb_dims=EMB)
    model.load_state_dict(sd)  # strict: every key, every shape
    back = from_torch_state_dict(name, to_reference_state_dict(name, model.state_dict()), v)
    for col in ("params", "batch_stats"):
        a, b = flatten_dict(back[col]), flatten_dict(v[col])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{col}/{k}")


def test_dgcnn_import_refuses_leftover_and_missing_leaves(jax_variables):
    v = jax_variables["DeepGraphCnn"]
    with pytest.raises(ValueError, match="color_conv"):
        from_jax_variables("DGCNN", v)  # the colour branch has no home
    with pytest.raises(KeyError, match="color_conv"):
        from_jax_variables("DeepGraphCnn", jax_variables["DGCNN"])
    with pytest.raises(ValueError, match="unknown model 'PointNet3'"):
        from_jax_variables("PointNet3", v)


@pytest.mark.parametrize("static_graph", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_dgcnn_eval_logits_match_jax(name, static_graph, batch, jax_variables):
    x, v = batch[0], jax_variables[name]
    model = _port_model(name, v, static_graph=static_graph).eval()
    if static_graph:
        np.testing.assert_array_equal(
            tops.knn_indices(torch.from_numpy(x[..., :3].copy()), K).numpy(),
            np.asarray(jops.knn_indices(jnp.asarray(x[..., :3]), K)))
    else:
        _assert_same_graphs(name, v, model, x, train=False)
    jm = _jax_model(name, static_graph=static_graph)
    want, want_emb = jax.jit(lambda v, x: jm.apply(v, x, train=False, return_features=True))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got, emb = model(torch.from_numpy(x), return_features=True)
    assert got.shape == (B, N, 14) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=1e-4, atol=1e-4)


def _grads_as_flax(name, model, template):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in model.named_parameters()}
    sd.update({k: b for k, b in model.named_buffers()})
    return flatten_dict(from_torch_state_dict(
        name, to_reference_state_dict(name, sd), template)["params"], sep="/")


@pytest.mark.parametrize("static_graph", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_dgcnn_train_step_matches_jax(name, static_graph, batch, jax_variables):
    """One train step: loss, per-leaf gradients and BatchNorm running
    statistics. The inputs are continuous random draws, so no two
    neighbours tie exactly in an EdgeConv's max or min."""
    x, y, lengths = batch
    v = jax_variables[name]
    model = _port_model(name, v, dropout=0.0, static_graph=static_graph)
    if not static_graph:
        _assert_same_graphs(name, v, model, x, train=True)
    jm = _jax_model(name, dropout=0.0, static_graph=static_graph)

    def loss_fn(params):
        logits, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y), jnp.asarray(lengths)), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    grads_j = flatten_dict(jax.tree.map(np.asarray, grads_j), sep="/")

    state = TrainState(model, make_optimizer(model.parameters(), 1e-3), generator=None)
    tx, ty, tl = (torch.from_numpy(a) for a in batch)
    grads_t = None

    def capture_grads():  # after backward, before Adam updates the weights
        nonlocal grads_t
        grads_t = _grads_as_flax(name, model, v)

    state.optimizer.register_step_pre_hook(lambda *_: capture_grads())
    torch.use_deterministic_algorithms(True)
    try:
        metrics = train_step(state, tx, ty, tl)
        # f32 noise floor per leaf: the same step in float64 (graphs stay f32)
        model64 = _port_model(name, v, dropout=0.0, static_graph=static_graph).double().train()
        masked_onehot_cross_entropy(model64(tx.double()), ty, tl).backward()
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-5, atol=1e-6)
    grads_64 = _grads_as_flax(name, model64.float(), v)

    # the criterion of tests/test_reference_parity.py's DGCNN gradient test:
    # each leaf within 8x its own f32 noise, or within 2e-2 (1 + |g|);
    # global cosine > 0.999
    dots = norm_t = norm_j = 0.0
    assert grads_t.keys() == grads_j.keys()
    for k, want in grads_j.items():
        got = grads_t[k]
        cross = np.linalg.norm(got - want)
        noise = np.linalg.norm(got - grads_64[k])
        floor = 2e-2 * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * noise, floor), (k, cross, noise, floor)
        dots += float(got.ravel() @ want.ravel())
        norm_t += float((got ** 2).sum())
        norm_j += float((want ** 2).sum())
    assert dots / np.sqrt(norm_t * norm_j) > 0.999

    stats_t = from_torch_state_dict(name, to_reference_state_dict(name, model.state_dict()), v)
    flat_t = flatten_dict(stats_t["batch_stats"], sep="/")
    for k, want in flatten_dict(jax.tree.map(np.asarray, stats_j), sep="/").items():
        np.testing.assert_allclose(flat_t[k], want, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_dgcnn_make_eval_step_batch_matches_jax(name, batch, jax_variables):
    """`make_eval_step(model, "batch")` against JAX's: every EdgeConv and
    BatchNorm on the statistics of the batch at hand (JAX's `train=True`
    forward), dropout off; the running statistics, their counts and every
    module's mode stay as they were."""
    x, y, lengths = batch
    v = jax_variables[name]
    model = _port_model(name, v)
    _assert_same_graphs(name, v, model, x, train=True)
    model.eval()
    jm = _jax_model(name)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=None, apply_fn=jm.apply,
                           tx=None)
    want = jax_make_eval_step(jm, "batch")(jstate, *(jnp.asarray(a) for a in batch))
    want_logits = jax_bn_batch_apply(jm, v, jnp.asarray(x))

    buffers = {k: b.clone() for k, b in model.named_buffers()}
    state = TrainState(model, make_optimizer(model.parameters()), generator=None)
    got = make_eval_step(model, "batch")(state, *(torch.from_numpy(a) for a in batch))
    logits = bn_batch_apply(model, torch.from_numpy(x))
    for k, b in model.named_buffers():
        assert torch.equal(b, buffers[k]), k
    assert not any(m.training for m in model.modules())

    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("correct", "total", "confusion"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    # batch statistics, not the running ones
    with torch.no_grad():
        running = model(torch.from_numpy(x))
    assert float((running - logits).abs().max()) > 1e-2


def test_dgcnn_static_graph_and_knn_select_share_parameters(batch, jax_variables):
    x = torch.from_numpy(batch[0])
    v = jax_variables["DGCNN"]
    dynamic = _port_model("DGCNN", v).eval()
    static = _port_model("DGCNN", v, static_graph=True).eval()  # the same state_dict loads
    with torch.no_grad():
        a, b = dynamic(x), static(x)
        # layer 1's graph is the xyz graph either way
        torch.testing.assert_close(static.conv1(x[..., :3], idx=tops.knn_indices(x[..., :3], K)),
                                   dynamic.conv1(x[..., :3]), rtol=0, atol=0)
        # a (B, N, 3) input is enough for the geometry-only model
        torch.testing.assert_close(dynamic(x[..., :3]), a, rtol=0, atol=0)
    assert not torch.allclose(a, b)
    with pytest.raises(TypeError, match="knn_select"):  # the shape picks the kernel
        _port_model("DGCNN", v, knn_select="two_level")


def test_dgcnn_registry_factories_and_input_checks():
    assert isinstance(create_model("DeepGraphCnn"), DGCNNWithColor)
    assert type(create_model("DGCNN", num_classes=13)) is DGCNN
    assert isinstance(get_model(use_color=True, k=4), DGCNNWithColor)
    assert type(get_model(num_classes=5, use_color=False)) is DGCNN
    assert get_loss() is masked_onehot_cross_entropy
    model = create_model("DeepGraphCnn", k=4, emb_dims=16)
    assert model.conv8.out_features == 14 and model.conv5.conv[0].in_features == 384
    assert model.conv5.conv[0].bias is None
    with pytest.raises(ValueError, match="6 channels"):
        model(torch.zeros(1, 16, 3))
    n_params = sum(p.numel() for p in create_model("DeepGraphCnn").parameters())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
        lambda: jax_create_model("DeepGraphCnn").init(
            jax.random.key(0), jnp.zeros((1, 32, 9)), train=False))["params"]))
    assert n_params == n_jax  # the reference width: same parameter count
