"""pointseg_torch's PointNeXt and PointNet++ MSG, and the two blocks they
add (`InvResMLP`, `SetAbstractionMSG`), against pointseg's on the CPU,
with the JAX weights carried over by `from_jax_variables`.

A flipped neighbour anywhere swamps a value comparison, so each model
test first replays every FPS, ball-query and 3-NN selection of the
forward pass in both packages and requires them equal, then compares
values. FPS starts at 0 in both, and dropout is 0 for the train step.
Everything is compared in the port's state_dict layout: a JAX tree
(parameters, gradients, updated parameters) goes through
`from_jax_variables`, which needs no inverse for the models that
`pointseg/io/torch_import.py` does not know (MSG, PointNeXt-B).

Tolerances: eval logits rtol/atol 1e-4 (matrix products and BatchNorm
reductions sum in another order); the train step by the noise-floor rule
of `tests/test_torch_model.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_blocks import _check_against, _inputs, _port_state, _randomized, _run_both

from pointseg import ops as jops
from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import create_model as jax_create_model
from pointseg.nn.blocks import InvResMLP as JaxInvResMLP
from pointseg.nn.blocks import SetAbstractionMSG as JaxSAMSG
from pointseg.ops.ballquery import set_filler_mode
from pointseg.train.loss import masked_onehot_cross_entropy as jax_ce
from pointseg_torch import ops as tops
from pointseg_torch.io import from_jax_variables
from pointseg_torch.models import PointNetPPMSG, PointNeXt, create_model
from pointseg_torch.nn import InvResMLP, SetAbstractionMSG
from pointseg_torch.train.loss import masked_onehot_cross_entropy
from pointseg_torch.train.state import TrainState, make_optimizer, train_step

torch.set_num_threads(2)

B, N = 2, 1024
LR = 1e-3
# name -> (model arguments at test size, input seed). The seeds are PINNED
# to draws whose selections agree between the packages: XLA's compiled CPU
# code contracts the Gram-form dot product into fused multiply-adds and
# the port does not, so at other seeds two near-equidistant ball-query
# neighbours swap places. Seeds 0-15 were tried for each family: the
# PointNeXt queries agree at 2, 7, 8, 9 and 12, the MSG queries at 2, 8, 9,
# 12 and 15.
MODELS = {
    "PointNeXt": (dict(width=8), 2),
    "PointNeXt-B": (dict(width=8), 8),
    "PointNet++MSG": ({}, 9),
}
SA = ((1024, 0.1), (256, 0.2), (64, 0.4), (16, 0.8))
# PointNeXt: the InvResMLP radii of each stage (extra blocks repeat the last) and K
IRMLP = (((0.1,), 32), ((0.1, 0.2), 32), ((0.4,), 32), ((0.8,), 16))
BLOCKS = {"PointNeXt": (1, 2, 1, 1), "PointNeXt-B": (2, 3, 2, 2)}
MSG = (((0.05, 16), (0.1, 32)), ((0.1, 16), (0.2, 32)), ((0.2, 16), (0.4, 32)),
       ((0.4, 16), (0.8, 32)))


def _stage_queries(name):
    """Per SA stage: its centroid count, the (radius, K) queries from the
    centroids into the stage's input, and those among the centroids."""
    if name == "PointNet++MSG":
        return [(C, list(scales), []) for (C, _), scales in zip(SA, MSG)]
    return [(C, [(r, 32)], [(radii[min(j, len(radii) - 1)], k) for j in range(n)])
            for (C, r), (radii, k), n in zip(SA, IRMLP, BLOCKS[name])]


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, N, 9), np.float32)
    # a 1 m x 1 m x 0.3 m slab: the 0.1 m balls hold ~14 points and the
    # 0.05 m ones ~2, so sparse balls and their fillers occur
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N, N - 100], np.int32)
    return x, y, lengths


def _jax_model(name, **kwargs):
    return jax_create_model(name, num_classes=14, **{**MODELS[name][0], **kwargs})


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cases():
    """Per model: (batch, JAX variables with BatchNorm moved off its init)."""
    out = {}
    for name, (_, seed) in MODELS.items():
        batch = _batch(seed)
        model = _jax_model(name, dropout=0.0)
        v = jax.jit(lambda k, x, m=model: m.init({"params": k}, x, train=False))(
            jax.random.key(0), jnp.asarray(batch[0]))
        out[name] = (batch, _randomized(_numpy_tree(v), 4))
    return out


def _port_model(name, variables, **kwargs):
    model = create_model(name, **{**MODELS[name][0], "dropout": 0.0, **kwargs})
    model.load_state_dict(from_jax_variables(name, variables))
    return model


def _selections(ops, coords, name, as_numpy):
    """Every selection of one forward pass, keyed by stage."""
    out, levels = {}, [coords]
    for i, (C, into_input, among) in enumerate(_stage_queries(name), start=1):
        idx = ops.farthest_point_sampling(levels[-1], C)
        if ops is jops:
            cents = jnp.take_along_axis(levels[-1], idx[..., None], axis=1)
        else:
            cents = ops.gather_rows(levels[-1], idx)
        out[f"sa{i}.fps"] = idx
        for s, (r, K) in enumerate(into_input):
            out[f"sa{i}.ball_query{s}"] = ops.ball_query(cents, levels[-1], r, K)[0]
        for j, (r, K) in enumerate(among):
            out[f"irmlp{i}_{j}.ball_query"] = ops.ball_query(cents, cents, r, K)[0]
        levels.append(cents)
    for i in range(4):  # fp4 .. fp1: targets level i, sources level i + 1
        out[f"fp{i + 1}.three_nn"] = ops.three_nn(levels[i], levels[i + 1])[1]
    return {k: as_numpy(v) for k, v in out.items()}


def _assert_same_selections(name, x):
    want = _selections(jops, jnp.asarray(x[..., :3]), name, np.asarray)
    got = _selections(tops, torch.from_numpy(x[..., :3].copy()), name, lambda t: t.numpy())
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_inv_res_mlp_matches_jax(pooling):
    coords, feats = _inputs(30, 2, 64, 8)
    jm = JaxInvResMLP(0.3, 8, 8, pooling=pooling)
    variables = _randomized(jm.init(jax.random.key(4), jnp.asarray(coords),
                                    jnp.asarray(feats)), 31)

    def emit(r):
        return r.inv_res_mlp("blk")

    port = InvResMLP(0.3, 8, 8, pooling=pooling)
    port.load_state_dict(_port_state(variables, emit, "blk."))
    assert set(port.state_dict()) >= {"neighbour_features_mlp.conv.0.weight",
                                      "point_features_mlp.conv.1.bias"}
    new_stats, grads = _run_both(jm, port, variables, [coords, feats], seed=32)
    _check_against(port, emit, "blk.", new_stats, grads)
    # the residual: coordinates pass through, features keep their width
    with torch.no_grad():
        out_coords, out = port.eval()(torch.from_numpy(coords), torch.from_numpy(feats))
    assert torch.equal(out_coords, torch.from_numpy(coords)) and out.shape == feats.shape


def test_inv_res_mlp_mask_matches_jax():
    coords, feats = _inputs(33, 2, 64, 8)
    mask = np.random.default_rng(34).random((2, 64)) > 0.3
    jm = JaxInvResMLP(0.3, 8, 8)
    variables = _randomized(jm.init(jax.random.key(5), jnp.asarray(coords),
                                    jnp.asarray(feats)), 35)
    port = InvResMLP(0.3, 8, 8).eval()
    port.load_state_dict(_port_state(variables, lambda r: r.inv_res_mlp("blk"), "blk."))
    want = jm.apply(variables, jnp.asarray(coords), jnp.asarray(feats), mask=jnp.asarray(mask))[1]
    with torch.no_grad():
        got = port(torch.from_numpy(coords), torch.from_numpy(feats),
                   mask=torch.from_numpy(mask))[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_set_abstraction_msg_matches_jax():
    coords, feats = _inputs(36, 2, 96, 4)
    jm = JaxSAMSG(16, (0.2, 0.4), (4, 8), ([8, 8], [8, 6, 12]))
    variables = _randomized(jm.init(jax.random.key(6), jnp.asarray(coords),
                                    jnp.asarray(feats)), 37)

    def emit(r):
        r.grouped_first("blk/scale_0_0", "blk.scales.0")
        r.mlp("blk/scale_0", "blk.scales.0", 1, first=1)
        r.grouped_first("blk/scale_1_0", "blk.scales.1")
        r.mlp("blk/scale_1", "blk.scales.1", 2, first=1)

    port = SetAbstractionMSG(16, (0.2, 0.4), (4, 8), 4, ([8, 8], [8, 6, 12]))
    port.load_state_dict(_port_state(variables, emit, "blk."))
    want_c, want_f = jm.apply(variables, jnp.asarray(coords), jnp.asarray(feats))
    with torch.no_grad():
        got_c, got_f = port.eval()(torch.from_numpy(coords), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))  # one FPS, the same picks
    assert got_f.shape == (2, 16, 8 + 12)
    new_stats, grads = _run_both(jm, port, variables, [coords, feats], seed=38)
    _check_against(port, emit, "blk.", new_stats, grads)
    with pytest.raises(ValueError, match="per scale"):
        SetAbstractionMSG(16, (0.2, 0.4), (4,), 4, ([8], [8]))


# ---------------------------------------------------------------- models


def test_registry_builds_the_four_names_with_ball_select_and_filler():
    for name, blocks in (("PointNeXt", (1, 2, 1, 1)), ("PointNeXt-B", (2, 3, 2, 2)),
                         ("PointNeXt-L", (3, 5, 3, 3))):
        model = create_model(name, width=8, ball_select="two_level", filler="index")
        assert isinstance(model, PointNeXt) and model.blocks == blocks
        irmlps = [k for k, _ in model.named_children() if k.startswith("irmlp")]
        assert len(irmlps) == sum(blocks)
        assert model.irmlp2_1.neighbour_features_mlp.radius == 0.2
        assert model.irmlp4.neighbour_features_mlp.K == 16
        grouped = [m for m in model.modules() if hasattr(m, "ball_select")]
        assert len(grouped) == 4 + sum(blocks)
        assert all(m.ball_select == "two_level" and m.filler == "index" for m in grouped)
    msg = create_model("PointNet++MSG", ball_select="two_level", filler="index")
    assert isinstance(msg, PointNetPPMSG)
    assert [s.K for s in msg.sa1.scales] == [16, 32]
    assert all(m.ball_select == "two_level" and m.filler == "index"
               for m in msg.modules() if hasattr(m, "ball_select"))
    assert create_model("PointNet++", ball_select="two_level").sa3.point_net.ball_select \
        == "two_level"
    with pytest.raises(ValueError, match="select"):
        create_model("PointNeXt", width=8, ball_select="strided")(torch.zeros(1, 1024, 9))


@pytest.mark.parametrize("name", ["PointNeXt", "PointNeXt-B", "PointNeXt-L", "PointNet++MSG"])
def test_import_maps_every_leaf(name):
    kwargs = {} if name == "PointNet++MSG" else {"width": 8}
    jm = jax_create_model(name, num_classes=14, **kwargs)
    v = _numpy_tree(jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(1), jnp.zeros((1, 1024, 9))))
    sd = from_jax_variables(name, v)  # raises on a leaf left over
    model = create_model(name, **kwargs)
    model.load_state_dict(sd)  # strict: every key, every shape
    n_jax = sum(a.size for a in jax.tree.leaves(v["params"]))
    assert n_jax == sum(p.numel() for p in model.parameters())
    extra = {**v, "params": {**v["params"], "spare": {"kernel": np.zeros(1)}}}
    with pytest.raises(ValueError, match="spare"):
        from_jax_variables(name, extra)
    first = "stem" if "stem" in v["params"] else "sa1"
    missing = {**v, "params": {k: t for k, t in v["params"].items() if k != first}}
    with pytest.raises(KeyError):
        from_jax_variables(name, missing)


def test_pointnext_weights_round_trip_exactly(cases):
    _, variables = cases["PointNeXt"]
    model = _port_model("PointNeXt", variables)
    back = from_torch_state_dict("PointNeXt", model.state_dict(), variables)
    for col in ("params", "batch_stats"):
        a, b = flatten_dict(back[col]), flatten_dict(variables[col])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{col}/{k}")


def test_default_pointnext_state_dict_loads_into_the_jax_model():
    """The port's default model (width 32, reference block schedule) keeps
    the reference torch key layout: its own initial weights go through
    `from_torch_state_dict` into the JAX model, which then gives the same
    eval logits."""
    x = _batch(MODELS["PointNeXt"][1])[0][:1]
    torch.manual_seed(0)
    model = create_model("PointNeXt").eval()
    jm = jax_create_model("PointNeXt", num_classes=14)
    template = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(0), jnp.asarray(x))
    variables = from_torch_state_dict("PointNeXt", model.state_dict(), template)
    _assert_same_selections("PointNeXt", x)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(cases, name):
    (x, _, _), variables = cases[name]
    _assert_same_selections(name, x)
    jm = _jax_model(name, dropout=0.0)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    model = _port_model(name, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        two_level = _port_model(name, variables, ball_select="two_level").eval()(
            torch.from_numpy(x))
    assert got.shape == (B, N, 14) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(two_level, got)  # on the CPU both run the plain version


@pytest.mark.parametrize("name", ["PointNeXt", "PointNet++MSG"])
def test_index_filler_matches_jax(cases, name):
    """`filler="index"` on the port's model is the JAX package's
    process-wide 'index' mode; the slab's sparse balls make the two
    fillers give different logits."""
    (x, _, _), variables = cases[name]
    jm = _jax_model(name, dropout=0.0)
    set_filler_mode("index")
    try:
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(x)))
    finally:
        set_filler_mode(None)
    with torch.no_grad():
        got = _port_model(name, variables, filler="index").eval()(torch.from_numpy(x))
        repeat = _port_model(name, variables).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert float((got - repeat).abs().max()) > 1e-2


def _torch_layout(name, params, batch_stats):
    """A JAX params tree (or gradients shaped like it) as numpy arrays under
    the port's parameter names."""
    sd = from_jax_variables(name, {"params": _numpy_tree(params),
                                   "batch_stats": _numpy_tree(batch_stats)})
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(cases, name):
    """One train step: loss, per-leaf gradients, BN running statistics
    and the parameters after Adam."""
    (x, y, lengths), variables = cases[name]
    _assert_same_selections(name, x)
    jm = _jax_model(name, dropout=0.0)

    def loss_fn(params):
        logits, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y), jnp.asarray(lengths)), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    tx = optax.adam(LR)
    updates, _ = tx.update(grads_j, tx.init(variables["params"]), variables["params"])
    after_j = _torch_layout(name, optax.apply_updates(variables["params"], updates), stats_j)
    grads_j = _torch_layout(name, grads_j, stats_j)

    # the port's train_step; generator None starts every FPS at index 0
    model = _port_model(name, variables)
    names = [k for k, _ in model.named_parameters()]
    p0 = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    state = TrainState(model, make_optimizer(model.parameters(), LR), generator=None)
    tx_, ty, tl = (torch.from_numpy(a) for a in (x, y, lengths))
    grads_t = {}
    state.optimizer.register_step_pre_hook(  # after backward, before Adam moves the weights
        lambda *_: grads_t.update({k: p.grad.numpy().copy()
                                   for k, p in model.named_parameters()}))
    metrics = train_step(state, tx_, ty, tl)
    # rtol 1e-4: in train mode the port's own float32 loss lies 2e-6 to 3e-5
    # from its float64 loss at these depths (batch statistics of up to 65k
    # rows, summed in float32), JAX's within 5e-6 of it
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j), rtol=1e-4, atol=1e-6)

    # f32 noise floor per leaf: the same step in float64 (selections stay f32)
    model64 = _port_model(name, variables).double().train()
    masked_onehot_cross_entropy(model64(tx_.double()), ty, tl).backward()
    grads_64 = {k: p.grad.float().numpy() for k, p in model64.named_parameters()}

    # the criterion of tests/test_torch_model.py: each leaf within 8x its
    # own f32 noise, or within 2e-3 (1 + |g|); global cosine > 0.995. At
    # PointNeXt's depth (some thirty BatchNorms on batch statistics) the
    # port's float32 gradient has a cosine of only 0.98-0.993 with its own
    # float64 evaluation, JAX's 0.998-0.999 (measured at widths 8 and 16, two
    # seeds, 2 and 4 threads), so the global bound is the cosine or: JAX no
    # farther from the port than twice the port's float64 evaluation is.
    dots = norm_t = norm_j = cross2 = noise2 = 0.0
    for k in names:
        got, want = grads_t[k], grads_j[k]
        cross = np.linalg.norm(got - want)
        noise = np.linalg.norm(got - grads_64[k])
        floor = 2e-3 * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * noise, floor), (k, cross, noise, floor)
        dots += float(got.ravel() @ want.ravel())
        norm_t += float((got ** 2).sum())
        norm_j += float((want ** 2).sum())
        cross2 += cross ** 2
        noise2 += noise ** 2
    cosine = dots / np.sqrt(norm_t * norm_j)
    assert cosine > 0.995 or cross2 <= 4.0 * noise2, (cosine, cross2, noise2)
    assert cosine > 0.97

    # running statistics follow flax's rule (biased variance). Held by the
    # same rule as the gradients: within 8x the port's own float32 noise
    # (its float64 twin just took the same forward pass) or within 1e-4.
    # Stage 4 normalises over 32 rows, where the float32 differences of
    # every layer before it show: measured noise 2e-4, JAX 5e-5 from float64.
    sd, sd64 = model.state_dict(), model64.state_dict()
    for k, want in after_j.items():
        if k.endswith(("running_mean", "running_var")):
            got = sd[k].numpy()
            noise = float(np.abs(got - sd64[k].numpy()).max())
            bound = max(8.0 * noise, 1e-4 * (1.0 + float(np.abs(want).max())))
            assert float(np.abs(got - want).max()) <= bound, (k, noise, bound)

    # Adam: torch's step on the port's gradients is optax's on the same ones
    # (optax forms 1 - b2^t in float32, torch in double: ~7e-6 relative on
    # the first step, 1e-8 absolute at lr 1e-3, plus 2 ulps of a weight)
    upd_t, _ = tx.update(grads_t, tx.init(p0), p0)
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), p0[k] + np.asarray(upd_t[k]), rtol=2.5e-7,
                                   atol=1e-5 * LR, err_msg=k)
    # ... and the two full steps agree wherever the two gradients agree in
    # sign and are clear of the noise; elsewhere only |step| <= lr holds
    for k in names:
        g_j, g_t = grads_j[k], grads_t[k]
        sure = (g_j * g_t > 0) & (np.abs(g_j) > 1e-5) & (np.abs(g_t) > 1e-5)
        np.testing.assert_allclose(sd[k].numpy()[sure], after_j[k][sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        step = np.abs(sd[k].numpy() - p0[k])
        assert np.all(step <= LR * (1 + 1e-5) + 2.5e-7 * np.abs(p0[k])), k
