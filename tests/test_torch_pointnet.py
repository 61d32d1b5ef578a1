"""pointseg_torch's PointNet (segmentation and classification) against
pointseg's on the CPU, with the JAX model's weights carried over by
`from_jax_variables`, and `train PointNet` / `evaluate` through the
port's CLI.

PointNet selects nothing, so no input seed needs pinning: every
comparison is of values. The batch is B = 8 (the reference's) of N = 64
points: at B = 2 a TNet's FC BatchNorm, over the B pooled rows,
normalises the two rows to -1 and +1 whatever its input, so the gradient
of everything before it is 0 in exact arithmetic and float32 noise in
both packages (relative gradient distances of 1e3 and more, measured).
Tolerances: eval logits rtol/atol 1e-4 (as
`tests/test_torch_model.py`); the train step's loss rtol 1e-5, each
gradient leaf within 8x the float32 noise (the distance from the JAX
model's float64 step; the larger of the two packages') or 2e-3 (1 + |g|),
global cosine > 0.995, running statistics rtol 1e-4 / atol 1e-5, and
Adam's update as `tests/test_torch_model.py` holds it; the port's float64
step equals JAX's to rtol 2.5e-7 (loss: both packages take the
log-softmax in float32) and 1e-6 (each leaf).
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg.io import torch_import
from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import MODEL_REGISTRY as JAX_MODELS
from pointseg.models import PointNetCls as JaxPointNetCls
from pointseg.models import PointNetSeg as JaxPointNetSeg
from pointseg.train.loss import masked_onehot_cross_entropy as jax_ce
from pointseg.train.state import TrainState as JaxTrainState
from pointseg.train.state import make_eval_step as jax_make_eval_step
from pointseg_torch import cli
from pointseg_torch.data import synthetic
from pointseg_torch.io import from_jax_variables
from pointseg_torch.models import MODELS, PointNetCls, PointNetSeg, create_model
from pointseg_torch.train.loss import length_mask, masked_onehot_cross_entropy
from pointseg_torch.train.state import TrainState, make_eval_step, make_optimizer, train_step

torch.set_num_threads(2)

B, N = 8, 64
LR = 1e-3
VARIANTS = [("PointNet", False), ("PointNet", True), ("PointNetCls", False),
            ("PointNetCls", True)]
JAX_CLASSES = {"PointNet": JaxPointNetSeg, "PointNetCls": JaxPointNetCls}
PORT_CLASSES = {"PointNet": PointNetSeg, "PointNetCls": PointNetCls}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N] * (B - 1) + [N - 56], np.int32)
    return x, y, lengths


def _jax_model(name, feature_transform):
    return JAX_CLASSES[name](num_classes=14, feature_transform=feature_transform)


@pytest.fixture(scope="module")
def jax_variables(batch):
    """Per variant: JAX-initialised variables with BatchNorm moved off its
    init."""
    out = {}
    for name, ft in VARIANTS:
        v = _jax_model(name, ft).init({"params": jax.random.key(0)}, jnp.asarray(batch[0]),
                                      train=False)
        rng = np.random.default_rng(4)
        tree = {}
        for col, sub in v.items():
            flat = flatten_dict(jax.tree.map(np.asarray, sub))
            for path, leaf in flat.items():
                is_bn = path[-2].startswith(("BatchNorm", "bn"))
                if path[-1] in ("scale", "var"):
                    leaf = rng.uniform(0.5, 1.5, leaf.shape)
                elif path[-1] == "mean" or (path[-1] == "bias" and is_bn):
                    leaf = rng.normal(0, 0.1, leaf.shape)
                flat[path] = np.asarray(leaf, np.float32)
            tree[col] = unflatten_dict(flat)
        out[name, ft] = tree
    return out


def _port_model(name, ft, variables):
    model = PORT_CLASSES[name](num_classes=14, feature_transform=ft)
    model.load_state_dict(from_jax_variables(name, variables))  # strict
    return model


def _to_jax(name, ft, state_dict, template, monkeypatch):
    """`from_torch_state_dict`, whose PointNet importers read no feature
    TNet: with `ft` its encoder importer is called with the flag set."""
    if ft:
        importer = {"PointNet": torch_import._import_pointnet,
                    "PointNetCls": torch_import._import_pointnet_cls}[name]
        monkeypatch.setitem(torch_import._IMPORTERS, name,
                            lambda w: importer(w, feature_transform=True))
    return from_torch_state_dict(name, state_dict, template)


@pytest.mark.parametrize("name,ft", VARIANTS)
def test_pointnet_weights_round_trip_exactly(name, ft, jax_variables, monkeypatch):
    v = jax_variables[name, ft]
    model = _port_model(name, ft, v)
    assert any(k.startswith("feat.fstn.") for k in model.state_dict()) == ft
    assert {"feat.stn.conv3.weight", "feat.stn.bn5.running_var", "feat.stn.fc3.bias",
            "feat.conv3.weight", "feat.bn3.running_mean"} <= set(model.state_dict())
    back = _to_jax(name, ft, model.state_dict(), v, monkeypatch)
    for col in ("params", "batch_stats"):
        a, b = flatten_dict(back[col]), flatten_dict(v[col])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{col}/{k}")


def test_pointnet_import_refuses_leftover_and_missing_leaves(jax_variables):
    v = jax_variables["PointNet", False]
    extra = {**v, "params": {**v["params"], "spare": {"kernel": 0}}}
    with pytest.raises(ValueError, match="spare"):
        from_jax_variables("PointNet", extra)
    missing = {**v, "params": {k: val for k, val in v["params"].items() if k != "conv4"}}
    with pytest.raises(KeyError, match="conv4"):
        from_jax_variables("PointNet", missing)
    with pytest.raises(KeyError, match="fc1"):  # a segmentation tree is no classifier
        from_jax_variables("PointNetCls", v)
    with pytest.raises(ValueError, match="unknown model"):
        from_jax_variables("PointNet3", v)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,ft", VARIANTS)
def test_pointnet_eval_logits_match_jax(name, ft, masked, batch, jax_variables):
    x, _, lengths = batch
    v = jax_variables[name, ft]
    mask = length_mask(torch.from_numpy(lengths), N) if masked else None
    jm = _jax_model(name, ft)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False,
                               mask=None if mask is None else jnp.asarray(mask.numpy())))
    model = _port_model(name, ft, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=mask)
    assert got.dtype == torch.float32
    assert got.shape == ((B, N, 14) if name == "PointNet" else (B, 14))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if masked:  # the padded points reach no max-pool
        with torch.no_grad():
            unmasked = model(torch.from_numpy(x))
        assert float((got - unmasked).abs().max()) > 1e-3


def _grads_as_flax(name, ft, model, template, monkeypatch):
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in model.named_parameters()}
    sd.update({k: b for k, b in model.named_buffers()})
    return flatten_dict(_to_jax(name, ft, sd, template, monkeypatch)["params"], sep="/")


def _jax_step(jm, v, batch):
    """(loss, batch_stats, flat gradients) of JAX's train-mode forward."""
    x, y, lengths = (jnp.asarray(a) for a in batch)

    def loss_fn(params):
        logits, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return jax_ce(logits, y, lengths), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return float(loss), stats, flatten_dict(jax.tree.map(np.asarray, grads), sep="/")


@pytest.mark.parametrize("ft", [False, True])
def test_pointnet_train_step_matches_jax(ft, batch, jax_variables, monkeypatch):
    """One train step of the registry model: loss, per-leaf gradients,
    BatchNorm running statistics (flax momentum 0.9 is the port's 0.1,
    the TNets' FC BatchNorms over the B pooled rows) and Adam's update.

    The float32 noise of a leaf is measured against the JAX model's
    float64 step (the loss's log-softmax in float32 in both packages),
    which the port's float64 step equals to 1e-6 of each leaf's norm (the
    same function). The JAX package's float32 is the far
    one (flax's one-pass batch variance over the 1024 channels before each
    pool: 1e-2 of a leaf's norm where the port's is 1e-5), so the noise
    bound of the cross comparison is the larger of the two packages'."""
    x, y, lengths = batch
    v = jax_variables["PointNet", ft]
    loss_j, stats_j, grads_j = _jax_step(_jax_model("PointNet", ft), v, batch)
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        jm64 = JaxPointNetSeg(num_classes=14, feature_transform=ft, dtype=jnp.float64)
        loss_64, _, grads_64 = _jax_step(jm64, v64, (x.astype(np.float64), y, lengths))

    model = _port_model("PointNet", ft, v)
    state = TrainState(model, make_optimizer(model.parameters(), LR), generator=None)
    tx, ty, tl = (torch.from_numpy(a) for a in batch)
    grads_t = None

    def capture_grads():  # after backward, before Adam updates the weights
        nonlocal grads_t
        grads_t = _grads_as_flax("PointNet", ft, model, v, monkeypatch)

    state.optimizer.register_step_pre_hook(lambda *_: capture_grads())
    metrics = train_step(state, tx, ty, tl)
    np.testing.assert_allclose(float(metrics["loss"]), loss_j, rtol=1e-5, atol=1e-6)

    model64 = _port_model("PointNet", ft, v).double().train()
    loss64 = masked_onehot_cross_entropy(model64(tx.double()), ty, tl)
    loss64.backward()
    # both losses take a float32 log-softmax, whatever the model's dtype
    np.testing.assert_allclose(float(loss64.detach()), loss_64, rtol=2.5e-7)
    port_64 = {k: g.astype(np.float64) for k, g in _grads_as_flax(
        "PointNet", ft, model64, v, monkeypatch).items()}

    # each leaf within 8x the larger float32 noise, or within 2e-3 (1 + |g|)
    # (the criterion of tests/test_torch_model.py); global cosine > 0.995
    dots = norm_t = norm_j = 0.0
    assert grads_t.keys() == grads_j.keys() == grads_64.keys()
    noise_t, noise_j = {}, {}
    for k, want in grads_j.items():
        got, exact = grads_t[k], grads_64[k]
        assert np.linalg.norm(port_64[k] - exact) <= 1e-6 * np.linalg.norm(exact) + 1e-12, k
        cross = np.linalg.norm(got - want)
        noise_t[k], noise_j[k] = np.linalg.norm(got - exact), np.linalg.norm(want - exact)
        floor = 2e-3 * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * max(noise_t[k], noise_j[k]), floor), (
            k, cross, noise_t[k], noise_j[k], floor)
        dots += float(got.ravel() @ want.ravel())
        norm_t += float((got ** 2).sum())
        norm_j += float((want ** 2).sum())
    assert dots / np.sqrt(norm_t * norm_j) > 0.995
    size = {k: np.linalg.norm(g) for k, g in grads_64.items()}
    worst = max((k for k in noise_j if size[k] > 1e-3), key=lambda k: noise_j[k] / size[k])
    print(f"feature_transform={ft}: loss port {float(metrics['loss']):.9f}, JAX {loss_j:.9f}, "
          f"float64 {loss_64:.9f}; the leaf (|g| > 1e-3) farthest from float64 in JAX's "
          f"float32: {worst} "
          f"(|g| {size[worst]:.3g}, JAX {noise_j[worst]:.3g}, port "
          f"{noise_t[worst]:.3g})")

    stats_t = _to_jax("PointNet", ft, model.state_dict(), v, monkeypatch)
    flat_t = flatten_dict(stats_t["batch_stats"], sep="/")
    for k, want in flatten_dict(jax.tree.map(np.asarray, stats_j), sep="/").items():
        np.testing.assert_allclose(flat_t[k], want, rtol=1e-4, atol=1e-5, err_msg=k)

    # Adam: torch's step on the port's gradients is optax's on the same
    # ones (optax's bias correction in float32, torch's in double: 1e-8 at
    # lr 1e-3, plus 2 ulps of a weight) ...
    params_t = flatten_dict(stats_t["params"], sep="/")
    p0 = flatten_dict(jax.tree.map(np.asarray, v["params"]), sep="/")
    tx_opt = optax.adam(LR)
    upd_t, _ = tx_opt.update(unflatten_dict(grads_t, sep="/"), tx_opt.init(v["params"]),
                             v["params"])
    for k, u in flatten_dict(jax.tree.map(np.asarray, upd_t), sep="/").items():
        np.testing.assert_allclose(params_t[k], p0[k] + u, rtol=2.5e-7, atol=1e-5 * LR,
                                   err_msg=k)
    # ... and the two full steps agree wherever the two gradients agree in
    # sign away from 0; elsewhere only |step| <= lr holds
    upd_j, _ = tx_opt.update(unflatten_dict(grads_j, sep="/"), tx_opt.init(v["params"]),
                             v["params"])
    params_j = flatten_dict(jax.tree.map(np.asarray, optax.apply_updates(v["params"], upd_j)),
                            sep="/")
    for k, want in params_j.items():
        g_j, g_t = grads_j[k], grads_t[k]
        sure = (g_j * g_t > 0) & (np.abs(g_j) > 1e-5) & (np.abs(g_t) > 1e-5)
        np.testing.assert_allclose(params_t[k][sure], want[sure], rtol=0, atol=1e-6, err_msg=k)
        step = np.abs(params_t[k] - p0[k])
        assert np.all(step <= LR * (1 + 1e-5) + 2.5e-7 * np.abs(p0[k])), k


def test_pointnet_train_step_at_batch_one_matches_jax(batch, jax_variables, monkeypatch):
    """ROADMAP.md F8: a train step at B = 1, which `F.batch_norm` refused
    (the TNets' FC BatchNorms see one pooled row). One row normalises to
    the BatchNorm's bias, as flax's does, so the gradient of every layer
    before them is 0 in exact arithmetic. The loss within rtol 1e-5 of the
    JAX model's; each gradient leaf by the criterion of
    `test_pointnet_train_step_matches_jax` against the JAX model's float64
    step; the running statistics within rtol 1e-4 / atol 1e-5."""
    one = tuple(a[:1] for a in batch)
    x, y, lengths = one
    v = jax_variables["PointNet", False]
    loss_j, stats_j, grads_j = _jax_step(_jax_model("PointNet", False), v, one)
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        jm64 = JaxPointNetSeg(num_classes=14, dtype=jnp.float64)
        _, _, grads_64 = _jax_step(jm64, v64, (x.astype(np.float64), y, lengths))

    model = _port_model("PointNet", False, v)
    state = TrainState(model, make_optimizer(model.parameters(), LR), generator=None)
    grads_t = {}
    state.optimizer.register_step_pre_hook(lambda *_: grads_t.update(
        _grads_as_flax("PointNet", False, model, v, monkeypatch)))
    metrics = train_step(state, *(torch.from_numpy(a) for a in one))
    np.testing.assert_allclose(float(metrics["loss"]), loss_j, rtol=1e-5, atol=1e-6)
    assert grads_t.keys() == grads_j.keys() == grads_64.keys()
    for k, want in grads_j.items():
        got, exact = grads_t[k], grads_64[k]
        assert np.all(np.isfinite(got)), k
        cross = np.linalg.norm(got - want)
        noise = max(np.linalg.norm(got - exact), np.linalg.norm(want - exact))
        floor = 2e-3 * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * noise, floor), (k, cross, noise, floor)
    stats_t = _to_jax("PointNet", False, model.state_dict(), v, monkeypatch)
    flat_t = flatten_dict(stats_t["batch_stats"], sep="/")
    for k, want in flatten_dict(jax.tree.map(np.asarray, stats_j), sep="/").items():
        np.testing.assert_allclose(flat_t[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    with torch.no_grad():  # the TNet's FC BatchNorm gave its bias
        fc = model.feat.stn
        pooled = torch.amax(torch.relu(fc.bn3(fc.conv3(torch.relu(fc.bn2(fc.conv2(torch.relu(
            fc.bn1(fc.conv1(torch.from_numpy(x)))))))))), dim=1)
        h = fc.fc1(pooled)
        # exactly where the normalisation centres first (flax; the card's
        # elementwise kernel); the CPU's `F.batch_norm` folds the mean into
        # the shift, so there within two float32 ulps of h * weight / sqrt(eps)
        ulps = 2 * torch.finfo(torch.float32).eps * (h * fc.bn4.weight).abs() / fc.bn4.eps ** 0.5
        assert bool(((fc.bn4(h) - fc.bn4.bias[None, :]).abs() <= ulps).all())


def test_pointnet_make_eval_step_batch_matches_jax(batch, jax_variables):
    """`make_eval_step(model, "batch")` against JAX's: every BatchNorm on
    the statistics of the batch at hand; the running statistics, their
    counts and every module's mode stay as they were."""
    x, y, lengths = batch
    v = jax_variables["PointNet", False]
    model = _port_model("PointNet", False, v).eval()
    jm = _jax_model("PointNet", False)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=None, apply_fn=jm.apply,
                           tx=None)
    want = jax_make_eval_step(jm, "batch")(jstate, *(jnp.asarray(a) for a in batch))
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    state = TrainState(model, make_optimizer(model.parameters()), generator=None)
    got = make_eval_step(model, "batch")(state, *(torch.from_numpy(a) for a in batch))
    for k, b in model.named_buffers():
        assert torch.equal(b, buffers[k]), k
    assert not any(m.training for m in model.modules())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("correct", "total", "confusion"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    running = make_eval_step(model, "running")(state, *(torch.from_numpy(a) for a in batch))
    assert abs(float(running["loss"]) - float(got["loss"])) > 1e-3


def test_registry_holds_every_jax_model_and_refuses_unknown_names():
    assert set(JAX_MODELS) <= set(MODELS)
    assert set(MODELS) - set(JAX_MODELS) == {"PointNeXt-XL"}  # the port's own
    assert sorted(MODELS) == sorted(cli.MODEL_CHOICES)
    assert isinstance(create_model("PointNet"), PointNetSeg)
    assert "PointNetCls" not in MODELS
    with pytest.raises(ValueError, match="Unknown model 'PointNetCls'"):
        create_model("PointNetCls")
    assert cli.filler_switch("PointNet") == {}


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each: 45 train blocks."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


def test_cli_trains_pointnet_and_evaluates_with_both_statistics(tiny_blocks, tmp_path, capsys,
                                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    torch.manual_seed(0)
    cli.main(["train", "PointNet", "--data-dir", tiny_blocks, "--device", "cpu",
              "--epochs", "1", "--train-sampling", "256", "--test-sampling", "256",
              "--num-workers", "0", "--log-dir", str(tmp_path / "logs"),
              "--model-dir", str(tmp_path / "models")])
    assert "Epoch 1 completed" in capsys.readouterr().out
    (records,) = list((tmp_path / "logs").rglob("records.json"))
    rec = json.loads(records.read_text())
    assert math.isfinite(rec["train_loss"][0]) and math.isfinite(rec["val_loss"][0])
    assert rec["config"]["filler"] is None
    (run_dir,) = (tmp_path / "models" / "PointNet").iterdir()
    results = {}
    for stats in ("running", "batch"):
        results[stats] = cli.evaluate_from_args(cli.build_parser().parse_args(
            ["evaluate", "--model-path", str(run_dir), "--data-path", tiny_blocks,
             "--device", "cpu", "--sampling", "256", "--bn-stats", stats,
             "--save-results", str(tmp_path / f"{stats}.json")]))
        out = capsys.readouterr().out
        assert "Loaded PointNet from" in out and "Mean IoU:" in out
        assert math.isfinite(results[stats]["loss"])
        saved = json.loads((tmp_path / f"{stats}.json").read_text())
        assert 0.0 <= saved["accuracy"] <= 1.0
    assert results["running"]["loss"] != results["batch"]["loss"]
