"""pointseg_torch's legacy stack (`train/legacy.py`, `train/enhanced.py`,
`train-legacy`) and the models' input width against pointseg's on the
CPU.

- Every registry model built at `in_dim=6` (the legacy stack's xyz + rgb
  rooms) in both packages from the same weights gives the same eval
  logits (rtol/atol 1e-4, as `tests/test_torch_model.py`). The input is
  256 points, so the first SetAbstraction takes 1024 centroids from 256
  points (C > N: after 256 picks every distance is 0 and FPS repeats the
  lowest index, in both packages). Its seed is pinned, as in the other
  model tests: XLA contracts the Gram form into fused multiply-adds and
  the port rounds each step, so near-equidistant neighbours can swap
  between the packages. At this size the balls are sparse and seeds 0-5
  all agree; re-search after a change to distance arithmetic.
- `preprocess_batch_to_train_format` gives JAX's arrays bit for bit.
- One `train_model` epoch of PointNet at `in_dim=6` on synthetic chunked
  rooms (five Adam steps at batch 4; at batch 2 a TNet's FC BatchNorm
  leaves only float32 noise in the gradient before it,
  `tests/test_torch_pointnet.py`) equals the JAX package's: per-epoch
  losses and accuracy at rtol 1e-4, and the records file's keys. The
  reference is the JAX model's float64 epoch, as in the float32
  train-step tests: flax's one-pass batch variance puts the JAX
  package's float32 epoch 3e-4 from float64 where the port's lies 3e-5.
  The rate is 1e-5, not the trainer's 1e-3: at 1e-3 these five steps
  are chaotic (Adam turns the float32 noise of near-zero gradients into
  whole steps of either sign). Measured: the two packages' float64 runs
  agree to 1e-7 for four steps and part by 3e-4 at the fifth, and the
  JAX package's own float32 and float64 epochs part by 4e-3.
- `train-legacy PointNet++ --device cpu` at a cut of 512 trains an epoch
  with SA1 at C = 1024 > N = 512, whose FPS indices equal JAX's oracle.
- `create_dgcnn_trainer` at k = 40 (past the flat kernel's 32) trains an
  epoch through the plain two-level kNN.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg import ops as jops
from pointseg.data.datasets import create_chunked_dataloaders as jax_chunked_loaders
from pointseg.models import MODEL_REGISTRY as JAX_MODELS
from pointseg.models import create_model as jax_create_model
from pointseg.train import legacy as jax_legacy
from pointseg.train import enhanced as jax_enhanced
from pointseg.train.state import create_train_state as jax_train_state
from pointseg_torch import cli, ops
from pointseg_torch.data import synthetic
from pointseg_torch.data.datasets import create_chunked_dataloaders
from pointseg_torch.data.s3dis import S3DIS_CLASSES, S3DIS_CLASSES_13
from pointseg_torch.io import from_jax_variables
from pointseg_torch.models import create_model
from pointseg_torch.train import enhanced, legacy
from pointseg_torch.train.state import create_train_state

torch.set_num_threads(2)

B, N = 2, 256
INPUT_SEED = 0  # pinned: see the module docstring


def _random_variables(model, x, seed):
    """The model's variable shapes (traced, not compiled) filled with
    numpy draws: weights of Kaiming scale, BatchNorm moved off its init."""
    shapes = jax.eval_shape(lambda x: model.init({"params": jax.random.key(0)}, x, train=False),
                            x)
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in shapes.items():
        flat = flatten_dict(tree)
        for path, leaf in flat.items():
            if path[-1] in ("scale", "var"):
                value = rng.uniform(0.5, 1.5, leaf.shape)
            elif path[-1] in ("mean", "bias"):
                value = rng.normal(0, 0.1, leaf.shape)
            else:  # a kernel (fan_in, out)
                value = rng.normal(0, 1.0 / math.sqrt(leaf.shape[0]), leaf.shape)
            flat[path] = np.asarray(value, np.float32)
        out[col] = unflatten_dict(flat)
    return out


@pytest.mark.parametrize("name", sorted(JAX_MODELS))  # PointNeXt-XL: test_torch_pointnext_xl.py
def test_every_model_takes_the_rooms_input_width_as_jax_does(name):
    rng = np.random.default_rng(INPUT_SEED)
    x = np.zeros((B, N, 6), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((B, N, 3))
    jax_model = jax_create_model(name, num_classes=13,
                                 **({"in_dim": 6} if name == "PointNet" else {}))
    variables = _random_variables(jax_model, jnp.asarray(x), seed=5)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))

    model = create_model(name, num_classes=13, in_dim=6)
    model.load_state_dict(from_jax_variables(name, variables))  # strict: every key and shape
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _rooms(seed, lengths, D=6):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(n, D)).astype(np.float32) for n in lengths]
    ys = [[S3DIS_CLASSES_13[int(c)] for c in rng.integers(0, 13, n)] for n in lengths]
    return xs, ys


@pytest.mark.parametrize("lengths,cut,sampling,pad_multiple", [
    ((10, 25), None, None, 16),
    ((600, 140, 333), None, None, 512),
    ((600, 1300), 1000, None, 512),
    ((600, 1300), 256, 0.5, 512),
    ((90, 47), 64, 0.3, 1),
    ((100,), None, 0.25, 1),  # B == 1: cont is False
])
def test_preprocess_batch_is_bit_equal_to_jax(lengths, cut, sampling, pad_multiple):
    xs, ys = _rooms(3, lengths)
    want = jax_legacy.preprocess_batch_to_train_format(
        xs, ys, S3DIS_CLASSES_13, cut=cut, sampling=sampling,
        rng=np.random.default_rng(7), pad_multiple=pad_multiple)
    got = legacy.preprocess_batch_to_train_format(
        xs, ys, S3DIS_CLASSES_13, cut=cut, sampling=sampling,
        rng=np.random.default_rng(7), pad_multiple=pad_multiple)
    for w, g in zip(want[:3], got[:3]):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == (len(lengths) > 1)


def test_preprocess_refuses_what_jax_refuses():
    xs, ys = _rooms(4, (10, 12))
    with pytest.raises(ValueError, match="sampling"):
        legacy.preprocess_batch_to_train_format(xs, ys, S3DIS_CLASSES_13, sampling=1.5)
    with pytest.raises(ValueError, match="not present in mapping"):
        legacy.preprocess_batch_to_train_format(xs, ys, S3DIS_CLASSES[:3])


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """Areas 1-6 of four synthetic rooms of 400 points each."""
    return synthetic.make_chunked_dataset(str(tmp_path_factory.mktemp("rooms")),
                                          rooms_per_area=4, points_per_room=400, seed=0)


def test_legacy_epoch_of_pointnet_matches_jax(rooms, tmp_path):
    """The port's float32 epoch against the JAX model's float64 epoch
    (module docstring: why float64 and a rate of 1e-5)."""
    cut, batch, lr = 512, 4, 1e-5
    jax_model = jax_create_model("PointNet", num_classes=13, in_dim=6)
    jstate = jax_train_state(jax_model, jnp.zeros((batch, cut, 6), jnp.float32), lr, seed=0)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    model = create_model("PointNet", num_classes=13, in_dim=6)
    model.load_state_dict(from_jax_variables("PointNet", variables))
    state = create_train_state(model, device="cpu", learning_rate=lr, seed=0)
    _, got = legacy.train_model(
        state, *create_chunked_dataloaders(rooms, batch_size=batch), S3DIS_CLASSES_13,
        epochs=1, records_dir=str(tmp_path / "port"), cut=cut, seed=0)

    with jax.enable_x64():
        model64 = jax_create_model("PointNet", num_classes=13, in_dim=6, dtype=jnp.float64)
        state64 = jax_train_state(model64, jnp.zeros((batch, cut, 6), jnp.float64), lr, seed=0)
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables[c])
                         for c in ("params", "batch_stats"))
        state64 = state64.replace(params=params, batch_stats=stats,
                                  opt_state=state64.tx.init(params))
        _, want = jax_legacy.train_model(
            state64, *jax_chunked_loaders(rooms, batch_size=batch), S3DIS_CLASSES_13,
            epochs=1, records_dir=str(tmp_path / "jax"), cut=cut, seed=0)
    assert state.step == 5  # 20 rooms of areas 1-5 at batch 4
    for key in ("train_loss", "val_loss", "val_acc"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    written = [json.loads((tmp_path / side / "records.json").read_text())
               for side in ("jax", "port")]
    assert written[0].keys() == written[1].keys() == got.keys()


def test_train_legacy_pointnetpp_takes_more_centroids_than_points(rooms, tmp_path, capsys):
    state, records = cli.train_legacy_from_args(cli.build_parser().parse_args(
        ["train-legacy", "PointNet++", "--data-dir", rooms, "--device", "cpu", "--epochs", "1",
         "--cut", "512", "--records-dir", str(tmp_path)]))
    assert "Epoch 1/1" in capsys.readouterr().out
    assert state.step == 10  # 20 rooms at the default batch of 2
    assert all(math.isfinite(records[k][0]) for k in ("train_loss", "val_loss"))
    assert json.loads((tmp_path / "records.json").read_text()).keys() == records.keys()
    assert state.model.sa1.point_net.conv[0].in_features == 3 + 3  # xyz + rgb
    # SA1's FPS at the epoch's shape: 1024 centroids of 512 points, as JAX picks them
    coords = np.random.default_rng(9).random((2, 512, 3)).astype(np.float32)
    got = ops.farthest_point_sampling(torch.from_numpy(coords), 1024)
    want = jops.farthest_point_sampling(jnp.asarray(coords), 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got[0].numpy())) == 512


def test_create_dgcnn_trainer_trains_at_k_40_on_the_plain_two_level_knn(
        rooms, tmp_path, monkeypatch):
    from pointseg_torch.ops import knn as knn_module

    seen = []
    plain = knn_module.knn_indices_plain

    def counted(x, k, **kwargs):
        seen.append((tuple(x.shape), k))
        return plain(x, k, **kwargs)

    monkeypatch.setattr(knn_module, "knn_indices_plain", counted)
    train, cfg = enhanced.create_dgcnn_trainer(
        emb_dims=64, cut=256, epochs=1, device="cpu", verbose=False, mapping=S3DIS_CLASSES_13,
        num_classes=13, records_dir=str(tmp_path))
    want_cfg = jax_enhanced.create_dgcnn_trainer(emb_dims=64, cut=256)[1]
    assert cfg["k"] == want_cfg["k"] == 40 and cfg["sampling"] == want_cfg["sampling"] == 0.5
    state, records = train(*create_chunked_dataloaders(rooms, batch_size=2))
    assert state.step == 10
    assert seen and {k for _, k in seen} == {40} and {s[1] for s, _ in seen} == {256}
    assert set(records) == {"train_loss", "val_loss", "val_acc", "epoch_times", "config",
                            "total_time"}
    assert math.isfinite(records["train_loss"][0]) and records["config"]["k"] == 40
    assert (tmp_path / "dgcnn_records.json").exists()


def test_quick_test_model_reports_the_jax_keys():
    got = enhanced.quick_test_model(k=8, emb_dims=32, n_points=128, verbose=False,
                                    device="cpu")
    assert set(got) == {"output_shape", "compile_time_s", "steady_time_s", "num_params",
                        "memory"}
    assert got["output_shape"] == (2, 128, 14) and got["num_params"] > 0
