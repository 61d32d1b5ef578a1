"""The port's evaluation against the JAX package's, on the CPU: the
sliding-window whole-room paths (`pointseg_torch/utils/`), the
batch-statistics eval step and the `evaluate` subcommand, with the JAX
model's PointNet++ weights carried over by `from_jax_variables`
(`tests/test_torch_model.py`'s, BatchNorm moved off its init).

With running BatchNorm statistics, predictions and the counts made of
them are equal. The rooms and blocks are seeded draws whose selections
agree between the packages (see `tests/test_torch_model.py`).
Confidences are held to 1e-5 against the same port model in float64 and
to 1e-3 against the JAX package's, whose float32 is the farther off: in a
window of 1,024 points SA1 keeps every point as a centroid, so FP1
interpolates each point from a source at distance 0, and XLA's
contracted Gram-form arithmetic leaves a d^2 of rounding noise there
where the port's stepwise arithmetic gives exactly 0.

With batch statistics the JAX package's float32 is farther off again
(flax's BatchNorm takes the variance as E[x^2] - E[x]^2 in float32,
which cancels on repeat-padded blocks), so there its predictions may
differ from the port's at near ties: the streams are held against JAX's
point by point, a point differing only where the float64 model's top two
averaged logits lie within `BATCH_TIE` of each other; the eval step, on
a batch where no such tie exists, exactly. The CLI's batch-statistics
runs (blocks, and whole rooms by the default device stream) equal the
port's own functions on the same weights.

Window 1024, overlap 128. The whole-room set has two rooms of 7,200
points: eight windows each, one full group of the streaming path, so
batch statistics see the same windows in both packages. The predict
test's room of 3,000 points has four windows, and the group's other four
are clamped windows past the room (of no valid point), which both
packages run and mask out.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointseg.data.datasets import ChunkedRoomDataset as JaxChunkedRoomDataset
from pointseg.data.datasets import ListLoader as JaxListLoader
from pointseg.data.datasets import create_block_dataloaders as jax_block_loaders
from pointseg.models import PointNetPP as JaxPointNetPP
from pointseg.train.loop import evaluate as jax_evaluate
from pointseg.train.loss import length_mask as jax_length_mask
from pointseg.train.state import TrainState as JaxTrainState
from pointseg.train.state import bn_batch_apply as jax_bn_batch_apply
from pointseg.train.state import make_eval_step as jax_make_eval_step
from pointseg.utils import evaluation as jax_evaluation
from pointseg.utils import sliding_window as jax_sw
from pointseg_torch import cli
from pointseg_torch.data import synthetic
from pointseg_torch.data.s3dis import S3DIS_CLASSES
from pointseg_torch.io.checkpoint import save_checkpoint
from pointseg_torch.train.state import TrainState, make_eval_step, make_optimizer
from pointseg_torch.utils import sliding_window
from test_torch_model import _port_model, batch, jax_variables  # noqa: F401  (fixtures)

torch.set_num_threads(2)

WINDOW, OVERLAP = 1024, 128
BATCH_TIE = 3e-3  # a flip needs a float64 top-two gap below this (under 1% of points)
METRICS = ("overall_accuracy", "mean_class_accuracy", "mean_iou", "class_accuracies",
           "class_ious", "total_points")


def jax_whole_room_forward(model, variables, bn_stats="running"):
    """`pointseg/cli.py::cmd_evaluate`'s forward9."""

    @jax.jit
    def forward9(points, lengths):
        p = jnp.asarray(points)
        m = jax_length_mask(jnp.asarray(lengths), p.shape[1])[..., None]
        big = jnp.float32(1e30)
        vmin = jnp.min(jnp.where(m, p[..., :3], big), axis=1, keepdims=True)
        vmax = jnp.max(jnp.where(m, p[..., :3], -big), axis=1, keepdims=True)
        center = jnp.concatenate([vmin[..., 0:1] + 0.5, vmin[..., 1:2] + 0.5,
                                  (vmin[..., 2:3] + vmax[..., 2:3]) / 2], axis=-1)
        p9 = jnp.concatenate([p, p[..., :3] - center], axis=-1)
        if bn_stats == "batch":
            return jax_bn_batch_apply(model, variables, p9)
        return model.apply(variables, p9, train=False)

    return forward9


@pytest.fixture(scope="module")
def forwards(jax_variables):  # noqa: F811
    """(JAX model, {bn_stats: JAX forward9}, port model, {bn_stats: port forward9})."""
    jm = JaxPointNetPP(num_classes=14, dropout=0.5)
    model = _port_model(jax_variables, dropout=0.5).eval()
    return (jm, {s: jax_whole_room_forward(jm, jax_variables, s) for s in ("running", "batch")},
            model, {s: cli.whole_room_forward(model, s) for s in ("running", "batch")})


def float64_forward(model, bn_stats="running"):
    """The port model's whole-room forward in float64 (a copy)."""
    twin = copy.deepcopy(model).double()
    forward = cli.whole_room_forward(twin, bn_stats)
    return lambda points, lengths: forward(points.double(), lengths)


@pytest.fixture(scope="module")
def rooms_dir(tmp_path_factory):
    return synthetic.make_chunked_dataset(
        str(tmp_path_factory.mktemp("rooms")), areas=(6,), rooms_per_area=2,
        points_per_room=7200, seed=3, with_index=False)


@pytest.fixture(scope="module")
def jax_room_results(forwards, rooms_dir):
    """JAX `evaluate_rooms` with running statistics, per stream."""

    def get(stream, bn_stats):
        loader = JaxListLoader(JaxChunkedRoomDataset(rooms_dir, [6], require_index_file=False), 1)
        return jax_evaluation.evaluate_rooms(forwards[1][bn_stats], loader, S3DIS_CLASSES,
                                             WINDOW, OVERLAP, verbose=False, stream=stream)

    return get


@pytest.fixture(scope="module")
def port_batch_predictions(forwards, rooms_dir):
    """The rooms and the port's batch-statistics predictions of each, by
    the streaming path."""
    from pointseg_torch.data.datasets import ChunkedRoomDataset

    ds = ChunkedRoomDataset(rooms_dir, [6], require_index_file=False)
    rooms = [ds[i] for i in range(len(ds))]
    return rooms, [sliding_window.predict_single_scene_device(
        forwards[3]["batch"], r["x"], WINDOW, OVERLAP, device="cpu")[0] for r in rooms]


@pytest.mark.parametrize("n", [1, 4096, 4097, 6896, 100_000, 3_000_001])
def test_bucket_matches_jax(n):
    assert sliding_window._bucket(n) == jax_sw._bucket(n)
    assert sliding_window._bucket(n, base=1024, ratio=1.5, quantum=256) == \
        jax_sw._bucket(n, base=1024, ratio=1.5, quantum=256)


def test_confusion_to_metrics_matches_jax():
    rng = np.random.default_rng(0)
    conf = rng.integers(0, 50, (14, 14))
    conf[3] = 0  # a class with no points
    conf[:, 5] = 0  # ... and one never predicted
    got = sliding_window.confusion_to_metrics(conf)
    want = jax_sw.confusion_to_metrics(conf)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_predict_single_scene_matches_jax(forwards):
    _, jax_fwd, _, port_fwd = forwards
    room = synthetic.make_room(np.random.default_rng(0), 3000)["points"]
    jp, jc = jax_sw.predict_single_scene(jax_fwd["running"], room, WINDOW, OVERLAP)
    jpd, jcd = jax_sw.predict_single_scene_device(jax_fwd["running"], room, WINDOW, OVERLAP)
    tp, tc = sliding_window.predict_single_scene(port_fwd["running"], room, WINDOW, OVERLAP,
                                                 device="cpu")
    tpd, tcd = sliding_window.predict_single_scene_device(port_fwd["running"], room, WINDOW,
                                                          OVERLAP, device="cpu")
    assert tp.shape == tpd.shape == (3000,) and tp.dtype == tpd.dtype == np.int32
    assert tc.dtype == tcd.dtype == np.float32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpd, jpd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tcd, jcd, rtol=0, atol=1e-3)
    avg64 = torch.from_numpy(sliding_window.scene_logits_host(
        float64_forward(forwards[2]), room, WINDOW, OVERLAP, device="cpu"))
    np.testing.assert_allclose(tc, torch.softmax(avg64.double(), -1).numpy()[
        np.arange(3000), tp], rtol=0, atol=1e-5)
    # the port's two streams: the same windows, batched 1 or 8 at a time
    np.testing.assert_array_equal(tpd, tp)
    np.testing.assert_allclose(tcd, tc, rtol=0, atol=1e-5)


def test_streaming_path_runs_clamped_windows_and_masks_them(forwards):
    """The four windows past the 3,000-point room run at their clamped
    start (buffer 4,096: start 3,072, no valid point) and add nothing."""
    seen = []

    def forward(points, lengths):
        seen.append((tuple(points.shape), lengths.tolist()))
        return forwards[3]["running"](points, lengths)

    room = synthetic.make_room(np.random.default_rng(0), 3000)["points"]
    buf = np.zeros((sliding_window._room_pad(3000, WINDOW, WINDOW - OVERLAP), 6), np.float32)
    buf[:3000] = room
    avg = sliding_window.scene_logits_device(forward, torch.from_numpy(buf), 3000, WINDOW,
                                             WINDOW - OVERLAP, 14)
    assert seen == [((8, WINDOW, 6), [1024, 1024, 1024, 312, 0, 0, 0, 0])]
    assert avg.shape == (4096, 14) and torch.isfinite(avg).all()
    assert torch.equal(avg[3000:], torch.zeros(1096, 14))


@pytest.mark.parametrize("stream", ["device", "host"])
def test_batch_statistics_streams_match_jax_outside_near_ties(forwards, port_batch_predictions,
                                                              stream):
    rooms, predictions = port_batch_predictions
    room = rooms[0]["x"]
    jax_fwd, model = forwards[1]["batch"], forwards[2]
    if stream == "device":
        got = predictions[0]
        want, _ = jax_sw.predict_single_scene_device(jax_fwd, room, WINDOW, OVERLAP)
        buf = torch.zeros((sliding_window._room_pad(7200, WINDOW, WINDOW - OVERLAP), 6))
        buf[:7200] = torch.from_numpy(room)
        avg64 = sliding_window.scene_logits_device(float64_forward(model, "batch"), buf, 7200,
                                                   WINDOW, WINDOW - OVERLAP, 14)[:7200]
    else:
        got, _ = sliding_window.predict_single_scene(forwards[3]["batch"], room, WINDOW, OVERLAP,
                                                     device="cpu")
        want, _ = jax_sw.predict_single_scene(jax_fwd, room, WINDOW, OVERLAP)
        avg64 = torch.from_numpy(sliding_window.scene_logits_host(
            float64_forward(model, "batch"), room, WINDOW, OVERLAP, device="cpu"))
    top2 = avg64.double().topk(2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]).numpy() < BATCH_TIE
    assert near_tie.mean() < 0.01
    np.testing.assert_array_equal(got[~near_tie], want[~near_tie])
    np.testing.assert_array_equal(got, avg64.argmax(-1).numpy())  # the port: float64's picks


def test_device_stream_batch_statistics_see_padding_windows(forwards):
    """ROADMAP.md F5, kept as in the JAX package: a group's windows past
    the room (zero valid points, their relative coordinates from the
    +-1e30 sentinels) enter the group's batch statistics, and the group's
    real windows come out as garbage (the JAX package's come out NaN,
    every point class 0). Running statistics never see them: there the
    two streams agree (`test_predict_single_scene_matches_jax`)."""
    room = synthetic.make_room(np.random.default_rng(0), 3000)["points"]
    fwd = forwards[3]["batch"]
    device, _ = sliding_window.predict_single_scene_device(fwd, room, WINDOW, OVERLAP,
                                                           device="cpu")
    host, _ = sliding_window.predict_single_scene(fwd, room, WINDOW, OVERLAP, device="cpu")
    assert (device != host).mean() > 0.5


def test_batch_norm_without_gradient_uses_accurate_statistics():
    """ROADMAP.md F6: under `bn_adapted_model` (batch statistics at
    evaluation, no gradient) the port's BatchNorm normalises with
    `torch.var_mean`'s statistics, within 1e-4 of float64, and so does a
    training forward with no gradient, which is the same arithmetic (it
    called `F.batch_norm`, whose CPU statistics sum in one float32 pass,
    until the training forward took `var_mean`'s too). Both leave the same
    running statistics, and the adapted forward puts them back. 65,536
    rows at a mean 300 times their spread."""
    from pointseg_torch.nn.mlp import BatchNorm
    from pointseg_torch.train.state import bn_adapted_model

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = BatchNorm(8)

        def forward(self, x, mask=None):
            return self.bn(x)

    rng = np.random.default_rng(0)
    x = torch.from_numpy((3.0 + 0.01 * rng.normal(size=(65536, 8))).astype(np.float32))
    want = torch.nn.functional.batch_norm(x.double(), None, None, training=True, eps=1e-5)

    net = Net().eval()
    adapted = bn_adapted_model(net)(x)
    assert not net.training and not net.bn.training
    assert float(net.bn.running_mean.abs().max()) == 0.0 and int(net.bn.num_batches_tracked) == 0
    error = float((adapted.double() - want).abs().max())
    assert error < 1e-4, error

    with torch.no_grad():
        trained = net.train()(x)
    assert torch.equal(trained, adapted)  # the adapted arithmetic is the training forward's
    kept = (net.bn.running_mean.clone(), net.bn.running_var.clone())
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=0, correction=0)
    print(f"max |error| against float64: adapted and training forward {error}")
    for a, b in zip(kept, (0.1 * mean, 0.9 + 0.1 * var)):  # flax's rule, biased variance
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)


def test_batch_norm_with_gradient_takes_accurate_statistics():
    """ROADMAP.md F6: a training forward with a gradient normalises with
    float32 `var_mean` statistics, within 1e-5 (relative) of float64's at
    65,536 rows whose mean is 300 times their spread, and folds the same
    ones into the running averages; `F.batch_norm(training=True)`'s output
    lay 6.9e-4 from float64's there on the CPU, the forward's lies within
    1e-4 (the mean's own float32 rounding, times the slope of about 150,
    is 1e-5). Its gradients, through the statistics, within 1e-4 of
    float64's relative to the largest (float32 sums of 65,536 terms)."""
    from pointseg_torch.nn.mlp import BatchNorm

    rng = np.random.default_rng(0)
    x = torch.from_numpy((3.0 + 0.01 * rng.normal(size=(65536, 8))).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(65536, 8)).astype(np.float32))
    bn, bn64 = BatchNorm(8).train(), BatchNorm(8).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 8)))
        bn.running_var.zero_()  # so the update is 0.1 x the batch's statistics
        bn64.load_state_dict(bn.state_dict())
    xs = x.clone().requires_grad_(True)
    x64 = x.double().requires_grad_(True)
    y, y64 = bn(xs), bn64(x64)
    assert y.dtype == torch.float32 and y.requires_grad
    var64, mean64 = torch.var_mean(x.double(), dim=0, correction=0)
    for got, want in ((bn.running_mean / 0.1, mean64), (bn.running_var / 0.1, var64)):
        assert float(((got.double() - want) / want).abs().max()) < 1e-5
    assert float((y.detach().double() - y64.detach()).abs().max()) < 1e-4
    (y * dy).sum().backward()
    (y64 * dy.double()).sum().backward()
    for got, want in ((xs.grad, x64.grad), (bn.weight.grad, bn64.weight.grad),
                      (bn.bias.grad, bn64.bias.grad)):
        assert float((got.double() - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_make_eval_step_batch_matches_jax(forwards, batch, jax_variables):  # noqa: F811
    jm, _, model, _ = forwards
    x, y, lengths = batch
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax_variables["params"],
                           batch_stats=jax_variables["batch_stats"], opt_state=None,
                           apply_fn=jm.apply, tx=None)
    want = jax_make_eval_step(jm, "batch")(jstate, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(lengths))

    state = TrainState(model, make_optimizer(model.parameters()), generator=None)
    model.train()  # the step must put every module's mode back as it found it
    model.fp1.eval()
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    got = make_eval_step(model, "batch")(state, *(torch.from_numpy(a) for a in batch))
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k  # running statistics and counts untouched
    assert model.training and not model.fp1.training and model.fp2.training
    model.eval()

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("correct", "total", "confusion"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("intersections", "unions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   err_msg=key)
    # batch statistics, not the running ones
    running = make_eval_step(model, "running")(state, *(torch.from_numpy(a) for a in batch))
    assert float(running["loss"]) != float(got["loss"])
    with pytest.raises(ValueError, match="bn_stats"):
        make_eval_step(model, "mean")


@pytest.fixture(scope="module")
def port_checkpoint(forwards, tmp_path_factory):
    model = forwards[2]
    path = tmp_path_factory.mktemp("ckpt")
    state = TrainState(model, make_optimizer(model.parameters()), generator=None, step=7)
    save_checkpoint(str(path), state, config={"model": "PointNet++", "static_graph": False})
    return str(path)


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each; area 6 has 9 blocks."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


def _port_cli(port_checkpoint, data, tmp_path, *flags):
    out = tmp_path / "results.json"
    cli.main(["evaluate", "--model-path", port_checkpoint, "--data-path", data,
              "--device", "cpu", "--save-results", str(out), *flags])
    return json.loads(out.read_text())


def test_cli_evaluate_blocks_matches_jax(forwards, jax_variables, port_checkpoint,  # noqa: F811
                                         tiny_blocks, tmp_path, capsys):
    got = _port_cli(port_checkpoint, tiny_blocks, tmp_path)
    out = capsys.readouterr().out
    assert "Loaded PointNet++ from" in out and "(step 7)" in out
    assert "=== Evaluation results ===" in out

    jm = forwards[0]
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax_variables["params"],
                           batch_stats=jax_variables["batch_stats"], opt_state=None,
                           apply_fn=jm.apply, tx=None)
    _, loader = jax_block_loaders(  # as pointseg/cli.py::cmd_evaluate builds it
        data_dir=tiny_blocks, test_areas={6}, test_batch_size=2, train_sampling=4096,
        test_sampling=None, test_buckets=cli.EVAL_BUCKETS, test_pad_mode="repeat")
    want = jax_evaluate(jstate, loader, num_classes=14)

    assert set(got) == {"accuracy", "mean_class_accuracy", "class_accuracies", "mean_iou",
                        "ious", "confusion"}
    np.testing.assert_array_equal(np.array(got["confusion"]), want["confusion"])
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["mean_class_accuracy"], want["mean_class_accuracy"],
                               rtol=1e-12)
    np.testing.assert_allclose(list(got["class_accuracies"].values()),
                               want["class_accuracies"], rtol=1e-12)
    np.testing.assert_allclose(got["mean_iou"], want["mean_iou"], rtol=1e-6)
    np.testing.assert_allclose(list(got["ious"].values()), want["ious"], rtol=1e-6)
    assert list(got["ious"]) == S3DIS_CLASSES


def test_cli_evaluate_blocks_with_batch_statistics(forwards, port_checkpoint, tiny_blocks,
                                                   tmp_path):
    from pointseg_torch.data.datasets import create_block_dataloaders
    from pointseg_torch.train.loop import evaluate

    got = _port_cli(port_checkpoint, tiny_blocks, tmp_path, "--bn-stats", "batch")
    model = forwards[2]
    _, loader = create_block_dataloaders(
        data_dir=tiny_blocks, test_areas={6}, test_batch_size=2, train_sampling=4096,
        test_sampling=None, test_buckets=cli.EVAL_BUCKETS, test_pad_mode="repeat")
    state = TrainState(model, make_optimizer(model.parameters()), generator=None)
    want = evaluate(state, loader, num_classes=14, step_fn=make_eval_step(model, "batch"))
    np.testing.assert_array_equal(np.array(got["confusion"]), want["confusion"])
    assert got["accuracy"] == want["accuracy"] and got["mean_iou"] == want["mean_iou"]


@pytest.mark.parametrize("stream", ["device", "host"])
def test_cli_evaluate_whole_rooms_matches_jax(port_checkpoint, rooms_dir, jax_room_results,
                                              tmp_path, stream):
    """`evaluate_rooms` of both packages, each stream, through the CLI."""
    got = _port_cli(port_checkpoint, rooms_dir, tmp_path, "--whole-rooms", "--window-size",
                    str(WINDOW), "--overlap", str(OVERLAP), "--stream", stream)
    want = jax_room_results(stream, "running")
    assert got.keys() == want.keys()
    assert got["total_points"] == 14_400 and got["class_names"] == S3DIS_CLASSES
    for key in METRICS:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_cli_evaluate_whole_rooms_with_batch_statistics(port_batch_predictions, port_checkpoint,
                                                        rooms_dir, tmp_path):
    got = _port_cli(port_checkpoint, rooms_dir, tmp_path, "--whole-rooms", "--window-size",
                    str(WINDOW), "--overlap", str(OVERLAP), "--bn-stats", "batch")
    rooms, predictions = port_batch_predictions
    confusion = np.zeros((14, 14), np.int64)
    for room, preds in zip(rooms, predictions):
        target = np.array([S3DIS_CLASSES.index(name) for name in room["y"]])
        np.add.at(confusion, (target, preds), 1)
    want = sliding_window.confusion_to_metrics(confusion)
    for key in METRICS:
        assert got[key] == want[key], key


def test_cli_evaluate_refusals(forwards, port_checkpoint, tiny_blocks, tmp_path, capsys,
                               monkeypatch):
    """`evaluate` computes in bfloat16 when the checkpoint's config sidecar
    says the run trained with `--bf16`, as the JAX package's does, and the
    same as with `--bf16` given on a float32 run's checkpoint (it was
    refused until bf16 was ported). A directory with no checkpoint is
    refused."""
    import pointseg_torch.models as models

    real, dtypes = models.create_model, []

    def create_model(*args, **kwargs):
        dtypes.append(kwargs["dtype"])
        return real(*args, **kwargs)

    monkeypatch.setattr(models, "create_model", create_model)
    model = forwards[2]
    bf16_run = tmp_path / "bf16_run"
    save_checkpoint(str(bf16_run), TrainState(model, make_optimizer(model.parameters()),
                                              generator=None, step=7),
                    config={"model": "PointNet++", "static_graph": False, "bf16": True})
    from_sidecar = _port_cli(str(bf16_run), tiny_blocks, tmp_path)
    assert "computing in bfloat16" in capsys.readouterr().out
    from_flag = _port_cli(port_checkpoint, tiny_blocks, tmp_path, "--bf16")
    assert dtypes == [torch.bfloat16, torch.bfloat16]
    assert from_sidecar == from_flag
    monkeypatch.undo()
    with pytest.raises(FileNotFoundError):
        cli.main(["evaluate", "--model-path", str(tmp_path), "--data-path", str(tmp_path),
                  "--device", "cpu", "--model", "PointNet++"])
