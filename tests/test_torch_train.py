"""pointseg_torch.train and the port's CLI on the CPU.

Loss and metrics go through pointseg.train and the port on the same
numpy inputs (tolerance rtol 1e-5: the same float32 formulas summed in
another order; counts exactly). The CLI trains PointNet++ end to end on
a tiny synthetic dataset with `--device cpu`, and DGCNN likewise, also
from the device-resident store (`--device-data` with every
`--device-store`, `--pack-cache`, `--scan-steps`) and with
`--accum-steps`.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointseg_torch.data import synthetic
from pointseg.train import loss as jax_loss
from pointseg.train import metrics as jax_metrics
from pointseg_torch import cli
from pointseg_torch.train import loss as port_loss
from pointseg_torch.train import metrics as port_metrics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(seed, B=3, N=40, C=14, all_padding=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, N, C)).astype(np.float32) * 3
    y = np.eye(C, dtype=np.uint8)[rng.integers(0, C, (B, N))]
    lengths = np.array([0, 0, 0] if all_padding else [N, N - 13, 7], np.int32)
    y[np.arange(N)[None, :] >= lengths[:, None]] = 0  # padded rows: no class
    return logits, y, lengths


def _both(fn_name, module_j, module_t, *arrays):
    want = getattr(module_j, fn_name)(*(jnp.asarray(a) for a in arrays))
    got = getattr(module_t, fn_name)(*(torch.from_numpy(a) for a in arrays))
    return want, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("all_padding", [False, True])
def test_masked_onehot_cross_entropy_and_gradient_match_jax(all_padding):
    logits, y, lengths = _batch(0, all_padding=all_padding)
    want = jax_loss.masked_onehot_cross_entropy(
        jnp.asarray(logits), jnp.asarray(y), jnp.asarray(lengths))
    want_grad = jax.grad(lambda v: jax_loss.masked_onehot_cross_entropy(
        v, jnp.asarray(y), jnp.asarray(lengths)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = port_loss.masked_onehot_cross_entropy(t, torch.from_numpy(y), torch.from_numpy(lengths))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-8)
    if all_padding:
        assert float(got.detach()) == 0.0


def test_int_label_cross_entropy_and_length_mask_match_jax():
    logits, y, lengths = _batch(1)
    labels = y.argmax(-1).astype(np.int32)
    want, got = _both("masked_cross_entropy_int", jax_loss, port_loss, logits, labels, lengths)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want, got = jax_loss.length_mask(jnp.asarray(lengths), 40), port_loss.length_mask(
        torch.from_numpy(lengths), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", [
    "update_accuracy", "overall_accuracy", "confusion_matrix",
    "update_intersection_over_union", "intersection_over_union",
])
def test_metrics_match_jax(name):
    logits, y, lengths = _batch(2)
    want, got = _both(name, jax_metrics, port_metrics, logits, y, lengths)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5)


def test_iou_from_totals_and_legacy_accuracy_match_jax():
    rng = np.random.default_rng(3)
    inter = rng.integers(0, 50, 14).astype(np.float32)
    union = inter + rng.integers(0, 50, 14).astype(np.float32)
    want, got = _both("iou_from_totals", jax_metrics, port_metrics, inter, union)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    logits, y, _ = _batch(4)
    want, got = _both("accuracy_from_one_hot", jax_metrics, port_metrics, y, logits)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each: 45 train blocks."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


def test_cli_trains_pointnetpp_on_cpu(tiny_blocks, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "pointseg_torch", "train", "PointNet++", "--synthetic",
         "--data-dir", tiny_blocks, "--device", "cpu", "--epochs", "1",
         "--train-batch-size", "8", "--train-sampling", "1024", "--num-workers", "0",
         "--log-dir", str(tmp_path / "logs"),
         "--model-dir", str(tmp_path / "models"), "--log-interval", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Epoch 1 completed" in out.stdout
    (records,) = list((tmp_path / "logs").rglob("records.json"))
    rec = json.loads(records.read_text())
    assert len(rec["train_loss"]) == 1 and math.isfinite(rec["train_loss"][0])
    assert math.isfinite(rec["val_loss"][0]) and 0.0 <= rec["val_acc"][0] <= 1.0
    assert rec["config"]["device"] == "cpu"


@pytest.mark.parametrize("model,extra", [("DeepGraphCnn", []), ("DGCNN", ["--static-graph"])])
def test_cli_trains_dgcnn_on_cpu(tiny_blocks, tmp_path, model, extra, capsys):
    torch.manual_seed(0)
    cli.main(["train", model, "--synthetic", "--data-dir", tiny_blocks, "--device", "cpu",
              "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "256",
              "--test-sampling", "256", "--num-workers", "0",
              "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / "models"),
              "--log-interval", "2", *extra])
    assert "Epoch 1 completed" in capsys.readouterr().out
    (records,) = list((tmp_path / "logs").rglob("records.json"))
    rec = json.loads(records.read_text())
    assert len(rec["train_loss"]) == 1 and math.isfinite(rec["train_loss"][0])
    assert math.isfinite(rec["val_loss"][0]) and 0.0 <= rec["val_acc"][0] <= 1.0
    assert rec["config"]["static_graph"] == bool(extra)


def test_cli_static_graph_is_for_dgcnn_only(tmp_path):
    with pytest.raises(SystemExit, match="DGCNN"):
        cli.main(["train", "PointNet++", "--device", "cpu", "--static-graph",
                  "--log-dir", str(tmp_path)])


def test_cli_device_cuda_without_a_card_raises(tiny_blocks, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", "PointNet++", "--data-dir", tiny_blocks,
                  "--log-dir", str(tmp_path), "--device", "cuda"])
    assert not (tmp_path / "PointNet++").exists()  # refused before any work


def _train_dgcnn(tiny_blocks, tmp_path, *flags):
    """One epoch of DGCNN at 256 points through the CLI's own function;
    returns (state, records)."""
    args = cli.build_parser().parse_args(
        ["train", "DGCNN", "--data-dir", tiny_blocks, "--device", "cpu", "--epochs", "1",
         "--train-batch-size", "8", "--train-sampling", "256", "--test-sampling", "256",
         "--num-workers", "0", "--log-dir", str(tmp_path / "logs"),
         "--model-dir", str(tmp_path / "models"), "--log-interval", "2",
         *flags])
    return cli.train_from_args(args)


@pytest.mark.parametrize("store,said", [
    ("flat", "Device-resident train split (device): 45 blocks"),
    ("compact", "Device-resident train split (compact): 45 blocks"),
    ("auto", "Device-resident train split (device): 45 blocks"),
    ("host", "Device store layout forced to host; using the chunked host prefetcher."),
])
def test_cli_trains_from_the_device_store_on_cpu(tiny_blocks, tmp_path, capsys, store, said):
    state, rec = _train_dgcnn(tiny_blocks, tmp_path, "--device-data", "--device-store", store)
    assert said in capsys.readouterr().out
    assert state.step == 6  # 45 blocks at batch 8, the last batch filled up
    assert math.isfinite(rec["train_loss"][0]) and math.isfinite(rec["val_loss"][0])
    assert rec["config"]["device_data"] is True and rec["config"]["device_store"] == store


def test_cli_pack_cache_hits_on_the_second_run(tiny_blocks, tmp_path, capsys, monkeypatch):
    import pointseg_torch.data.device as dev

    flags = ("--device-data", "--pack-cache", str(tmp_path / "cache"))
    _, first = _train_dgcnn(tiny_blocks, tmp_path, *flags)
    assert "Device-resident train split (compact)" in capsys.readouterr().out
    assert len(list((tmp_path / "cache").glob("*/packed.npy"))) == 1

    def no_raw_load(dataset, num_workers):
        raise AssertionError("a pack-cache hit must not load raw blocks")

    monkeypatch.setattr(dev, "_load_raw_blocks", no_raw_load)
    _, second = _train_dgcnn(tiny_blocks, tmp_path, *flags)
    assert "Device-resident train split (compact)" in capsys.readouterr().out
    # the same store, seed and streams: the same epoch
    np.testing.assert_allclose(second["train_loss"], first["train_loss"], rtol=1e-5)
    monkeypatch.undo()
    _train_dgcnn(tiny_blocks, tmp_path, *flags, "--device-store", "flat")
    assert "note: --pack-cache is ignored with --device-store flat" in capsys.readouterr().out


def test_cli_scan_steps_trains_the_same_epoch(tiny_blocks, tmp_path):
    state_1, one = _train_dgcnn(tiny_blocks, tmp_path, "--device-data")
    state_k, scanned = _train_dgcnn(tiny_blocks, tmp_path, "--device-data", "--scan-steps", "4")
    assert state_1.step == state_k.step == 6
    np.testing.assert_allclose(scanned["train_loss"], one["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(scanned["val_loss"], one["val_loss"], rtol=1e-4)


def test_cli_accum_steps_counts_optimizer_updates(tiny_blocks, tmp_path):
    state, rec = _train_dgcnn(tiny_blocks, tmp_path, "--accum-steps", "4")
    assert state.step == 2  # 6 loader batches: a group of 4 and a trailing group of 2
    assert math.isfinite(rec["train_loss"][0]) and rec["config"]["accum_steps"] == 4
    with pytest.raises(ValueError, match="mutually exclusive"):
        _train_dgcnn(tiny_blocks, tmp_path, "--accum-steps", "2", "--scan-steps", "2")


def test_cli_refuses_accum_steps_with_device_data_before_the_store_is_built(
        tiny_blocks, tmp_path, monkeypatch):
    import pointseg_torch.data.device as dev

    def no_store(*args, **kwargs):
        raise AssertionError("the store must not be built")

    monkeypatch.setattr(dev, "device_store_or_host_loader", no_store)
    with pytest.raises(SystemExit, match="--accum-steps requires a host loader"):
        _train_dgcnn(tiny_blocks, tmp_path, "--device-data", "--accum-steps", "2")
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--data-parallel"], ["--save-confusion"],
])
def test_cli_refuses_flags_not_yet_ported(flags, tiny_blocks, tmp_path, capsys):
    """No trainer flag is refused any more. Each flag that was refused
    until it was ported now trains: `--bf16` a DGCNN epoch in bfloat16 on
    the CPU, a finite loss, float32 parameters, and `"bf16": true` in the
    checkpoint's config sidecar, where `evaluate` reads it;
    `--save-confusion` a DGCNN epoch whose evaluation confusion matrix is
    drawn into `<log dir>/confusion/confusion_epoch_1.png` (matplotlib is
    installed here); `--data-parallel` a DGCNN epoch on the CPU at world
    size 1 (no card: one rank, in this process), which is the epoch without
    the flag, loss for loss."""
    if flags == ["--bf16"]:
        state, rec = _train_dgcnn(tiny_blocks, tmp_path, *flags)
        assert state.step == 6 and math.isfinite(rec["train_loss"][0])
        assert state.model.conv1.dtype == state.model.conv5.dtype == torch.bfloat16
        assert {p.dtype for p in state.model.parameters()} == {torch.float32}
        (sidecar,) = list((tmp_path / "models").rglob("config.json"))
        assert json.loads(sidecar.read_text())["bf16"] is True
        return
    if flags == ["--save-confusion"]:
        state, rec = _train_dgcnn(tiny_blocks, tmp_path, *flags)
        assert state.step == 6 and rec["config"]["save_confusion"] is True
        (png,) = list((tmp_path / "logs").rglob("confusion_epoch_*.png"))
        assert png.name == "confusion_epoch_1.png" and png.parent.name == "confusion"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        return
    assert flags == ["--data-parallel"]
    state, rec = _train_dgcnn(tiny_blocks, tmp_path, *flags)
    assert "Data-parallel over 1 device(s)." in capsys.readouterr().out
    assert state.step == 6 and rec["config"]["world_size"] == 1
    assert state.mesh.world_size == 1 and state.mesh.backend is None
    _, plain = _train_dgcnn(tiny_blocks, tmp_path / "plain")
    assert rec["train_loss"] == plain["train_loss"] and rec["val_loss"] == plain["val_loss"]


def test_cli_refuses_models_not_yet_ported(tmp_path):
    """Every model of the JAX registry is ported; a name outside it is
    refused, by the parser and by `create_model`, as the JAX package
    refuses it."""
    from pointseg_torch.models import MODELS, create_model

    assert sorted(MODELS) == sorted(cli.MODEL_CHOICES)
    with pytest.raises(ValueError, match="Unknown model 'PointNet3'"):
        create_model("PointNet3")
    with pytest.raises(SystemExit):
        cli.main(["train", "PointNet3", "--device", "cpu", "--log-dir", str(tmp_path)])
