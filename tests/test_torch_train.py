"""pointseg_torch.train and the port's CLI on the CPU.

Loss and metrics go through pointseg.train and the port on the same
numpy inputs (tolerance rtol 1e-5: the same float32 formulas summed in
another order; counts exactly). The CLI trains PointNet++ end to end on
a tiny synthetic dataset with `--device cpu`, and DGCNN likewise.
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
         "--log-dir", str(tmp_path / "logs"), "--log-interval", "2"],
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
              "--log-dir", str(tmp_path / "logs"), "--log-interval", "2", *extra])
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


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--device-data"], ["--scan-steps", "4"], ["--accum-steps", "2"],
    ["--resume", "ckpt"], ["--data-parallel"], ["--warmup-steps", "10"],
    ["--lr-schedule", "cosine"], ["--grad-clip", "1.0"], ["--profile", "trace"],
])
def test_cli_refuses_flags_not_yet_ported(flags, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(["train", "PointNet++", "--device", "cpu",
                  "--log-dir", str(tmp_path), *flags])


def test_cli_refuses_models_not_yet_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["train", "PointNet", "--device", "cpu", "--log-dir", str(tmp_path)])
