"""The port's CLI trains the PointNeXt family and PointNet++ MSG end to
end on the CPU (plain PyTorch versions) on a tiny synthetic dataset: one
epoch and its evaluation, finite losses, the records written.
"""

import json
import math

import pytest
import torch

from pointseg_torch import cli
from pointseg_torch.data import synthetic

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


@pytest.mark.parametrize("model", ["PointNeXt", "PointNeXt-B", "PointNeXt-L", "PointNet++MSG"])
def test_cli_trains_on_cpu(tiny_blocks, tmp_path, model, capsys):
    torch.manual_seed(0)
    cli.main(["train", model, "--synthetic", "--data-dir", tiny_blocks, "--device", "cpu",
              "--epochs", "1", "--train-batch-size", "16", "--train-sampling", "1024",
              "--test-sampling", "1024", "--test-batch-size", "4", "--num-workers", "0",
              "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / "models"),
              "--log-interval", "1"])
    assert "Epoch 1 completed" in capsys.readouterr().out
    (records,) = list((tmp_path / "logs").rglob("records.json"))
    rec = json.loads(records.read_text())
    assert len(rec["train_loss"]) == 1 and math.isfinite(rec["train_loss"][0])
    assert math.isfinite(rec["val_loss"][0]) and 0.0 <= rec["val_acc"][0] <= 1.0
    assert rec["config"]["model"] == model
