"""`train --data-parallel` of pointseg_torch through its command line on
the CPU (gloo): under `torchrun` and standalone with a rank a card (two
CPU ranks standing in for two cards), the refusal of a batch that the
world size does not divide, rank 0's logger, the mesh descriptor and the
backend rule, and one kernel build among concurrent builders. The step
itself is held against one process and the JAX package in
`tests/test_torch_parallel.py`."""

import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pointseg_torch import cli, parallel
from pointseg_torch.data import synthetic
from pointseg_torch.ops import _kernels
from pointseg_torch.parallel import Mesh
from pointseg_torch.train.logging import MetricsLogger, NullLogger, rank_logger

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def test_mesh_rows_backend_rule_and_a_mesh_of_one(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    mesh = parallel.create_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, None)
    assert Mesh(rank=1, world_size=2).rows(8) == slice(4, 8)
    with pytest.raises(ValueError):
        Mesh(rank=0, world_size=2).rows(5)
    x = np.arange(8)
    assert parallel.shard_batch(Mesh(rank=1, world_size=4), (x, x * 2))[1].tolist() == [4, 6]
    assert parallel.backend_for("cpu", 2, 0) == "gloo"
    assert parallel.backend_for("cuda", 2, 2) == "nccl"
    assert parallel.backend_for("cuda", 2, 1) == "gloo"  # NCCL refuses two ranks on a card
    with parallel.use(Mesh()):
        assert parallel.active() is None  # a mesh of one rank runs the one-process code
    with parallel.use(Mesh(rank=0, world_size=2)):
        assert parallel.active().world_size == 2
    assert parallel.active() is None


def test_batch_not_divisible_by_the_world_is_refused(tmp_path):
    args = cli.build_parser().parse_args(
        ["train", "DGCNN", "--device", "cpu", "--data-parallel", "--train-batch-size", "5",
         "--log-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--data-parallel needs train batch size "
                                         "divisible by 2 devices, got 5"):
        cli.spawn_training(args, 2)
    assert not list(tmp_path.iterdir())


def test_only_rank_zero_logs(tmp_path):
    assert isinstance(rank_logger(str(tmp_path / "r1"), 1), NullLogger)
    assert not (tmp_path / "r1").exists()
    logger = rank_logger(str(tmp_path / "r0"), 0, use_tensorboard=False)
    assert isinstance(logger, MetricsLogger)
    logger.add_scalar("Train/Loss", 1.0, 0)
    logger.close()
    assert (tmp_path / "r0" / "metrics.jsonl").read_text().count("Train/Loss") == 1


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each: 45 train blocks."""
    return synthetic.make_block_dataset(str(tmp_path_factory.mktemp("dp_blocks")),
                                        rooms_per_area=1, points_per_room=1500, seed=0,
                                        rgb_u8=True)


def _one_dir_each(tmp_path):
    (log_dir,) = [p for p in (tmp_path / "logs").glob("*/*") if p.is_dir()]
    (ckpt_dir,) = [p for p in (tmp_path / "models").glob("*/*") if p.is_dir()]
    return log_dir, ckpt_dir


def test_cli_under_torchrun_trains_on_two_ranks(tiny_blocks, tmp_path):
    """`torchrun --standalone` (a free port, not a fixed one) with two
    ranks of `train PointNet++ --device cpu --data-parallel`: one epoch,
    exit 0, rank 0 alone prints, and exactly one log directory and one
    checkpoint directory result."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "pointseg_torch", "train", "PointNet++", "--device", "cpu",
         "--data-parallel", "--synthetic", "--data-dir", tiny_blocks, "--epochs", "1",
         "--train-batch-size", "8", "--train-sampling", "1024", "--test-sampling", "1024",
         "--num-workers", "0", "--log-dir", str(tmp_path / "logs"),
         "--model-dir", str(tmp_path / "models"), "--log-interval", "1"],
        capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Data-parallel over 2 device(s).") == 1
    assert out.stdout.count("Epoch 1 completed") == 1
    log_dir, ckpt_dir = _one_dir_each(tmp_path)
    rec = json.loads((log_dir / "records.json").read_text())
    assert math.isfinite(rec["train_loss"][0]) and rec["config"]["world_size"] == 2
    assert [p.name for p in ckpt_dir.glob("checkpoint_*.pt")] == ["checkpoint_6.pt"]


def test_cli_standalone_starts_one_rank_a_card(tiny_blocks, tmp_path, capsys):
    """Standalone with more than one card, `train --data-parallel` starts a
    rank a card (`spawn_training`); here two CPU ranks stand in for two
    cards. Each rank's records and launches come back (CPU tensors launch
    no kernel); one log and one checkpoint directory."""
    args = cli.build_parser().parse_args(
        ["train", "DGCNN", "--device", "cpu", "--data-parallel", "--data-dir",
         tiny_blocks, "--epochs", "1", "--train-batch-size", "8", "--train-sampling",
         "256", "--test-sampling", "256", "--num-workers", "0",
         "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / "models")])
    out = cli.spawn_training(args, 2)
    assert [set(r["launches"].values()) for r in out] == [{0}, {0}]
    rec = out[0]["records"]
    assert rec["config"]["world_size"] == 2 and math.isfinite(rec["train_loss"][0])
    log_dir, ckpt_dir = _one_dir_each(tmp_path)
    assert [p.name for p in ckpt_dir.glob("checkpoint_*.pt")] == ["checkpoint_6.pt"]


def test_a_rank_that_fails_fails_the_run():
    """No fall-back: a rank that raises makes `spawn` raise (the first error
    reported may be rank 0's, whose collective lost its peer), and the
    rank left waiting is stopped."""
    import torch.multiprocessing as mp

    import torch_parallel_ranks as ranks

    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails|by peer"):
        parallel.spawn(ranks.fail_on_rank_one, 2, timeout=120, threads=1)


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Ranks that build the kernels at once take turns on the lock file:
    one compiles every source and links, the others load its library (a
    stand-in nvcc counts the calls)."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "sleep 0.5\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; "
                    "shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path / "build")
    built = []
    threads = [threading.Thread(target=lambda: built.append(_kernels.build()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(built) == 3 and len(set(built)) == 1 and built[0].exists()
    calls = log.read_text().splitlines()
    assert len(calls) == len(_kernels.SOURCES) + 1  # each source once, one link
