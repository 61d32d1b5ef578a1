"""A new architecture, its configuration, traffic, data set, limits and
cell, a traced op and that op's metric, added to a copy of the benchmark
by new files and new `BENCHMARK.json` entries alone: the copy runs the new
cell to a correct result, its own spec and work tests pass, and no file
that was there before differs."""

import hashlib
import json
import shutil
import subprocess
import sys

from portbench.tests.conftest import REPO

CELL = "dgcnn_xyz.b2-toy"

# DGCNN without colour (the program's `DGCNN`) at k 10 and a 256-wide embedding
ARCH = '''"""DGCNN without colour: four EdgeConvs, the embedding and the head."""

import torch
import torch.nn.functional as F

from portbench.reference.archs.dgcnn import EDGE_CONVS, _edge_conv, _lrelu
from portbench.reference.models import _mlp, _mlp_specs

CAT = sum(fout for _, fout in EDGE_CONVS)


def specs(k=20, emb_dims=1024, num_classes=14):
    out = []
    for i, (fin, fout) in enumerate(EDGE_CONVS, start=1):
        out += [(f"conv{i}.w_edge.weight", (fout, fin), 2 * fin),
                (f"conv{i}.w_center.weight", (fout, fin), 2 * fin),
                (f"conv{i}.bn.weight", (fout,), "ones"), (f"conv{i}.bn.bias", (fout,), "zeros")]
    out += _mlp_specs("conv5", CAT, (emb_dims,), bias=False)
    out += _mlp_specs("conv6", CAT + emb_dims, (512,), bias=False)
    out += _mlp_specs("conv7", 512, (256,), bias=False)
    return out + [("conv8.weight", (num_classes, 256), 256), ("conv8.bias", (num_classes,), 256)]


def forward(p, x, fps_gen=None, k=20, dropout=True):
    xs = [x[..., :3]]
    for i in range(1, 5):
        xs.append(_edge_conv(p, i, xs[-1], k))
    cat = torch.cat(xs[1:], dim=-1)
    x5 = _mlp(p, "conv5", cat, 1, _lrelu, bias=False)
    h = _mlp(p, "conv6", torch.cat([cat, x5], dim=-1), 1, _lrelu, bias=False)
    h = F.dropout(h, 0.5, training=True) if dropout else h
    h = _mlp(p, "conv7", h, 1, _lrelu, bias=False)
    h = F.dropout(h, 0.5, training=True) if dropout else h
    return F.linear(h, p["conv8.weight"], p["conv8.bias"])


def forward_flops(B, N, k=20, emb_dims=1024, num_classes=14):
    rows = B * N
    edge = sum(2.0 * rows * fin * fout * 2 for fin, fout in EDGE_CONVS)
    return edge + 2.0 * rows * (CAT * emb_dims + (CAT + emb_dims) * 512 + 512 * 256
                                + 256 * num_classes)
'''

CONFIG = {"name": "dgcnn_xyz", "source": "https://arxiv.org/abs/1801.07829", "model": "DGCNN",
          "model_kwargs": {"k": 10, "emb_dims": 256}, "arch": "dgcnn_xyz",
          "arch_kwargs": {"k": 10, "emb_dims": 256, "num_classes": 14},
          "arch_forward_kwargs": {"k": 10}, "num_classes": 14, "in_dim": 9,
          "dtype": "float32", "tf32": False, "learning_rate": 0.001, "reduced": [],
          "assumed": {}}
TRAFFIC = {"loop": "train", "dataset": "toy_rooms", "batch": 2, "points": 256, "feed": "store",
           "store_layout": "compact", "workers": 2, "scan_steps": 1, "accum_steps": 1,
           "ranks": 1, "dtype": "float32", "warmup_steps": 4, "trace_steps": 2}
DATA = {"areas": [1, 2], "blocks_per_area": 6, "points_per_block": 1500,
        "room_blocks_x": [3, 8], "room_blocks_y": [3, 7], "height_m": [2.6, 3.2],
        "furniture_per_room": [4, 12], "noise_m": 0.002, "generator_seed": 0}
# ten times or more the largest that sound CPU runs of the toy cell read over eight seeds
# (loss1 1.7e-7, loss2 5.0e-4, loss3 6.1e-4, grad 1.1e-3, update 6.5e-3)
LIMITS = {"numbers": {"data_rows_off": {"limit": 0.0}, "loss1_gap": {"limit": 1e-5},
                      "loss2_gap": {"limit": 5e-3}, "loss3_gap": {"limit": 1e-2},
                      "grad_gap": {"limit": 0.02}, "update_gap": {"limit": 0.1}}}
OP = '''"""kNN with the edge features: x (B, N, F), k -> (B, N, k, 2F)."""

from portbench.work import nbytes


def work(args):
    (xs, xsz), k = args[0], args[1]
    B, N, F = xs
    return 2.0 * B * N * N * F, nbytes(xs, xsz) + 2 * B * N * k * F * xsz
'''
METRIC = '''from portbench import opmetrics


def read(r):
    return opmetrics.device_ms(r, "graph_feature")
'''


def _digests(root):
    files = [root / "BENCHMARK.json", *(root / "portbench").rglob("*")]
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_a_cell_added_by_files_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "pointseg_torch").symlink_to(REPO / "pointseg_torch")  # the program
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    new = {"reference/archs/dgcnn_xyz.py": ARCH, "configs/dgcnn_xyz.json": json.dumps(CONFIG),
           "traffic/b2-toy.json": json.dumps(TRAFFIC), "data/toy_rooms.json": json.dumps(DATA),
           f"limits/{CELL}.json": json.dumps(LIMITS), "opwork/graph_feature.py": OP,
           "metrics/ops.graph_feature_ms.py": METRIC}
    for rel, text in new.items():
        assert not (pb / rel).exists(), rel
        (pb / rel).write_text(text)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    entries = {
        "configs": {"name": "dgcnn_xyz", "source": CONFIG["source"],
                    "file": "portbench/configs/dgcnn_xyz.json", "reduced": [],
                    "why": "DGCNN without colour at k 10: a toy architecture added by files"},
        "workloads": {"name": CELL, "config": "dgcnn_xyz", "traffic": "b2-toy", "chips": 1,
                      "why": "B 2 x 256 from the compact store: the test's toy cell"},
        "per_layer": {"name": "ops.graph_feature_ms", "unit": "ms", "better": "lower",
                      "source": "device_trace", "layer": "ops and kernels",
                      "moves": "train_points_per_s", "workloads": [CELL]}}
    for key, entry in entries.items():
        spec[key].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                        "3000000013", "--seconds", "1", "--trace", "1", "--dry-run", "{}"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(LIMITS["numbers"])
    assert "setup: model DGCNN (float32)" in p.stdout
    # the copy finds the new op and counts the new architecture's FLOPs
    code = ("from portbench import harness, work\n"
            "assert 'graph_feature' in harness.traced_ops()\n"
            "print(work.step_matmul_flops('dgcnn_xyz', 2, 256, k=10, emb_dims=256,"
            " num_classes=14))")
    c = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert c.returncode == 0, c.stderr[-3000:]
    edge = 2 * 512 * 2 * (3 * 64 + 64 * 64 + 64 * 64 + 64 * 128)
    rest = 2 * 512 * (320 * 256 + 576 * 512 + 512 * 256 + 256 * 14)
    assert float(c.stdout) == 3 * (edge + rest)
    t = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "portbench/tests/test_pb_spec.py", "portbench/tests/test_pb_work.py"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert t.returncode == 0, t.stdout[-3000:]

    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and v != before[k]} == \
        {"BENCHMARK.json": after["BENCHMARK.json"]}
    assert set(after) - set(before) == {f"portbench/{rel}" for rel in new}
    # BENCHMARK.json differs by the new entries alone
    for key, entry in entries.items():
        spec[key].remove(entry)
    assert spec == json.loads((REPO / "BENCHMARK.json").read_text())
