"""`pointseg_torch/multichip.py` on the CPU: the counterparts of
`__graft_entry__.py::dryrun_multichip` (`tests/test_parallel.py::
test_graft_entry_dryrun`) and `entry`.

The dry run runs in a fresh subprocess, as the JAX package's test runs
its own: four gloo ranks (`parallel.spawn`), dp 2 x tp 2, every placement
of `pointseg_torch/parallel/` once; the test holds its summary line to the
JAX package's wording and its sharded fractions to the JAX package's.
"""

import os
import re
import subprocess
import sys

import numpy as np
import torch

from pointseg_torch.multichip import entry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's fractions on a mesh with a model axis of 2, as its dry
# run rounds and prints them (`tests/test_torch_mesh.py` holds every
# model's unrounded fraction to the JAX package's)
JAX_FRACTIONS = {"PointNet++": "98.7%", "PointNet": "99.9%", "PointNeXt": "99.6%",
                 "DeepGraphCnn": "96.1%"}


def test_dryrun_multichip_on_four_cpu_ranks():
    out = subprocess.run(
        [sys.executable, "-c", "from pointseg_torch.multichip import dryrun_multichip; "
                               "dryrun_multichip(4, device='cpu', timeout=240)"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="4"))
    assert out.returncode == 0, f"stdout: {out.stdout[-2000:]}\nstderr: {out.stderr[-2000:]}"
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): dp=2 x tp=2 train steps ok (")
    losses = dict(re.findall(r"([\w+]+) loss=([0-9.]+)", line))
    assert set(losses) == set(JAX_FRACTIONS)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert ("point-sharded eval ok, window-sharded streaming room eval ok, sharded "
            "compact-store sampling -> train step ok; TP-sharded param fraction: ") in line
    assert dict(re.findall(r"(\S+)=([0-9.]+%)", line)) == JAX_FRACTIONS


def test_entry_gives_the_flagship_forward():
    forward, (points,) = entry(device="cpu")
    assert tuple(points.shape) == (4, 4096, 9)
    logits = forward(points)
    assert tuple(logits.shape) == (4, 4096, 14) and torch.isfinite(logits).all()
    assert not logits.requires_grad
