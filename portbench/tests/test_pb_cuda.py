"""On the card: a sound run at a test's size is correct, and the TF32
control (the nearest precision below float32 with TF32 off) is not."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import run
from portbench.tests.conftest import tiny_over

SMALL = {"device": "cuda",
         "traffic": {"batch": 4, "points": 4096, "warmup_steps": 4, "trace_steps": 2},
         "data": {"areas": [1], "blocks_per_area": 24}}


def _result(cell, over, trace=0):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = run.main(["--workload", cell, "--seed", "4000000021", "--seconds", "2",
                         "--trace", str(trace), "--dry-run", json.dumps(over)])
    assert code == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dgcnn_k20.b32-store", "pointnet2_ssg.b128-store"])
@pytest.mark.parametrize("tf32", [False, True])
def test_tf32_control_fails(cell, tf32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    over = tiny_over(cell, json.loads(json.dumps(SMALL)))
    over["traffic"]["tf32"] = tf32
    result = _result(cell, over, trace=int(not tf32))
    assert result["correct"] is (not tf32), result["checks"]
    if not tf32:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["ops_roofline"]["value"] <= 100
