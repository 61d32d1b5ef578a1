"""A run with its timed path broken underneath sees `correct` come out
false, once for each fault a training cell on one card can have, and for
the program's bfloat16 path (the CPU has no TF32: the card's test takes
that control); a sound run sees it true."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import run
from portbench.tests import faults
from portbench.tests.conftest import tiny_over


def _result(cell, over, plant=None):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = run.main(["--workload", cell, "--seed", "3000000011", "--seconds", "1",
                         "--trace", "0", "--dry-run", json.dumps(over)], plant=plant)
    faults.unplant()
    assert code == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


# DGCNN compares no widest logit gap (kNN near-ties swing it by up to 9% in sound
# runs), so one altered logit stays inside its limits; an altered row does not
CASES = [(cell, fault) for cell in ("pointnet2_ssg.b128-store", "dgcnn_k20.b32-store")
         for fault in (None, "unchanged", "half", "alter_logit", "alter_row", "bf16")
         if not (cell.startswith("dgcnn") and fault == "alter_logit")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails(cell, fault, tiny):
    if cell.startswith("dgcnn"):
        tiny["traffic"]["points"] = 256
    plant = faults.FAULTS.get(fault)
    if fault == "bf16":
        tiny["traffic"]["dtype"] = "bfloat16"
    result = _result(cell, tiny_over(cell, tiny), plant)
    assert result["correct"] is (fault is None), result["checks"]
