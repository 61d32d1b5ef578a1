"""A run with its timed path broken underneath sees `correct` come out
false, once for each fault a training cell on one card can have, and for
the program's bfloat16 path (the CPU has no TF32: the card's test takes
that control); a sound run sees it true."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import harness, run
from portbench.tests import faults
from portbench.tests.conftest import cells, tiny_over


def _result(cell, over, plant=None):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = run.main(["--workload", cell, "--seed", "3000000011", "--seconds", "1",
                         "--trace", "0", "--dry-run", json.dumps(over)], plant=plant)
    faults.unplant()
    assert code == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


# the compared number that alone catches a fault; the others are caught by numbers that
# every cell compares (losses, rows, gradients)
CAUGHT_BY = {"alter_logit": "logit_gap"}


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "alter_logit", "alter_row",
                                   "bf16"])
@pytest.mark.parametrize("cell", cells())
def test_fault_fails(cell, fault):
    needs = CAUGHT_BY.get(fault)
    if needs is not None and needs not in harness.Cell(harness.load_benchmark(), cell).limits[
            "numbers"]:
        # DGCNN's limits compare no widest logit gap (kNN near-ties swing it by up to 9%
        # in sound runs), so one altered logit stays inside them; an altered row does not
        pytest.skip(f"portbench/limits/{cell}.json compares no {needs}")
    over = tiny_over(cell)
    if fault == "bf16":
        over["traffic"]["dtype"] = "bfloat16"
    result = _result(cell, over, faults.FAULTS.get(fault))
    assert result["correct"] is (fault is None), result["checks"]
