"""A run end to end on the CPU at tiny sizes: the result line's keys."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, cells, tiny_over

CELLS = cells()


def _run(cwd, cell, trace, over=None):
    over = tiny_over(cell) if over is None else over
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000007",
         "--seconds", "1", "--trace", str(trace), "--dry-run", json.dumps(over)],
        cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("cell,trace,feed", [(c, t, None) for c in CELLS for t in (0, 1)]
                         + [(CELLS[0], 0, "loader")])
def test_last_line(cell, trace, feed):
    """Each cell at its tiny sizes, untraced and traced; the last case feeds
    the first cell from the host `Loader` (the traffic key `feed`), which
    no cell uses today."""
    over = tiny_over(cell)
    if feed is not None:
        over["traffic"]["feed"] = feed
    p = _run(REPO, cell, trace, over)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(keys) - {"breakdown"} == {
        "correct", "attempted", "failed", "metrics", "device", "checks"}
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "loop.host_ms" in result["metrics"]
    else:
        cell_e2e = harness.Cell(harness.load_benchmark(), cell).end_to_end
        assert set(result["metrics"]) == {m["name"] for m in cell_e2e}
        assert {"train_points_per_s", "peak_mib", "setup_s"} <= set(result["metrics"])
    # the compared numbers, last on standard error too
    tail = p.stderr.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    assert any(line.startswith("setup: data cache") for line in p.stdout.splitlines())


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_alone_it_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run(tmp_path, CELLS[0], 0)
    assert p.returncode != 0
    assert not p.stdout.strip().endswith("}")
