"""The benchmark's own tests (not collected by the repository's `tests/`).

    python -m pytest portbench/tests -q            # on the CPU
    python -m pytest portbench/tests -q -m cuda    # on the card

A test that needs the card is marked `cuda` and decides inside the test
whether there is one."""

import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

# tiny sizes for runs on the CPU: PointNet++'s SA1 takes 1,024 centroids, so no fewer points
TINY = {"traffic": {"batch": 2, "points": 1024, "workers": 2, "warmup_steps": 4,
                    "trace_steps": 2},
        "data": {"areas": [1, 2], "blocks_per_area": 6, "points_per_block": 1500}}


def cells() -> list[str]:
    """The cells of `BENCHMARK.json`, in its order."""
    return [w["name"] for w in harness.load_benchmark()["workloads"]]


def _tiny_file(cell: str) -> dict:
    """`portbench/tests/tiny/<cell>.json` where the cell has one: its own CPU
    sizes ("traffic", "data") and its limits at a test's sizes ("limits",
    with a "why"), which the cell's limits, set at its own sizes, need."""
    path = Path(__file__).resolve().parent / "tiny" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def tiny_over(cell: str, over: dict | None = None) -> dict:
    """A `--dry-run` override of `cell`: `over`, by default the CPU's tiny
    sizes with the cell's own, and the cell's limits at a test's sizes."""
    extra = _tiny_file(cell)
    if over is None:
        over = {k: {**v, **extra.get(k, {})} for k, v in TINY.items()}
    return {**copy.deepcopy(over), "limits": extra.get("limits", {})}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")
