"""Finding a cell's parts by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix; the harness reads them from files of their
own, so that a cell, a configuration, a traffic mix or a per-layer metric
is added by adding files:

- `portbench/configs/<config>.json`: the model (its `create_model` name
  and keyword arguments), the reference's architecture, dtype, TF32,
  learning rate, `reduced` and `assumed`;
- `portbench/traffic/<traffic>.json`: the loop (`portbench/loops/<loop>.py`),
  batch, points, feed (`loader` or `store`), workers, `scan_steps`,
  `accum_steps`, ranks, dtype, the data set (`portbench/data/<dataset>.json`)
  and the warm-up and traced steps;
- `portbench/metrics/<metric>.py`: a per-layer metric's reader,
  `read(readings) -> float | None`;
- `portbench/limits/<cell>.json`: the numbers that decide the cell's
  `correct` and their limits (`portbench/check.py`).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    def __init__(self, spec: dict, name: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload '{name}' in BENCHMARK.json; there are {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _read(REPO / self.config_entry["file"])
        self.traffic = _read(ROOT / "traffic" / f"{self.entry['traffic']}.json")
        self.data = _read(ROOT / "data" / f"{self.traffic['dataset']}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        limits = ROOT / "limits" / f"{name}.json"
        self.limits = _read(limits) if limits.exists() else {}

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The module of per-layer metric `name` (`portbench/metrics/<name>.py`)."""
    return load_module(ROOT / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def loop_module(name: str):
    return load_module(ROOT / "loops" / f"{name}.py", f"portbench_loop_{name}")
