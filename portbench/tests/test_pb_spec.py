"""BENCHMARK.json in the shape the benchmark's format sets, and every part it names
found by name."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_benchmark()


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"train_points_per_s", "step_ms_p95", "peak_mib", "setup_s"} <= e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_found_by_name(cell):
    c = harness.Cell(SPEC, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["loop"] and harness.loop_module(c.traffic["loop"]).TrainRun
    assert c.data["points_per_block"] > 0
    assert c.limits["numbers"], "a cell compares at least one number"
    assert c.per_layer and len(c.end_to_end) >= 2
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert any(m["name"] in [p["name"] for p in harness.Cell(SPEC, w["name"]).per_layer]
                   for w in SPEC["workloads"])
