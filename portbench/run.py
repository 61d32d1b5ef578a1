"""Runs one cell of the benchmark and prints its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics. Every run checks the program's
first steps against the plain reference (`portbench/check.py`) and prints
each compared number beside its limit, as the last lines of standard
error and under `checks`, the last key of the result. The run needs as
many CUDA devices as the cell's `chips` and exits with code 2 without
them; it exits with code 3 if JAX or the JAX package was loaded.
`--dry-run '<json>'` (tests only) overrides the cell's traffic and data
({"traffic": {...}, "data": {...}}), the limits of some compared numbers
({"limits": {number: limit}}, for sizes the cell's limits were not set at),
and runs on {"device": "cpu"} (the default there) or "cuda".
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")


START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# run as a script, this folder comes first on the path, where `tracefile`, `data` and the
# rest would shadow installed modules of the same name: the checkout's root goes there
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)
elif str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointseg")


def _log(msg: str) -> None:
    print(msg, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v: float):
    return v if math.isfinite(v) else str(v)


def main(argv=None, plant=None) -> int:
    """Runs a cell; returns the exit code. `plant(run)`, for the fault
    tests, is called once the program is set up."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry-run", default=None, help=argparse.SUPPRESS)  # tests: sizes, device
    args = p.parse_args(argv)

    import torch

    from portbench import check, harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    traffic, data = dict(cell.traffic), dict(cell.data)
    over = json.loads(args.dry_run) if args.dry_run is not None else {}
    traffic.update(over.get("traffic", {}))
    data.update(over.get("data", {}))
    for name, limit in over.get("limits", {}).items():
        cell.limits["numbers"][name]["limit"] = limit
    if over.get("device", "cuda" if args.dry_run is None else "cpu") == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        _log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    else:
        device = torch.device("cpu")

    loop = harness.loop_module(traffic["loop"])
    run = loop.TrainRun(cell.config, traffic, data, args.seed, device, _log)
    run.setup()
    if plant is not None:
        plant(run)
    t = time.perf_counter()
    run.first_steps()
    setup_s = time.time() - START
    _log(f"setup: first and warm-up steps {time.perf_counter() - t:.3f} s; setup_s {setup_s:.3f}")
    window = run.window(args.seconds)
    _log(f"window: {window['steps']} steps, {window['points']} points in "
         f"{window['seconds']:.3f} s")
    profile = run.profiled() if args.trace else None
    cuda = device.type == "cuda"
    peak = max(run.setup_peak, window["peak_bytes"]) if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1, "memory_peak_bytes": peak}

    if profile is None:
        values = loop.end_to_end(window, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        win = profile["window"]
        dev["busy_s"], dev["window_s"] = win.busy_s(), win.window_s
        _log(f"trace: {profile['steps']} steps, {profile['launches']} kernel launches of the "
             f"port ({profile['launches'] / profile['steps']:.1f} a step), "
             f"{profile['op_calls']} op calls")
        readings = {"window": window, "profile": profile, "cuda": cuda, "cell": cell,
                    "traffic": traffic}
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    run.free_program()
    t = time.perf_counter()
    values = run.compare(check.BlockIndex(run.data_dir, run.manifest))
    _log(f"check: reference steps and data rows, {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(values, cell.limits)
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": window["steps"], "failed": 0,
              "metrics": metrics, "device": dev}
    if profile is not None:
        result["breakdown"] = {"device_ops": win.device_ops(),
                               "idle_gaps": profile["host_window"].idle_gaps()}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    _log("readings: " + json.dumps({k: _finite(v) for k, v in values.items()}))
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
