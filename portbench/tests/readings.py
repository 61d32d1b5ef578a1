"""Readings that set a cell's limits: the compared numbers of sound runs of
the program over many seeds, of its lower-precision controls, and of the
planted faults, all at the cell's own sizes, in one process.

    python3 portbench/tests/readings.py --workload <cell> --seeds 12 --first 4100000000 \
        [--controls tf32,bf16] [--faults half,alter_logit,alter_row,unchanged] [--per 3]

Training's numbers come from the first three steps, so no window is run.
Prints one JSON line a reading and, last, each number's largest sound
reading and smallest reading of each control and fault.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.tests import faults  # noqa: E402


def reading(cell, traffic, seed, device, program_dtype=None, tf32=None, fault=None):
    loop = harness.loop_module(traffic["loop"])
    run = loop.TrainRun(cell.config, dict(traffic, warmup_steps=0), cell.data, seed, device,
                        lambda msg: None, program_dtype=program_dtype, tf32=tf32)
    run.setup()
    if fault is not None:
        faults.FAULTS[fault](run)
    try:
        run.first_steps()
    finally:
        faults.unplant()
    run.free_program()
    values = run.compare(check.BlockIndex(run.data_dir, run.manifest))
    prog, ref = run.compared
    grads = check.leaf_gaps(prog["grads"], ref["grads"])
    ups = check.leaf_gaps(*check.deltas(prog, ref, run.weights), check.moved_leaves(ref))
    look = {}
    for name, gaps in (("grad", grads), ("update", ups)):
        if gaps:
            top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            look[f"{name}_worst"] = [[n, v, int(ref["grads"][n].numel())] for n, v in top]
            look[f"{name}_median_leaf"] = float(sorted(gaps.values())[len(gaps) // 2])
    print(json.dumps({"look": look}, default=str), flush=True)
    return values


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=4100000000)
    p.add_argument("--controls", default="tf32")
    p.add_argument("--faults", default="")
    p.add_argument("--per", type=int, default=3, help="seeds a control or fault")
    args = p.parse_args()
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    kinds = [("sound", {})]
    kinds += [(c, {"tf32": True} if c == "tf32" else {"program_dtype": "bfloat16"})
              for c in filter(None, args.controls.split(","))]
    kinds += [(f, {"fault": f}) for f in filter(None, args.faults.split(","))]
    table: dict = {}
    for kind, kw in kinds:
        n = args.seeds if kind == "sound" else args.per
        for i in range(n):
            seed = args.first + i
            values = reading(cell, cell.traffic, seed, device, **kw)
            print(json.dumps({"kind": kind, "seed": seed, **{k: v if math.isfinite(v) else str(v)
                                                              for k, v in values.items()}}),
                  flush=True)
            for k, v in values.items():
                table.setdefault(kind, {}).setdefault(k, []).append(v)
    summary = {}
    for k in table["sound"]:
        row = {"sound_max": max(table["sound"][k])}
        for kind in table:
            if kind != "sound":
                row[f"{kind}_min"] = min(table[kind][k])
        summary[k] = {a: (b if math.isfinite(b) else str(b)) for a, b in row.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
