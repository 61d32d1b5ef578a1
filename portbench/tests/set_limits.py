"""Sets a cell's limits from the readings of `readings.py` (its JSON lines).

    python3 portbench/tests/set_limits.py <readings.log> [<readings.log> ...]

For each number: the lower reading is the largest of the sound runs; the
upper reading the smallest of the TF32 control's readings where that is
three times the lower or more, of each fault's where ten times or more,
and of the unchanged state's where three times or more. The limit lies
between the two, three fifths of the way up on a log scale, rounded down
to two significant digits; a number read exactly (its lower reading 0
and a fault reading above it) has the limit 0. A number with no upper
reading is not compared. Prints, per cell, the readings and the limits.
"""

from __future__ import annotations

import json
import math
import sys
from collections import defaultdict

CONTROL = "tf32"
FAULTS = {"half": 10.0, "alter_logit": 10.0, "alter_row": 10.0, "unchanged": 3.0}


def _num(v):
    return float(v) if not isinstance(v, str) else float(v.replace("Infinity", "inf"))


def limits_of(rows: list[dict]) -> dict:
    by = defaultdict(lambda: defaultdict(list))
    for r in rows:
        for k, v in r.items():
            if k not in ("kind", "seed"):
                by[k][r["kind"]].append(_num(v))
    out, skipped = {}, {}
    for name, kinds in by.items():
        lower = max(kinds["sound"])
        candidates = []  # a reading that is no number (a crash, a shape gone) sets no upper end
        for kind, factor in ((CONTROL, 3.0), *FAULTS.items()):
            least = min(kinds.get(kind, [math.inf]))
            if math.isfinite(least) and least > 0 and least >= factor * lower:
                candidates.append((least, kind))
        info = {"lower": lower, "sound_seeds": len(kinds["sound"]),
                **{f"{k}_min": min(v) for k, v in kinds.items() if k != "sound"}}
        if not candidates:
            skipped[name] = info
            continue
        upper, source = min(candidates)
        if lower == 0:
            limit = 0
        else:
            raw = math.exp(0.4 * math.log(lower) + 0.6 * math.log(min(upper, 1e6)))
            digit = 10 ** (math.floor(math.log10(raw)) - 1)
            limit = math.floor(raw / digit) * digit
        out[name] = {"limit": float(f"{limit:.2g}"), "lower": lower, "upper": upper,
                     "upper_from": source, **info}
    return {"numbers": out, "not_compared": skipped}


def main() -> int:
    cells = defaultdict(list)
    for path in sys.argv[1:]:
        with open(path) as f:
            for line in f:
                if line.startswith("{") and '"kind"' in line:
                    cells[path].append(json.loads(line))
    for path, rows in cells.items():
        print(path)
        print(json.dumps(limits_of(rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
