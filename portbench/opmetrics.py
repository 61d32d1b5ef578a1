"""Per-op readings of the host-traced stretch, for the metrics that read
them: `device_ms(r, *ops)` and `roofline(r, *ops)` over the ops named.

A traced op (`portbench/opwork/<op>.py`) gets its metrics from two files
of one line each, `portbench/metrics/ops.<op>_ms.py` and
`ops.<op>_roofline.py`. `ops.device_ms` and `ops_roofline` read the
geometric ops below, the seven that the benchmark traced when it
defined them, so that an op added later moves neither.
"""

from __future__ import annotations

GEOMETRIC = ("farthest_point_sampling", "ball_query", "interpolate", "knn_indices",
             "gather_rows", "gather_rows_with_coords", "gather_neighbors")


def _sums(r, ops) -> tuple[float, float]:
    """(device seconds, bound seconds) of `ops` over the stretch."""
    read = r["profile"]["ops"]
    found = [read[name] for name in ops if name in read]
    return sum(o["device_s"] for o in found), sum(o["bound_s"] for o in found)


def device_ms(r, *ops: str) -> float | None:
    """Device time a step of what `ops` launched, in ms; None where they
    ran nothing on a card."""
    device, _ = _sums(r, ops)
    return device / r["profile"]["steps"] * 1e3 if r["cuda"] and device > 0 else None


def roofline(r, *ops: str) -> float | None:
    """The summed bound times of `ops` over their summed device time, in %;
    None where they ran nothing on a card."""
    device, bound = _sums(r, ops)
    return 100.0 * bound / device if r["cuda"] and device > 0 else None
