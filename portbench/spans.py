"""Reading the program's own spans in a host-traced window: the device
time of what a span launched, and the device's idle time at the epoch
boundary.

The program opens named profiler ranges (`pointseg_torch/utils/trace.py`:
`pointseg_torch.step.forward`, `.step.backward`, ...) on the thread that
does the work; `tracefile.Window` keeps the main thread's ranges, the
device's events and each launch's time and thread, on one clock. A
device event belongs to a span when its launch, from ANY thread, falls
inside one of the span's intervals: on the card autograd launches the
backward kernels from its own thread while the main thread waits inside
`pointseg_torch.step.backward`, so `Window.range_device_s`, which counts
the main thread's launches alone, would read it as nothing.

A program without the spans (one older than them) gives None, and the
metric is left out of the line.
"""

from __future__ import annotations

import bisect

from portbench.tracefile import _merge

STEP = "pointseg_torch.step"
EPOCH_CLOSE = "pointseg_torch.loop.epoch_close"
EPOCH_START = "pointseg_torch.data.epoch_start"


def intervals(win, *names: str) -> list:
    """Merged [start, end] (µs) of the main thread's spans named one of
    `names` that start inside the window."""
    return _merge([(e["ts"], e["ts"] + e["dur"]) for e in win.ranges
                   if e["name"] in names and win.t0 <= e["ts"] < win.t1])


def launched_s(win, *names: str) -> float | None:
    """Device seconds of the events launched, from any thread, inside the
    spans named `names`; None where the window holds none of them."""
    spans = intervals(win, *names)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    total = 0.0
    for e in win.device:
        launch = win.launch_at.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= spans[i][1]:
            total += e["dur"] * 1e-6
    return total


def epoch_idle_s(win) -> float | None:
    """The device's idle seconds from the start of each epoch's close (the
    host's read of its mean loss, which drains the device's queue) to the
    first device event after the next epoch's start (its seeding and
    permutation), summed; None where the window crosses no epoch's close."""
    closes = intervals(win, EPOCH_CLOSE)
    if not closes:
        return None
    starts = [a for a, _ in intervals(win, EPOCH_START)]
    busy = win.busy()
    total = 0.0
    for close, _ in closes:
        start = next((a for a in starts if a >= close), None)
        end = win.t1 if start is None else min(
            (e["ts"] for e in win.device if e["ts"] >= start), default=win.t1)
        covered = sum(max(0.0, min(b, end) - max(a, close)) for a, b in busy)
        total += (end - close - covered) * 1e-6
    return total


def per_step_ms(r, *names: str) -> float | None:
    """`launched_s` of the host-traced stretch a step, in ms (card runs)."""
    p = r["profile"]
    s = launched_s(p["host_window"], *names) if r["cuda"] else None
    return None if s is None else s / p["steps"] * 1e3
