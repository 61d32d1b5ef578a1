"""Reading a profiler window: the device's busy time, the time of the
kernels launched inside named host ranges, and the breakdown.

The window is a `torch.profiler` trace in Chrome's JSON format. Device
activity is every `kernel`, `gpu_memcpy` and `gpu_memset` event; a
kernel belongs to the host range (`user_annotation`) in which the CUDA
runtime or driver call that launched it ran, matched by the launch's
correlation id. Timestamps of host and device events share one clock.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Window:
    """The events of one traced window. With `name`, the window is the host
    range of that name (a trace of host and device). Without, it is a
    device-only trace opened by a spin kernel: from the spin's end to the
    end of the last device event."""

    def __init__(self, path: str, name: str | None = None):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        if name is None:
            spins = [e for e in device if "spin_kernel" in e["name"]]
            device = [e for e in device if "spin_kernel" not in e["name"]]
            self.t0 = max((e["ts"] + e["dur"] for e in spins),
                          default=min((e["ts"] for e in device), default=0.0))
            device = [e for e in device if e["ts"] >= self.t0]
            self.t1 = max((e["ts"] + e["dur"] for e in device), default=self.t0)
            self.main_tid = None
            mark = None
        else:
            marks = [e for e in events
                     if e.get("cat") == "user_annotation" and e["name"] == name]
            if len(marks) != 1:
                raise ValueError(f"the trace holds {len(marks)} '{name}' ranges, not one")
            mark = marks[0]
            self.t0, self.t1 = mark["ts"], mark["ts"] + mark["dur"]
            self.main_tid = mark["tid"]
        self.device = [e for e in device if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.launch_at = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
                          if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e["tid"] == self.main_tid and e is not mark]
        self.ranges = [e for e in events if e.get("cat") == "user_annotation"
                       and e["tid"] == self.main_tid]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self):
        """Merged device-busy intervals inside the window (µs)."""
        return _merge([(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                       for e in self.device])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def range_device_s(self, prefix: str) -> dict[str, float]:
        """{range name: device seconds of what was launched inside it} for
        the host ranges whose name starts with `prefix`."""
        ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.ranges
                        if e["name"].startswith(prefix))
        starts = [r[0] for r in ranges]
        out: dict[str, float] = defaultdict(float)
        for e in self.device:
            launch = self.launch_at.get(e.get("args", {}).get("correlation"))
            if launch is None or launch[1] != self.main_tid:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and launch[0] <= ranges[i][1]:
                out[ranges[i][2]] += e["dur"] * 1e-6
        return dict(out)

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose name contains one of `names`,
        wherever they were launched."""
        return sum(e["dur"] for e in self.device
                   if e.get("cat") == "kernel" and any(n in e["name"] for n in names)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """[[kernel name, seconds], ...]: the device operations that took most time."""
        sums: dict[str, float] = defaultdict(float)
        for e in self.device:
            sums[e["name"]] += (min(e["ts"] + e["dur"], self.t1) - max(e["ts"], self.t0)) * 1e-6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host activity, seconds], ...]: the device's idle time inside the
        window, summed by the innermost host range or op that covered the
        middle of each gap."""
        busy = self.busy()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host)
        gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a)
        sums: dict[str, float] = defaultdict(float)
        active: list = []
        nxt = 0
        for mid, length in gaps:  # a sweep: the host events open at each gap's middle
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            label = min(active, key=lambda h: h[1] - h[0])[2] if active else "host (outside any op)"
            sums[label] += length * 1e-6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
