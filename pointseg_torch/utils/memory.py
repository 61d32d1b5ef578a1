"""Device and host memory telemetry (port of `pointseg/utils/memory.py`,
the reference's `get_memory_usage`, models/dgcnn/utils.py:332-355).

Per visible CUDA device, from `torch.cuda.memory_stats`: the bytes the
caching allocator holds in tensors now (`allocated_bytes.all.current`)
and at most since the last peak reset (`allocated_bytes.all.peak`), and
the device's total memory; plus the host's resident set from /proc. The
keys are the JAX package's. Without a card the device list is empty.
"""

from __future__ import annotations

import os

import torch


def get_memory_usage() -> dict:
    out = {"devices": [], "host_rss_mb": None}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out["devices"].append({
                "device": f"cuda:{i}",
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            })
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    out["host_rss_mb"] = int(line.split()[1]) / 1024.0
                    break
    except OSError:
        pass
    return out


def format_memory_usage() -> str:
    m = get_memory_usage()
    parts = []
    for d in m["devices"]:
        if d["bytes_in_use"] is not None:
            parts.append(
                f"{d['device']}: {d['bytes_in_use'] / 2**20:.0f}MB in use"
                + (f" (peak {d['peak_bytes_in_use'] / 2**20:.0f}MB)"
                   if d.get("peak_bytes_in_use") else "")
            )
    if m["host_rss_mb"]:
        parts.append(f"host RSS: {m['host_rss_mb']:.0f}MB")
    return "; ".join(parts) if parts else "memory stats unavailable"
