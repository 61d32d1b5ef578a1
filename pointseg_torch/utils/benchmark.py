"""Inference and training micro-benchmarks (port of
`pointseg/utils/benchmark.py`): warm-up calls, then timed calls, and
their mean, spread and rate.

On a CUDA device each timed call sits between a pair of CUDA events and
one `torch.cuda.synchronize()` follows the last call: nothing is read
back between calls, so a host-bound model keeps its host running ahead
of the device as it does in training. A call's time runs from its start
event to its end event on the stream: where the device waits on the
host's dispatch within the call, the wait is counted. On the CPU the
calls are timed with `time.perf_counter`. The JAX version's chunking and
relay sync (`pick_chunk`, `_sync`) serve a TPU runtime and have no
counterpart here, so neither do its `chunk` and `sync_ms` keys.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def benchmark_fn(fn: Callable, *args, num_runs: int = 50, warmup: int = 10,
                 device: torch.device | str = "cuda") -> dict:
    """Times `fn(*args)` over `num_runs` calls after `warmup` calls, on
    `device` ('cuda', the default, or 'cpu'): {mean_s, std_s, min_s,
    max_s, fps, num_runs}. A CUDA device must be present for 'cuda'."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("benchmark_fn on cuda: torch.cuda.is_available() is false")
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(num_runs)]
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(device)
        times = np.array([start.elapsed_time(end) / 1e3 for start, end in pairs])
    else:
        times = np.empty(num_runs)
        for i in range(num_runs):
            t0 = time.perf_counter()
            fn(*args)
            times[i] = time.perf_counter() - t0
    return {
        "mean_s": float(times.mean()),
        "std_s": float(times.std()),
        "min_s": float(times.min()),
        "max_s": float(times.max()),
        "fps": float(1.0 / times.mean()),
        "num_runs": num_runs,
    }


def benchmark_points_per_sec(fn: Callable, *args, points_per_call: int, num_runs: int = 50,
                             warmup: int = 10, device: torch.device | str = "cuda") -> dict:
    """`benchmark_fn` plus points/s for a call that processes
    `points_per_call` points."""
    stats = benchmark_fn(fn, *args, num_runs=num_runs, warmup=warmup, device=device)
    stats["points_per_sec"] = points_per_call / stats["mean_s"]
    return stats
