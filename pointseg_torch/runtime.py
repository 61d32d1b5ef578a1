"""Out-of-memory advice (port of `oom_advice` and `is_oom_error` from
`pointseg/runtime.py`).

The rest of that module is TPU machinery and is not ported: the compile
cache's host fingerprints (`host_fingerprint`, `host_cache_dir`), the
XLA setup (`setup_runtime`) and the relay watchdog (`watchdog_devices`).
"""

from __future__ import annotations

import torch


def oom_advice(batch_size: int | None = None, num_points: int | None = None) -> str:
    """Remediation hints for device OOM (reference evaluate.py:108-113)."""
    lines = ["Out of device memory. Try:"]
    if batch_size:
        lines.append(f"  - a smaller batch size (current: {batch_size})")
    if num_points:
        lines.append(f"  - fewer points per block (current: {num_points})")
    lines += [
        "  - --bf16 for half-width activations",
        "  - smaller model variants (e.g. --model DGCNN emb_dims=256, k=16)",
        "  - sliding-window inference for whole rooms (evaluate --whole-rooms)",
    ]
    return "\n".join(lines)


def is_oom_error(e: BaseException) -> bool:
    """True for `torch.cuda.OutOfMemoryError` and for the errors whose
    text the JAX package takes for one (XLA's RESOURCE_EXHAUSTED, "out of
    memory")."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s or "out of memory" in s
