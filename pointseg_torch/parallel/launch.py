"""Starting data-parallel ranks without `torchrun`.

`spawn(fn, n, args)` runs `fn(mesh, *args)` in `n` new processes, one a
rank, joined through a `FileStore` in a fresh temporary directory (no
TCP port is bound), and returns what each rank returned. The `train
--data-parallel` command starts one rank a card this way when it runs
standalone on more than one card; the tests and `chip_smoke.py` start
their ranks with it. A rank that raises or dies, or a run that outlasts
`timeout`, makes `spawn` raise after every rank has been stopped.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable

import torch
import torch.multiprocessing as mp

from pointseg_torch.parallel.mesh import close_mesh, create_mesh


def _rank_main(rank: int, fn: Callable, world_size: int, workdir: str, device: str,
               threads: int | None, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    mesh = create_mesh(device, rank=rank, world_size=world_size,
                       store_path=os.path.join(workdir, "store"))
    try:
        result = fn(mesh, *args)
    finally:
        close_mesh(mesh)
    torch.save(result, os.path.join(workdir, f"result_{rank}.pt"))


def spawn(fn: Callable[..., Any], world_size: int, args: tuple = (), *,
          device: str = "cpu", timeout: float | None = None,
          threads: int | None = None) -> list:
    """Runs `fn(mesh, *args)` on `world_size` new processes (ranks 0..n-1
    on `device`: 'cpu', or 'cuda', card r modulo the cards there are) and
    returns each rank's result, in rank order (saved by `torch.save`, so
    tensors come back on their devices). `fn` must be importable by name.
    `threads` sets each rank's `torch.set_num_threads`; the whole run may
    take `timeout` seconds (None: no limit)."""
    with tempfile.TemporaryDirectory(prefix="pointseg_ranks_") as workdir:
        context = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, workdir, device, threads, args))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not context.join(timeout=5.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish "
                                       f"within {timeout} s")
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
                    process.join()
        return [torch.load(os.path.join(workdir, f"result_{rank}.pt"), weights_only=False)
                for rank in range(world_size)]
