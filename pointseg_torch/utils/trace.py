"""Named spans of the program in `torch.profiler`'s trace.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
records, and one shared null context otherwise: the profiler is the
switch (`train --profile`, or any `torch.profiler.profile` around the
program), and with none running a span costs a flag read. A recorded
span is a host range (`user_annotation` in the Chrome trace) on the
thread that opened it, stamped on the clock of the device events; the
profiler keeps it in memory until its trace is exported.

The gate is the profiler's process-wide flag, which every thread sees,
and not `torch.autograd._profiler_enabled()`, which reads this thread's
profiler state: a loader's reader threads have none, and a profiler
that records every thread (`profile_all_threads`) sets none on any.
The module imports no torch, so that the numpy data layer can open
spans: where torch is not loaded, no profiler records.

The names, each opened on the thread that does the work:

- `pointseg_torch.step#<n>` (`n`: `TrainState.step` before the update)
  around a train step, with `.step.forward` (the model and the loss),
  `.step.backward` (`backward`, and `train_step`'s `zero_grad`; autograd
  launches the backward kernels from its own thread while this one waits),
  `.step.update` (the gradients' reduction over ranks, the rate, the
  clip, Adam) and `.step.metrics` (the batch's loss, accuracy, mIoU);
- `.model.invres` around each PointNeXt InvResMLP block's forward
  (`nn/blocks.py`: ball query, grouped layer, max, point MLP, residual
  add), inside `.step.forward` in a train step;
- `.loop.to_device`, `.loop.epoch_close` (the epoch's host read of its
  mean loss), `.loop.log_read` (the logger's host reads);
- `.data.epoch_start` (the device store's seeding and permutation),
  `.data.sample` (one batch drawn from the store), `.data.loader_next`
  (the consumer's wait on the host loader), `.data.loader_read` and
  `.data.loader_collate` (a reader thread's block read and collate),
  `.data.shard` (a rank's rows of a global batch);
- `.collective.all_reduce`, `.collective.broadcast`.

While a profiler records, `train_step` runs eagerly, so that every span
and op range above sees the launches it holds (`recording`). Counters,
kept whether or not a profiler runs:

- `ops/_kernels.py::LAUNCHES`: the port's kernel launches from Python,
  per kernel (a replayed CUDA graph launches none from Python);
- `train/state.py::STEP_GRAPHS`: train steps captured into a CUDA graph,
  replayed from one, and run eagerly;
- `parallel/mesh.py::COLLECTIVES`: collective calls and their host time.
"""

from __future__ import annotations

import contextlib
import sys

NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records: the process-wide flag `span` reads."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


def span(name: str, index: int | None = None):
    """A profiler range named `name` (`name#index` with an index, the
    string built only while recording), or `NULL` with no profiler."""
    if not recording():
        return NULL
    profiler = sys.modules["torch.autograd.profiler"]
    return profiler.record_function(name if index is None else f"{name}#{index}")
