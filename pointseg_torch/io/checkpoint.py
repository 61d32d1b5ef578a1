"""Checkpoints with a config sidecar, periodic save and resume (port of
`pointseg/io/checkpoint.py`).

A checkpoint is `checkpoint_{step}.pt`, written by `torch.save` (to a
`.tmp` file, then renamed) and holding plain containers of tensors and
numbers only, so `torch.load(..., weights_only=True)` reads it and no
class is pickled: the model's `state_dict()` (the reference key layout,
BatchNorm running statistics included), the optimizer's `state_dict()`
(Adam's moments and counts), the step and the FPS generator's state
with its device type. `config.json` beside it records the run's
settings; the newest `keep` checkpoints survive a save. A CUDA
generator's state does not fit a CPU generator (nor the reverse): a
checkpoint restored on the other kind of device keeps the state's own
generator, with a warning.

Data-parallel training (`parallel/mesh.py`) leaves the model unwrapped,
so its checkpoints have the one-process keys: rank 0 writes them, every
rank restores them on `--resume`, and a checkpoint of either kind of run
resumes the other. A tensor-parallel state (`parallel/tensor_parallel.py`)
is saved whole as well: the ranks of data rank 0 (every rank of its model
line) call `save_checkpoint`, which gathers each shard's whole tensor and
its optimizer moments over the model axis, and the line's first rank
writes; restoring into a placed state cuts every rank's shards from the
whole tensors. So a checkpoint of a tensor-parallel run restores in one
process, and the reverse.

The JAX package's checkpoints (`checkpoint_{step}.msgpack`, flax
serialisation) are refused: the port reads its own checkpoints, and the
reference's `.pt` state_dicts through `import-torch`; JAX weights held as
numpy arrays convert with `io/jax_import.py::from_jax_variables`.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any

import torch

from pointseg_torch.parallel import tensor_parallel as tp

_CKPT_RE = re.compile(r"checkpoint_(\d+)\.pt$")
_JAX_CKPT_RE = re.compile(r"checkpoint_(\d+)\.msgpack$")


def _numbered(ckpt_dir: str, pattern: re.Pattern) -> list[tuple[int, str]]:
    return sorted((int(m.group(1)), fn) for fn in os.listdir(ckpt_dir)
                  if (m := pattern.match(fn)))


def save_checkpoint(ckpt_dir: str, state, step: int | None = None,
                    config: dict[str, Any] | None = None, keep: int = 5) -> str:
    """Writes `checkpoint_{step}.pt` (and `config.json` when `config` is
    given) into `ckpt_dir`, prunes all but the newest `keep`, and returns
    the checkpoint's path."""
    step = state.step if step is None else int(step)
    placed = tp.is_placed(state.model)
    path = os.path.join(ckpt_dir, f"checkpoint_{step}.pt")
    model = tp.full_state_dict(state.model) if placed else state.model.state_dict()
    optimizer = (tp.full_optimizer_state(state.optimizer, state.model) if placed
                 else state.optimizer.state_dict())
    if placed and state.mesh.axis_index(tp.MODEL_AXIS) != 0:
        return path  # the model line's first rank writes
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": step,
        "model": model,
        "optimizer": optimizer,
        "generator": None if state.generator is None else state.generator.get_state(),
        "generator_device": None if state.generator is None else state.generator.device.type,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)

    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    for _, fn in _numbered(ckpt_dir, _CKPT_RE)[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, fn))
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _numbered(ckpt_dir, _CKPT_RE)
    return os.path.join(ckpt_dir, ckpts[-1][1]) if ckpts else None


def load_checkpoint(path: str) -> dict[str, Any]:
    """The checkpoint's contents, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_config(ckpt_dir: str) -> dict[str, Any] | None:
    p = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _refuse_jax_checkpoint(ckpt_dir_or_path: str) -> None:
    jax_ckpt = ckpt_dir_or_path.endswith(".msgpack") or (
        os.path.isdir(ckpt_dir_or_path) and _numbered(ckpt_dir_or_path, _JAX_CKPT_RE))
    if jax_ckpt:
        raise ValueError(f"{ckpt_dir_or_path} holds a JAX checkpoint (.msgpack); "
                         "pointseg_torch reads its own checkpoint_{step}.pt files, and "
                         "reference PyTorch .pt state_dicts through `import-torch`. JAX "
                         "weights held as numpy arrays convert with "
                         "pointseg_torch.io.jax_import.from_jax_variables.")


def restore_train_state(ckpt_dir_or_path: str, state):
    """Resumes a TrainState in place from a directory (its latest
    checkpoint) or a checkpoint file, and returns it: weights, BatchNorm
    statistics, optimizer state, step and FPS generator state.

    Every entry's shape is checked against the model before anything is
    loaded, so a checkpoint of another architecture fails here with the
    keys named, not later inside a matmul."""
    if os.path.isdir(ckpt_dir_or_path):
        path = latest_checkpoint(ckpt_dir_or_path)
        if path is None:
            _refuse_jax_checkpoint(ckpt_dir_or_path)
    else:
        _refuse_jax_checkpoint(ckpt_dir_or_path)
        path = ckpt_dir_or_path if os.path.exists(ckpt_dir_or_path) else None
    if path is None:
        raise FileNotFoundError(f"No checkpoint found in {ckpt_dir_or_path}")
    restored = load_checkpoint(path)

    want = tp.full_shapes(state.model)
    got = restored["model"]
    mismatches = [f"{k}: missing from the checkpoint" for k in want if k not in got]
    mismatches += [f"{k}: not in the model" for k in got if k not in want]
    mismatches += [f"{k}: {tuple(got[k].shape)} vs model {w}"
                   for k, w in want.items() if k in got and tuple(got[k].shape) != w]
    if mismatches:
        raise ValueError(f"Checkpoint {path} does not match the model architecture:\n  "
                         + "\n  ".join(mismatches[:10]))

    state.optimizer.load_state_dict(restored["optimizer"])
    if tp.is_placed(state.model):  # every rank its shards of the whole tensors
        tp.load_full_state_dict(state.model, got)
        tp.shard_optimizer_state_(state.optimizer, state.model)
    else:
        state.model.load_state_dict(got)
    state.step = int(restored["step"])
    if state.generator is not None and restored["generator"] is not None:
        if restored["generator_device"] == state.generator.device.type:
            state.generator.set_state(restored["generator"])
        else:
            warnings.warn(f"{path}: the FPS generator's state was saved from a "
                          f"{restored['generator_device']} generator and does not fit this "
                          f"{state.generator.device.type} one; it keeps its own seed")
    return state
