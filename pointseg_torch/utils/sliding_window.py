"""Sliding-window whole-room inference with overlap averaging (port of
`pointseg/utils/sliding_window.py`).

Rooms too large for one forward pass are processed in fixed windows
(default 4096 points) with overlap (default 512); per-point logits are
summed over the windows that cover a point and divided by their count,
then argmax and the softmax confidence of the argmax. Every window has
the same (W, D) shape: the last one is zero-padded with a length instead
of being shorter.

- `predict_single_scene`, the host loop: one forward of batch 1 a
  window, its logits copied back to the host, summed there.
- `predict_single_scene_device`, the streaming path: the room is copied
  to the device once, windows run `group` (8) at a time as one (8, W, D)
  forward, the overlap sums and counts accumulate on the device, and one
  copy a room comes back; no host read a window.
- `_device_scene_confusion`: the streaming path's windows with the
  labels packed as the room's last channel, bin-counting (target,
  prediction) pairs into a device-resident confusion matrix; the only
  read is the matrix after all rooms (`evaluate_rooms`).
- With `mesh=` (a `parallel.Mesh`, the JAX package's `mesh=`), the
  streaming path shares each group's windows over the data-parallel
  ranks and all-reduces the overlap sums; no CLI flag reaches it, in
  either package.

The streaming path keeps the JAX package's schedule, grouping and
padding: the room buffer is padded to a geometric bucket (`_bucket`),
and the windows of the last group past the room's count run in the
forward at their start clamped to the buffer's last window, then are
masked out of the sums. With running BatchNorm statistics they are
invisible; under batch statistics they enter the group's statistics, as
in the JAX package. Groups with no window of the room are not run: they
change nothing.

`forward(points (G, W, D), lengths (G,)) -> logits (G, W, C)` runs on
the device the tensors it is given lie on.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pointseg_torch.parallel.mesh import Mesh, all_reduce_, use

Forward = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _window_starts(n: int, window_size: int, step: int) -> list[int]:
    """The host loop's schedule: range(0, n - W + step, step) when n > W,
    else the single start 0."""
    if n <= window_size:
        return [0]
    return list(range(0, n - window_size + step, step))


def _to_device(buf: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """One host-to-device copy that does not wait for the device's queue
    (staged through pinned memory on CUDA)."""
    t = torch.from_numpy(buf)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _predictions(avg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Averaged logits (N, C) -> (argmax (N,) int32, its softmax probability)."""
    preds = avg.argmax(dim=-1)
    conf = torch.softmax(avg, dim=-1).gather(-1, preds[:, None])[:, 0]
    return preds.to(torch.int32), conf


@torch.no_grad()
def scene_logits_host(forward: Forward, points: np.ndarray, window_size: int = 4096,
                      overlap: int = 512, device: torch.device | str = "cuda") -> np.ndarray:
    """Averaged per-point logits (N, C) of the host loop on the host."""
    n = points.shape[0]
    step = window_size - overlap
    logits_sum = None
    counts = np.zeros((n,), np.float32)
    for s in _window_starts(n, window_size, step):
        e = min(s + window_size, n)
        w = e - s
        buf = np.zeros((1, window_size, points.shape[1]), np.float32)
        buf[0, :w] = points[s:e]
        lengths = torch.tensor([w], dtype=torch.int32, device=device)
        out = forward(torch.from_numpy(buf).to(device), lengths)[0, :w].cpu().numpy()
        if logits_sum is None:
            logits_sum = np.zeros((n, out.shape[-1]), np.float32)
        logits_sum[s:e] += out
        counts[s:e] += 1.0
    counts = np.maximum(counts, 1.0)  # every point is covered; guard all the same
    return logits_sum / counts[:, None]


def predict_single_scene(forward: Forward, points: np.ndarray, window_size: int = 4096,
                         overlap: int = 512,
                         device: torch.device | str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-point predictions for one (possibly huge) room, by the host loop.

    Args:
        forward: (points (1, W, D), lengths (1,)) -> logits (1, W, C).
        points: (N, D) room points.
        window_size: window length W.
        overlap: overlap between consecutive windows.
        device: where the windows go.

    Returns:
        (predictions (N,) int32, confidences (N,) float32).
    """
    avg = scene_logits_host(forward, points, window_size, overlap, device)
    preds, conf = _predictions(torch.from_numpy(avg))
    return preds.numpy(), conf.numpy()


def _bucket(n: int, base: int = 4096, ratio: float = 1.25, quantum: int = 512) -> int:
    """Rounds a room size up to a geometric bucket (x1.25 steps from
    4096, aligned to 512), the room buffer size of the streaming path."""
    b = float(base)
    while b < n:
        b *= ratio
    return -(-int(b) // quantum) * quantum


def _room_pad(n: int, window_size: int, step: int) -> int:
    """The streaming path's buffer size: past the last window's reach (the
    last host start is < n - W + step), bucketed."""
    return _bucket(max(n + step, window_size))


@torch.no_grad()
def scene_logits_device(forward: Forward, room: torch.Tensor, n: int, window_size: int,
                        step: int, num_classes: int, group: int = 8,
                        mesh: Mesh | None = None) -> torch.Tensor:
    """Averaged per-point logits (R, C) over a room buffer `room` (R, D)
    on the device, whose first `n` rows are the room; windows `group` at
    a time, the overlap sums on the device.

    With a data-parallel `mesh` (`parallel/mesh.py`; every rank holds the
    room) each rank forwards its share of every group's windows, rows
    [r G/n, (r+1) G/n), inside `use(mesh)` (so batch BatchNorm statistics
    are the group's, as in one process), sums its windows, and the sums
    and counts are all-reduced: the JAX package's `mesh=`, the group axis
    sharded. The world size must divide `group`."""
    share = slice(0, group) if mesh is None else mesh.rows(group)
    R = room.shape[0]
    num_win = 1 if n <= window_size else (n - window_size + 2 * step - 1) // step
    n_groups = -(-num_win // group)
    last = max(R - window_size, 0)
    starts = [min(w * step, last) for w in range(n_groups * group)]
    starts_dev = _to_device(np.asarray(starts, np.int64), room.device)
    arange = torch.arange(window_size, device=room.device)
    logits_sum = torch.zeros((R, num_classes), dtype=torch.float32, device=room.device)
    counts = torch.zeros((R,), dtype=torch.float32, device=room.device)
    for g in range(n_groups):
        first = g * group
        group_starts = starts_dev[first + share.start:first + share.stop]
        wlens = (n - group_starts).clamp(0, window_size).to(torch.int32)
        with use(mesh):
            logits = forward(room[group_starts[:, None] + arange], wlens)  # (G, W, C)
        # windows of one group can overlap: accumulate them in order
        for j in range(share.start, min(share.stop, num_win - first)):
            s = starts[first + j]  # a clamped window past the room: no sums
            m = arange < min(n - s, window_size)
            logits_sum[s:s + window_size] += torch.where(m[:, None], logits[j - share.start],
                                                         0.0)
            counts[s:s + window_size] += m.to(torch.float32)
    if mesh is not None:
        all_reduce_(logits_sum, mesh)
        all_reduce_(counts, mesh)
    return logits_sum / counts.clamp_min(1.0)[:, None]


def predict_single_scene_device(forward: Forward, points: np.ndarray, window_size: int = 4096,
                                overlap: int = 512, num_classes: int = 14,
                                device: torch.device | str = "cuda",
                                mesh: Mesh | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Streaming `predict_single_scene`: the room resident on the device,
    one copy there and one back. Same schedule, same per-window forward
    and the same overlap averaging as the host loop, the windows batched
    8 at a time; with a data-parallel `mesh`, each group's windows shared
    over its ranks (`scene_logits_device`)."""
    n, d = points.shape
    step = window_size - overlap
    if step <= 0:
        raise ValueError("overlap must be smaller than window_size")
    buf = np.zeros((_room_pad(n, window_size, step), d), np.float32)
    buf[:n] = points
    avg = scene_logits_device(forward, _to_device(buf, device), n, window_size, step,
                              num_classes, mesh=mesh)
    preds, conf = _predictions(avg)
    return preds[:n].cpu().numpy(), conf[:n].cpu().numpy()


@torch.no_grad()
def _device_scene_confusion(forward: Forward, room_and_labels: torch.Tensor, n: int,
                            window_size: int, step: int, num_classes: int,
                            confusion: torch.Tensor) -> torch.Tensor:
    """`confusion` plus the room's (target, prediction) counts, on the
    device. `room_and_labels` (R, D + 1) holds the labels as its last
    channel (-1 past the room). The confusion matrix is a sufficient
    statistic of every whole-room metric (`confusion_to_metrics`)."""
    room = room_and_labels[:, :-1]
    target = room_and_labels[:, -1].to(torch.int64)
    preds, _ = _predictions(scene_logits_device(forward, room, n, window_size, step,
                                                num_classes))
    valid = (torch.arange(room.shape[0], device=room.device) < n) & (target >= 0)
    flat = torch.where(valid, target * num_classes + preds, 0)
    counts = torch.zeros((num_classes * num_classes,), dtype=confusion.dtype,
                         device=room.device)
    counts.index_add_(0, flat, valid.to(confusion.dtype))
    return confusion + counts.reshape(num_classes, num_classes)


def confusion_to_metrics(confusion: np.ndarray) -> dict:
    """Whole-room metrics from a confusion matrix (rows = target, cols =
    prediction), the reference's evaluate_model definitions: absent
    classes score 0 in the class means."""
    conf = np.asarray(confusion, np.float64)
    diag = np.diag(conf)
    row = conf.sum(1)
    col = conf.sum(0)
    union = row + col - diag
    class_acc = np.where(row > 0, diag / np.maximum(row, 1), 0.0)
    class_iou = np.where(union > 0, diag / np.maximum(union, 1), 0.0)
    total = conf.sum()
    return {
        "overall_accuracy": float(diag.sum() / max(total, 1)),
        "mean_class_accuracy": float(class_acc.mean()),
        "mean_iou": float(class_iou.mean()),
        "class_accuracies": class_acc.tolist(),
        "class_ious": class_iou.tolist(),
        "total_points": int(total),
    }
