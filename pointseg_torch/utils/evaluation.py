"""Whole-room evaluation with sliding-window inference (port of
`pointseg/utils/evaluation.py`).

A batch-size-1 room loop: string labels -> indices, per-room
sliding-window predictions, then metrics over every point of every room:
overall accuracy, per-class accuracy and its mean, per-class IoU and
mIoU, absent classes counting 0 (the reference's unsmoothed whole-room
definitions, unlike the eps-smoothed streaming metrics of the block
path).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from pointseg_torch.utils.sliding_window import (
    _device_scene_confusion,
    _room_pad,
    _to_device,
    confusion_to_metrics,
    predict_single_scene,
)


def evaluate_rooms(
    forward: Callable,
    room_loader: Iterable,
    class_names: Sequence[str],
    window_size: int = 4096,
    overlap: int = 512,
    verbose: bool = True,
    stream: str = "device",
    device: torch.device | str = "cuda",
) -> dict:
    """Evaluates a per-window forward function over whole rooms.

    Args:
        forward: (points (G, W, D), lengths (G,)) -> logits (G, W, C).
        room_loader: yields dicts with 'x' (list of (N, D) arrays) and
            'y' (list of string-label lists), the chunked room loaders.
        class_names: label vocabulary (indices = class ids).
        stream: 'device' (default) copies each room to the device once
            (labels packed as its last channel), runs its windows 8 at a
            time there and bin-counts (target, prediction) pairs into a
            device-resident confusion matrix, read once after all rooms;
            'host' runs the reference-shaped per-window loop and counts
            the pairs on the host. Equal up to float reassociation of the
            batched forward; both read their metrics off the confusion
            matrix (`confusion_to_metrics`).
        device: where the rooms go.
    """
    if stream not in ("device", "host"):
        raise ValueError("stream must be 'device' or 'host'")
    num_classes = len(class_names)
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    step = window_size - overlap

    t0 = time.time()
    rooms = 0
    if stream == "device":
        confusion = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    else:
        confusion = np.zeros((num_classes, num_classes), np.int64)
    for batch in room_loader:
        for points, labels in zip(batch["x"], batch["y"]):
            points = np.asarray(points, np.float32)
            target = np.array([name_to_idx[l] for l in labels], np.int64)
            if stream == "device":
                n, d = points.shape
                buf = np.full((_room_pad(n, window_size, step), d + 1), -1.0, np.float32)
                buf[:n, :d] = points
                buf[:n, d] = target
                buf[n:, :d] = 0.0
                confusion = _device_scene_confusion(
                    forward, _to_device(buf, device), n, window_size, step,
                    num_classes, confusion)
            else:
                preds, _ = predict_single_scene(forward, points, window_size=window_size,
                                                overlap=overlap, device=device)
                confusion += np.bincount(target * num_classes + preds,
                                         minlength=num_classes * num_classes
                                         ).reshape(num_classes, num_classes)
            rooms += 1
            if verbose and rooms % 10 == 0:
                print(f"Processed {rooms} rooms", flush=True)
    if stream == "device":
        confusion = confusion.cpu().numpy()
    results = confusion_to_metrics(confusion)
    results["class_names"] = list(class_names)
    results["evaluation_time"] = time.time() - t0
    if verbose:
        print("\n" + "=" * 60)
        print("EVALUATION RESULTS")
        print("=" * 60)
        print(f"Overall Accuracy: {results['overall_accuracy']:.4f}")
        print(f"Mean Class Accuracy: {results['mean_class_accuracy']:.4f}")
        print(f"Mean IoU: {results['mean_iou']:.4f}")
        print(f"Total Points: {results['total_points']:,}")
        print(f"Evaluation Time: {results['evaluation_time']:.2f}s")
        print(f"\n{'Class':<12} {'Accuracy':<10} {'IoU':<10}")
        print("-" * 32)
        for name, acc, iou in zip(class_names, results["class_accuracies"],
                                  results["class_ious"]):
            print(f"{name:<12} {acc:<10.4f} {iou:<10.4f}")
    return results
