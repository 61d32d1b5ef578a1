"""Offline ETL, stage 4: chunked rooms -> 1m x 1m block files (the
port's copy of `pointseg/data/blocks.py`).

Rebuild of data_processing/preprocess_dataset.py:14-145 with the exact
block-grid math:

- block grid with centering offsets: for each axis, the span is rounded
  up to whole metres and the slack split evenly on both sides; offsets
  below 1e-4 are dropped (get_block_coords, :42-61);
- per-block point masks `start <= p < start + BLOCK_SIZE` (:64-70);
- blocks with < 100 points are skipped but still consume a block index
  (:127-130);
- points augmented to 9 features [xyz, rgb, xyz - block_center] where
  the center is (min_x + 0.5, min_y + 0.5, mid_z) (:73-90);
- labels one-hot encoded to (N, 14) uint8 (:30-39);
- a block -> grid-coordinates mapping is dumped alongside
  (`block_to_coords_mapping.json`, reference :139-141 uses pickle).

Output: `area_{a}/room{r:02d}_block{b:03d}.npz` with `points` (N, 9)
f32 and `labels` (N, 14) u8 — same naming convention as the reference
so block datasets can address either format.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from pointseg_torch.data.s3dis import (
    BLOCK_SIZE,
    MIN_POINTS_PER_BLOCK,
    NUM_S3DIS_CLASSES,
    S3DIS_CLASSES,
)
from pointseg_torch.data.prepare import load_room_archive


def one_hot_encode_labels(
    labels: np.ndarray, num_classes: int = NUM_S3DIS_CLASSES
) -> np.ndarray:
    """int codes (N,) -> one-hot (N, C) uint8 (reference :30-39 does
    str -> one-hot; codes come from the vocabulary in the archives)."""
    out = np.zeros((labels.shape[0], num_classes), np.uint8)
    out[np.arange(labels.shape[0]), labels] = 1
    return out


def get_block_starts(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Block grid origins with centering offsets (reference :42-61)."""

    def starts(v):
        lo, hi = float(v.min()), float(v.max())
        length = hi - lo
        offset = (math.ceil(length) - length) / 2
        if offset < 1e-4:
            offset = 0.0
        return np.arange(lo - offset, hi + offset, BLOCK_SIZE)

    return starts(x), starts(y)


def extract_block(
    points: np.ndarray, labels: np.ndarray, x_start: float, y_start: float
) -> tuple[np.ndarray, np.ndarray]:
    """Selects points with start <= coord < start + BLOCK_SIZE (:64-70)."""
    m = (
        (points[:, 0] >= x_start)
        & (points[:, 0] < x_start + BLOCK_SIZE)
        & (points[:, 1] >= y_start)
        & (points[:, 1] < y_start + BLOCK_SIZE)
    )
    return points[m], labels[m]


def augment_points(points: np.ndarray) -> np.ndarray:
    """6 -> 9 features: appends coords relative to the block center
    (min_x + B/2, min_y + B/2, mid_z) (reference :73-90)."""
    out = np.zeros((points.shape[0], 9), np.float32)
    out[:, :6] = points
    center = np.array(
        [
            points[:, 0].min() + BLOCK_SIZE / 2,
            points[:, 1].min() + BLOCK_SIZE / 2,
            points[:, 2].min() + (points[:, 2].max() - points[:, 2].min()) / 2,
        ],
        np.float32,
    )
    out[:, 6:] = out[:, :3] - center
    return out


def _chunk_files(input_dir: str) -> list[tuple[int, int, str]]:
    """(area, chunk, path) sorted, reference get_chunk_indices (:14-27)."""
    out = []
    for fn in os.listdir(input_dir):
        if "index" in fn or not fn.startswith("s3dis") or not fn.endswith(".npz"):
            continue
        stem = fn[len("s3dis"):-len(".npz")]
        if "_chunk" not in stem:
            continue
        a, c = stem.split("_chunk")
        out.append((int(a), int(c), os.path.join(input_dir, fn)))
    out.sort()
    return out


def preprocess_dataset(
    input_dir: str,
    output_dir: str,
    num_classes: int = NUM_S3DIS_CLASSES,
    verbose: bool = True,
) -> None:
    """Chunked room archives -> per-block npz files (reference :93-141)."""
    if not os.path.exists(input_dir):
        raise FileNotFoundError(f"Input directory {input_dir} does not exist.")
    os.makedirs(output_dir, exist_ok=True)

    mapping = []
    # room numbering restarts at 1 per chunk file, as in the reference
    # (preprocess_dataset.py:108 enumerates each chunk from 1) — room ids
    # are unique only together with the chunk ordering, which we keep.
    for area_index, chunk_index, path in _chunk_files(input_dir):
        area_dir = os.path.join(output_dir, f"area_{area_index}")
        os.makedirs(area_dir, exist_ok=True)
        rooms, classes = load_room_archive(path)
        # map archive vocab -> canonical 14-class order
        remap = np.array(
            [S3DIS_CLASSES.index(c) if c in S3DIS_CLASSES else -1 for c in classes],
            np.int32,
        )
        for room_index, room in enumerate(rooms, start=1):
            points = room["points"].astype(np.float32)
            codes = remap[room["labels"]]
            if (codes < 0).any():
                bad = sorted({classes[i] for i in room["labels"][codes < 0]})
                raise ValueError(f"Unknown labels {bad} in {path}")
            labels = one_hot_encode_labels(codes, num_classes)

            x_starts, y_starts = get_block_starts(points[:, 0], points[:, 1])
            block_index = 1
            for x0 in x_starts:
                for y0 in y_starts:
                    mapping.append(
                        {
                            "area": area_index,
                            "room": room_index,
                            "block": block_index,
                            "x_start": float(x0),
                            "y_start": float(y0),
                        }
                    )
                    bp, bl = extract_block(points, labels, x0, y0)
                    if bp.shape[0] < MIN_POINTS_PER_BLOCK:
                        if verbose and bp.shape[0] > 0:
                            print(
                                f"Area {area_index}, Chunk {chunk_index}, "
                                f"Room {room_index}: skipping block with "
                                f"{bp.shape[0]} points."
                            )
                        block_index += 1
                        continue
                    np.savez(
                        os.path.join(
                            area_dir,
                            f"room{room_index:02d}_block{block_index:03d}.npz",
                        ),
                        points=augment_points(bp),
                        labels=bl,
                    )
                    block_index += 1

    with open(os.path.join(output_dir, "block_to_coords_mapping.json"), "w") as f:
        json.dump(mapping, f)
    if verbose:
        print(f"Wrote block mapping with {len(mapping)} entries.")
