"""The S3DIS block rule, frozen for the benchmark.

A copy of the block preprocessor's arithmetic (the reference
`data_processing/preprocess_dataset.py`, as `pointseg_torch/data/blocks.py`
also carries it), kept here so that a change to the program cannot change
the blocks the benchmark writes:

- the 1 m x 1 m grid: per axis, the span is rounded up to whole metres and
  the slack split on both sides (an offset below 1e-4 is dropped);
- a block holds the points with start <= x < start + 1 (and likewise y);
- blocks of fewer than 100 points are skipped but use up a block index;
- 9 features a point: xyz, rgb (0-255 as float32) and xyz minus the block
  centre (min x + 0.5, min y + 0.5, mid z);
- labels one-hot, (N, 14) uint8.
"""

from __future__ import annotations

import math

import numpy as np

BLOCK_SIZE = 1.0
MIN_POINTS_PER_BLOCK = 100
NUM_CLASSES = 14
CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window", "door", "table", "chair",
           "sofa", "bookcase", "board", "clutter", "stairs")


def block_starts(v: np.ndarray) -> np.ndarray:
    """Grid origins along one axis, centred on the points' span."""
    lo, hi = float(v.min()), float(v.max())
    length = hi - lo
    offset = (math.ceil(length) - length) / 2
    if offset < 1e-4:
        offset = 0.0
    return np.arange(lo - offset, hi + offset, BLOCK_SIZE)


def block_mask(xyz: np.ndarray, x0: float, y0: float) -> np.ndarray:
    return ((xyz[:, 0] >= x0) & (xyz[:, 0] < x0 + BLOCK_SIZE)
            & (xyz[:, 1] >= y0) & (xyz[:, 1] < y0 + BLOCK_SIZE))


def nine_features(points6: np.ndarray) -> np.ndarray:
    """(N, 6) xyz + rgb -> (N, 9) float32 with xyz minus the block centre."""
    out = np.zeros((points6.shape[0], 9), np.float32)
    out[:, :6] = points6
    center = np.array([points6[:, 0].min() + BLOCK_SIZE / 2,
                       points6[:, 1].min() + BLOCK_SIZE / 2,
                       points6[:, 2].min() + (points6[:, 2].max() - points6[:, 2].min()) / 2],
                      np.float32)
    out[:, 6:] = out[:, :3] - center
    return out


def one_hot(codes: np.ndarray) -> np.ndarray:
    out = np.zeros((codes.shape[0], NUM_CLASSES), np.uint8)
    out[np.arange(codes.shape[0]), codes] = 1
    return out


def cut_room(points6: np.ndarray, codes: np.ndarray):
    """Yields (block index, (N, 9) float32 points, (N, 14) uint8 labels)
    for every block of a room that holds enough points, in the
    preprocessor's order (x outer, y inner; indices from 1)."""
    index = 1
    for x0 in block_starts(points6[:, 0]):
        for y0 in block_starts(points6[:, 1]):
            m = block_mask(points6, x0, y0)
            if int(m.sum()) >= MIN_POINTS_PER_BLOCK:
                yield index, nine_features(points6[m]), one_hot(codes[m])
            index += 1
