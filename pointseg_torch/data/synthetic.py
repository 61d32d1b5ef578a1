"""Synthetic S3DIS-like data generators (the port's copy of
`pointseg/data/synthetic.py`; same files from the same seed).

The reference ships a `test_data/` excerpt (gitignored, absent here) and
a `TmpDataset` random fixture (models/PointNeXt/PointNeXt.py:152-164).
These generators fill both roles: structured fake rooms with learnable
geometry/label correlation (floor points are low, ceiling points are
high, ...) for tests and benchmarks that need the full pipeline.
"""

from __future__ import annotations

import os

import numpy as np

from pointseg_torch.data.blocks import preprocess_dataset
from pointseg_torch.data.prepare import precompute_chunk_index, save_room_archive
from pointseg_torch.data.s3dis import S3DIS_CLASSES


# Per-class base colors for `class_colors=True` rooms (real S3DIS rgb
# correlates with class: white-ish ceilings, grey floors, ...). Only the
# four classes make_room emits need entries; spacing >> noise width.
_CLASS_COLOR_BASE = np.array(
    [
        [230, 230, 225],  # 0 ceiling: near-white
        [90, 70, 50],     # 1 floor: brown
        [170, 40, 40],    # 2 lower wall: red-ish
        [40, 110, 180],   # 3 upper wall: blue-ish
    ],
    np.float32,
)


def make_room(
    rng: np.random.Generator,
    num_points: int = 2000,
    size_xy: float = 3.0,
    height: float = 2.5,
    num_classes: int = 14,
    rgb_u8: bool = False,
    class_colors: bool = False,
) -> dict:
    """One fake room: xyz uniform in a box, rgb in [0, 255], labels a
    deterministic function of height (ceiling / floor / two wall bands)
    so models can verifiably learn the task in a few steps.

    `rgb_u8` draws integer colors like real S3DIS (whose rgb are u8) —
    required by fixtures exercising the compact 16-byte/point device
    store, which only packs exact-u8 colors.

    `class_colors` draws rgb around a per-class base color (noise ±30)
    instead of uniform noise — mimicking real S3DIS, where rgb is
    informative. The default uniform rgb (raw 0-255, never normalized by
    the reference block preprocessor, blocks.py:73-90) drowns the
    geometric signal for architectures without local geometry features:
    PointNet plateaus at majority-class accuracy on it, so the PointNet parity gate uses class-colored rooms."""
    xyz = rng.uniform(0, 1, size=(num_points, 3)).astype(np.float32)
    xyz[:, :2] *= size_xy
    xyz[:, 2] *= height
    z = xyz[:, 2] / height
    labels = np.select(
        [z > 0.9, z < 0.1, z < 0.5],
        [0, 1, 2],  # ceiling, floor, lower wall
        default=3,  # upper wall
    ).astype(np.int32)
    if class_colors:
        base = _CLASS_COLOR_BASE[labels]
        noise = rng.uniform(-30, 30, size=(num_points, 3)).astype(np.float32)
        rgb = np.clip(base + noise, 0, 255)
        rgb = np.rint(rgb) if rgb_u8 else rgb
        rgb = rgb.astype(np.float32)
    else:
        rgb = (rng.integers(0, 256, size=(num_points, 3)) if rgb_u8
               else rng.uniform(0, 255, size=(num_points, 3))).astype(np.float32)
    return {"points": np.concatenate([xyz, rgb], axis=1), "labels": labels}


def make_area_dataset(
    out_dir: str,
    areas: tuple[int, ...] = (1, 2, 3, 4, 5, 6),
    rooms_per_area: int = 2,
    points_per_room: int = 2000,
    seed: int = 0,
) -> str:
    """Writes synthetic per-area archives `s3dis{a}.npz` (the monolithic
    room-dataset format, reference datasets.py)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for a in areas:
        rooms = [make_room(rng, points_per_room) for _ in range(rooms_per_area)]
        save_room_archive(
            os.path.join(out_dir, f"s3dis{a}.npz"), rooms, S3DIS_CLASSES
        )
    return out_dir


def make_chunked_dataset(
    out_dir: str,
    areas: tuple[int, ...] = (1, 2, 3, 4, 5, 6),
    rooms_per_area: int = 2,
    chunks_per_area: int = 1,
    points_per_room: int = 2000,
    seed: int = 0,
    with_index: bool = True,
    rgb_u8: bool = False,
    class_colors: bool = False,
) -> str:
    """Writes synthetic chunk archives `s3dis{a}_chunk{c}.npz`."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for a in areas:
        per = max(1, rooms_per_area // chunks_per_area)
        for c in range(1, chunks_per_area + 1):
            rooms = [make_room(rng, points_per_room, rgb_u8=rgb_u8,
                               class_colors=class_colors)
                     for _ in range(per)]
            save_room_archive(
                os.path.join(out_dir, f"s3dis{a}_chunk{c}.npz"),
                rooms,
                S3DIS_CLASSES,
            )
    if with_index:
        precompute_chunk_index(out_dir, force_recompute=True, verbose=False)
    return out_dir


def make_block_dataset(
    out_dir: str,
    areas: tuple[int, ...] = (1, 2, 3, 4, 5, 6),
    rooms_per_area: int = 2,
    points_per_room: int = 2000,
    seed: int = 0,
    rgb_u8: bool = False,
    class_colors: bool = False,
) -> str:
    """Synthetic chunk archives run through the real block preprocessor."""
    chunk_dir = os.path.join(out_dir, "_chunked")
    make_chunked_dataset(
        chunk_dir,
        areas=areas,
        rooms_per_area=rooms_per_area,
        points_per_room=points_per_room,
        seed=seed,
        with_index=False,
        rgb_u8=rgb_u8,
        class_colors=class_colors,
    )
    preprocess_dataset(chunk_dir, out_dir, verbose=False)
    return out_dir


def random_batch(
    rng: np.random.Generator,
    batch_size: int = 8,
    num_points: int = 4096,
    num_classes: int = 14,
    feature_dim: int = 9,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TmpDataset-style random padded batch (points, onehot labels,
    lengths) — the benchmark input."""
    points = rng.normal(size=(batch_size, num_points, feature_dim)).astype(np.float32)
    codes = rng.integers(0, num_classes, size=(batch_size, num_points))
    labels = np.eye(num_classes, dtype=np.uint8)[codes]
    lengths = np.full((batch_size,), num_points, np.int32)
    return points, labels, lengths
