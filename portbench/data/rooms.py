"""The benchmark's training blocks: scanned rooms cut by the S3DIS block rule.

S3DIS points lie on surfaces (floors, ceilings, walls, furniture), about
10,920 of them in an average 1 m x 1 m block (273 M points in 25,000
blocks). The rooms made here are boxes of that kind: a floor, a ceiling,
four walls, doors, windows and boards on the walls, and furniture boxes
(tables, chairs, sofas, bookcases, columns, beams, clutter, now and then
stairs), each point sampled on a surface with a few millimetres of noise,
its colour a byte that follows its class. Each room is then cut by the
frozen block rule (`blocks.py`) and written in the format the port's
`BlockDataset` reads: `area_{a}/room{r:02d}_block{b:03d}.npz` with (N, 9)
float32 `points` and (N, 14) uint8 `labels`.

The set is made once per checkout, from the parameters in its data file
alone (never from a run's seed), into `portbench/.cache/data/<key>/`, key
a digest of those parameters and of this file's generator version. A
`manifest.json` written last lists every block with its point count and
centre; a directory without it is not used.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from portbench.data import blocks

GENERATOR_VERSION = 2
CACHE = Path(__file__).resolve().parent.parent / ".cache" / "data"

# base rgb of each class (S3DIS colour follows the class: white ceilings, grey floors ...)
CLASS_RGB = np.array([
    [232, 230, 224], [118, 104, 92], [196, 190, 178], [170, 160, 150], [205, 200, 192],
    [120, 160, 200], [150, 105, 70], [160, 120, 80], [60, 60, 70], [110, 40, 50],
    [140, 100, 60], [235, 240, 238], [120, 130, 90], [150, 150, 140]], np.float32)
CEILING, FLOOR, WALL, BEAM, COLUMN, WINDOW, DOOR, TABLE, CHAIR, SOFA, BOOKCASE, BOARD, CLUTTER, \
    STAIRS = range(14)


def _rect(origin, u, v, cls):
    return (np.asarray(origin, np.float64), np.asarray(u, np.float64),
            np.asarray(v, np.float64), cls)


def _box(x0, y0, z0, dx, dy, dz, cls):
    """The five faces of a box that a scanner sees (no bottom)."""
    return [
        _rect((x0, y0, z0 + dz), (dx, 0, 0), (0, dy, 0), cls),
        _rect((x0, y0, z0), (dx, 0, 0), (0, 0, dz), cls),
        _rect((x0, y0 + dy, z0), (dx, 0, 0), (0, 0, dz), cls),
        _rect((x0, y0, z0), (0, dy, 0), (0, 0, dz), cls),
        _rect((x0 + dx, y0, z0), (0, dy, 0), (0, 0, dz), cls),
    ]


def _on_wall(rng, lx, ly, width, z0, height, cls, depth=0.0):
    """A rectangle (or a box of `depth`) against one of the four walls."""
    wall = int(rng.integers(0, 4))
    span = lx if wall < 2 else ly
    width = min(width, span - 0.2)
    s = rng.uniform(0.1, max(0.1, span - width - 0.1))
    inset = 0.01
    if depth == 0.0:
        if wall == 0:
            return [_rect((s, inset, z0), (width, 0, 0), (0, 0, height), cls)]
        if wall == 1:
            return [_rect((s, ly - inset, z0), (width, 0, 0), (0, 0, height), cls)]
        if wall == 2:
            return [_rect((inset, s, z0), (0, width, 0), (0, 0, height), cls)]
        return [_rect((lx - inset, s, z0), (0, width, 0), (0, 0, height), cls)]
    if wall == 0:
        return _box(s, inset, z0, width, depth, height, cls)
    if wall == 1:
        return _box(s, ly - inset - depth, z0, width, depth, height, cls)
    if wall == 2:
        return _box(inset, s, z0, depth, width, height, cls)
    return _box(lx - inset - depth, s, z0, depth, width, height, cls)


def _free_box(rng, lx, ly, dx, dy, z0, dz, cls):
    dx, dy = min(dx, lx - 0.1), min(dy, ly - 0.1)
    x0 = rng.uniform(0.05, max(0.05, lx - dx - 0.05))
    y0 = rng.uniform(0.05, max(0.05, ly - dy - 0.05))
    return _box(x0, y0, z0, dx, dy, dz, cls)


def room_surfaces(rng: np.random.Generator, nx: int, ny: int, height: tuple[float, float],
                  furniture: tuple[int, int]):
    """(surfaces, lx, ly) of one room that the block grid cuts into nx x ny
    blocks: its extent lies 0.15-0.45 m short of whole metres."""
    lx = nx - rng.uniform(0.15, 0.45)
    ly = ny - rng.uniform(0.15, 0.45)
    h = rng.uniform(*height)
    s = [
        _rect((0, 0, 0), (lx, 0, 0), (0, ly, 0), FLOOR),
        _rect((0, 0, h), (lx, 0, 0), (0, ly, 0), CEILING),
        _rect((0, 0, 0), (lx, 0, 0), (0, 0, h), WALL),
        _rect((0, ly, 0), (lx, 0, 0), (0, 0, h), WALL),
        _rect((0, 0, 0), (0, ly, 0), (0, 0, h), WALL),
        _rect((lx, 0, 0), (0, ly, 0), (0, 0, h), WALL),
    ]
    s += _on_wall(rng, lx, ly, 0.9, 0.0, 2.05, DOOR)
    if ny > 1:
        for _ in range(int(rng.integers(0, 3))):
            s += _on_wall(rng, lx, ly, rng.uniform(0.8, 1.6), 0.9, 1.2, WINDOW)
        if rng.uniform() < 0.5:
            s += _on_wall(rng, lx, ly, rng.uniform(1.5, 2.5), 0.9, 1.1, BOARD)
        if rng.uniform() < 0.6:
            s += _on_wall(rng, lx, ly, rng.uniform(0.8, 1.6), 0.0, rng.uniform(1.8, 2.2),
                          BOOKCASE, depth=0.35)
        if rng.uniform() < 0.3:
            s += _free_box(rng, lx, ly, 0.4, 0.4, 0.0, h, COLUMN)
        if rng.uniform() < 0.3:
            s += _box(0.0, rng.uniform(0.2, max(0.2, ly - 0.5)), h - 0.4, lx, 0.3, 0.4, BEAM)
        if rng.uniform() < 0.05:
            for i in range(5):
                s += _free_box(rng, lx, ly, 1.0, 0.3, 0.18 * i, 0.18, STAIRS)
        kinds = ((TABLE, (1.2, 1.8), (0.7, 0.9), 0.74), (CHAIR, (0.45, 0.5), (0.45, 0.5), 0.45),
                 (SOFA, (1.6, 2.0), (0.8, 0.9), 0.8), (CLUTTER, (0.1, 0.4), (0.1, 0.4), 0.3))
        for _ in range(int(rng.integers(*furniture))):
            cls, wx, wy, top = kinds[int(rng.choice(4, p=(0.25, 0.4, 0.1, 0.25)))]
            s += _free_box(rng, lx, ly, rng.uniform(*wx), rng.uniform(*wy), 0.0,
                           top * rng.uniform(0.9, 1.1), cls)
    return s, lx, ly


def sample_room(rng: np.random.Generator, surfaces, n_points: int, noise: float):
    """(N, 6) float32 xyz + rgb and (N,) int codes: points on the surfaces
    by area, rgb bytes around each class's colour."""
    areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v, _ in surfaces])
    counts = rng.multinomial(n_points, areas / areas.sum())
    xyz, rgb, codes = [], [], []
    for (origin, u, v, cls), n in zip(surfaces, counts):
        if n == 0:
            continue
        st = rng.uniform(0.0, 1.0, size=(n, 2))
        p = origin + st[:, :1] * u + st[:, 1:] * v + rng.normal(0.0, noise, size=(n, 3))
        tint = rng.normal(0.0, 12.0, size=3)
        c = CLASS_RGB[cls] + tint + rng.normal(0.0, 6.0, size=(n, 3))
        xyz.append(p)
        rgb.append(np.clip(np.rint(c), 0, 255) + 0.0)  # + 0.0: no -0.0, as bytes have none
        codes.append(np.full(n, cls, np.int64))
    points = np.concatenate([np.concatenate(xyz), np.concatenate(rgb)], axis=1)
    return points.astype(np.float32), np.concatenate(codes)


def room_plan(rng: np.random.Generator, total: int, nx_range, ny_range) -> list[tuple[int, int]]:
    """Block grids (nx, ny) of an area's rooms, adding up to `total` blocks:
    offices and conference rooms, and a hallway (n x 1) where what is left
    fits no room."""
    plan, left = [], total
    while left > 0:
        fits = [(x, y) for x in range(nx_range[0], nx_range[1] + 1)
                for y in range(ny_range[0], ny_range[1] + 1)
                if x * y <= left and (left - x * y == 0 or left - x * y >= 3)]
        nxy = fits[int(rng.integers(0, len(fits)))] if fits else (left, 1)
        plan.append(nxy)
        left -= nxy[0] * nxy[1]
    return plan


def dataset_key(params: dict) -> str:
    text = json.dumps({"params": params, "version": GENERATOR_VERSION}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def generate(params: dict, out: Path) -> dict:
    """Writes the blocks into `out`; returns the manifest."""
    rng = np.random.default_rng(params["generator_seed"])
    rows = []
    for area in params["areas"]:
        plan = room_plan(rng, params["blocks_per_area"], params["room_blocks_x"],
                         params["room_blocks_y"])
        area_dir = out / f"area_{area}"
        area_dir.mkdir(parents=True)
        for room, (nx, ny) in enumerate(plan, start=1):
            surfaces, _, _ = room_surfaces(rng, nx, ny, tuple(params["height_m"]),
                                           tuple(params["furniture_per_room"]))
            pts, codes = sample_room(rng, surfaces, params["points_per_block"] * nx * ny,
                                     params["noise_m"])
            written = 0
            for index, p9, labels in blocks.cut_room(pts, codes):
                np.savez(area_dir / f"room{room:02d}_block{index:03d}.npz", points=p9,
                         labels=labels)
                center = (p9[0, :3] - p9[0, 6:]).tolist()
                rows.append([area, room, index, int(p9.shape[0])] + center)
                written += 1
            if written != nx * ny:
                raise RuntimeError(f"room {area}/{room}: {written} blocks, planned {nx * ny}")
    return {"params": params, "version": GENERATOR_VERSION, "blocks": rows}


def ensure_dataset(params: dict, log=print) -> tuple[Path, dict]:
    """(directory, manifest) of the data set, made on a miss. Processes
    that start at once take turns on a lock: the first makes it."""
    key = dataset_key(params)
    target = CACHE / key
    manifest_path = target / "manifest.json"
    if manifest_path.exists():
        log(f"setup: data cache hit ({target})")
        return target, json.loads(manifest_path.read_text())
    CACHE.mkdir(parents=True, exist_ok=True)
    with open(CACHE / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not manifest_path.exists():
            log(f"setup: data cache miss, generating {target}")
            stage = CACHE / f"{key}.partial"
            shutil.rmtree(stage, ignore_errors=True)
            shutil.rmtree(target, ignore_errors=True)
            manifest = generate(params, stage)
            (stage / "manifest.json").write_text(json.dumps(manifest))
            os.replace(stage, target)
        else:
            log(f"setup: data cache hit ({target})")
    return target, json.loads(manifest_path.read_text())
