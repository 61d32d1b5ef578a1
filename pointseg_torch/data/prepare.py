"""Offline ETL, stage 1-3: raw S3DIS text -> per-area room archives ->
chunk files -> chunk index.

The port's copy of `pointseg/data/prepare.py` (numpy only). Rebuilds the
reference's L1 pipeline with a compact on-disk format:

- `prepare_s3dis`  (reference data_processing/prepare_s3dis.py:17-41):
  walks `Area_*/room/Annotations/*.txt`, parses `x y z r g b` lines,
  drops malformed lines (len != 6), skips `.DS_Store` artifacts, and
  discovers the label vocabulary dynamically. Output is one
  `s3dis{a}.npz` per area holding flat arrays per room (points f32,
  int32 label codes) plus the vocabulary — instead of pickled
  lists-of-lists (~10x smaller, zero-copy mmap reads, no pickle).

- `split_chunks`   (reference split_s3dis_data.py:7-56): splits each
  area archive into `n_chunks` chunk files of ceil(rooms/n) rooms,
  1-based chunk ids.

- `precompute_chunk_index` (reference precompute_chunk_index.py:8-60):
  scans chunk files once and writes `chunked_index.json` with
  {chunk_files, index_mapping=[(chunk_idx, room_idx)]}; `force`
  recomputes. JSON instead of pickle: inspectable, no arbitrary-code
  deserialization.
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence

import numpy as np

INDEX_FILENAME = "chunked_index.json"


def _parse_annotation_file(path: str) -> np.ndarray:
    """Parses one annotation txt of `x y z r g b` rows; drops malformed
    lines exactly like the reference (prepare_s3dis.py:32-34). Uses the
    native C++ parser (pointseg_torch.data.native) when available; this pure-
    Python loop is the fallback and the test oracle."""
    from pointseg_torch.data import native

    parsed = native.parse_annotation_file(path)
    if parsed is not None:
        return parsed

    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 6:
                continue
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
    if not rows:
        return np.zeros((0, 6), np.float32)
    return np.asarray(rows, dtype=np.float32)


def save_room_archive(path: str, rooms: list[dict], classes: list[str]) -> None:
    """Writes rooms to one npz: points_{i} (N,6) f32, labels_{i} (N,) i32."""
    arrays = {"num_rooms": np.int32(len(rooms)), "classes": np.array(classes)}
    for i, room in enumerate(rooms):
        arrays[f"points_{i}"] = room["points"].astype(np.float32)
        arrays[f"labels_{i}"] = room["labels"].astype(np.int32)
    np.savez_compressed(path, **arrays)


def load_room_archive(path: str) -> tuple[list[dict], list[str]]:
    """Reads a room archive: this framework's `.npz` or a reference `.pt`.

    Reference `.pt` area/chunk archives (data_processing/prepare_s3dis.py
    output, consumed at datasets.py:104-123 / chunked_datasets.py:139-162)
    are torch pickles of [{'x': (N,6) tensor-or-list, 'y': [str, ...]}].
    String labels are interned against a per-archive vocabulary in
    encounter order; each room carries its own 'classes' so mixed-vocab
    archives stay self-consistent.
    """
    if path.endswith(".pt"):
        import torch  # noqa: PLC0415 — optional, only for reference data

        raw = torch.load(path, map_location="cpu", weights_only=False)
        vocab: list[str] = []
        index: dict[str, int] = {}
        rooms = []
        for room in raw:
            x = room["x"]
            points = (
                x.numpy() if hasattr(x, "numpy") else np.asarray(x)
            ).astype(np.float32)
            labels = np.empty((len(room["y"]),), np.int32)
            for i, name in enumerate(room["y"]):
                name = str(name)
                if name not in index:
                    index[name] = len(vocab)
                    vocab.append(name)
                labels[i] = index[name]
            rooms.append({"points": points, "labels": labels, "classes": vocab})
        return rooms, vocab

    with np.load(path, allow_pickle=False) as z:
        n = int(z["num_rooms"])
        classes = [str(c) for c in z["classes"]]
        rooms = [
            {"points": z[f"points_{i}"], "labels": z[f"labels_{i}"]}
            for i in range(n)
        ]
    return rooms, classes


def room_archive_len(path: str) -> int:
    """Number of rooms in an archive without materializing the points
    (npz header read; `.pt` requires a full unpickle)."""
    if path.endswith(".pt"):
        return len(load_room_archive(path)[0])
    with np.load(path, allow_pickle=False) as z:
        return int(z["num_rooms"])


def prepare_s3dis(
    input_dir: str,
    output_dir: str,
    classes: Sequence[str] | None = None,
    verbose: bool = True,
) -> list[str]:
    """Raw S3DIS annotation tree -> per-area `s3dis{a}.npz` archives.

    Args:
        input_dir: directory holding `Area_*/room/Annotations/*.txt`.
        output_dir: where `s3dis{a}.npz` files are written.
        classes: fixed label vocabulary; None discovers it dynamically
            in encounter order (the reference behavior,
            prepare_s3dis.py:26-28).

    Returns:
        the final label vocabulary.
    """
    os.makedirs(output_dir, exist_ok=True)
    vocab: list[str] = list(classes) if classes is not None else []
    dynamic = classes is None

    areas = sorted(
        d for d in os.listdir(input_dir)
        if ".DS" not in d and os.path.isdir(os.path.join(input_dir, d))
    )
    for area_i, area in enumerate(areas, start=1):
        rooms = []
        area_path = os.path.join(input_dir, area)
        for room in sorted(os.listdir(area_path)):
            ann = os.path.join(area_path, room, "Annotations")
            if ".DS" in room or not os.path.isdir(ann):
                continue
            pts_list, lab_list = [], []
            for obj in sorted(os.listdir(ann)):
                if ".DS" in obj:
                    continue
                label = obj.split("_")[0]
                if label not in vocab:
                    if dynamic:
                        vocab.append(label)
                    else:
                        raise ValueError(f"Unknown label '{label}' in {obj}")
                pts = _parse_annotation_file(os.path.join(ann, obj))
                if pts.shape[0]:
                    pts_list.append(pts)
                    lab_list.append(
                        np.full(pts.shape[0], vocab.index(label), np.int32)
                    )
            if pts_list:
                rooms.append(
                    {
                        "points": np.concatenate(pts_list),
                        "labels": np.concatenate(lab_list),
                    }
                )
        out = os.path.join(output_dir, f"s3dis{area_i}.npz")
        save_room_archive(out, rooms, vocab)
        if verbose:
            print(f"{area_i} / {len(areas)}: {len(rooms)} rooms -> {out}")
    return vocab


def split_chunks(
    input_dir: str, output_dir: str, n_chunks: int = 10, verbose: bool = True
) -> None:
    """Splits each `s3dis{a}.npz` into `s3dis{a}_chunk{c}.npz` files of
    ceil(total/n) rooms each, chunk ids 1-based (reference
    split_s3dis_data.py:22-49)."""
    os.makedirs(output_dir, exist_ok=True)
    for a in range(1, 7):
        src = os.path.join(input_dir, f"s3dis{a}.npz")
        if not os.path.exists(src):
            continue
        rooms, classes = load_room_archive(src)
        per = math.ceil(len(rooms) / n_chunks) if rooms else 0
        written = 0
        for c in range(n_chunks):
            part = rooms[c * per:(c + 1) * per]
            if not part:
                break
            save_room_archive(
                os.path.join(output_dir, f"s3dis{a}_chunk{c + 1}.npz"),
                part,
                classes,
            )
            written += 1
        if verbose:
            print(f"area {a}: {len(rooms)} rooms -> {written} chunks")


def precompute_chunk_index(
    data_path: str, force_recompute: bool = False, verbose: bool = True
) -> str:
    """Builds `chunked_index.json` over `s3dis{1..6}_chunk*.npz`
    (reference precompute_chunk_index.py:8-60)."""
    index_path = os.path.join(data_path, INDEX_FILENAME)
    if os.path.exists(index_path) and not force_recompute:
        if verbose:
            print(f"Index already exists at {index_path} (use force to rebuild)")
        return index_path

    chunk_files = []
    for a in range(1, 7):
        names = sorted(
            f for f in os.listdir(data_path)
            if f.startswith(f"s3dis{a}_chunk") and f.endswith(".npz")
        )
        chunk_files.extend(os.path.join(data_path, n) for n in names)

    index_mapping = []
    for ci, cf in enumerate(chunk_files):
        try:
            with np.load(cf, allow_pickle=False) as z:
                n = int(z["num_rooms"])
        except Exception as e:  # keep scanning, like the reference (:38-49)
            if verbose:
                print(f"warning: failed to read {cf}: {e}")
            continue
        index_mapping.extend((ci, ri) for ri in range(n))

    with open(index_path, "w") as f:
        json.dump(
            {
                "chunk_files": [os.path.basename(c) for c in chunk_files],
                "index_mapping": index_mapping,
            },
            f,
        )
    if verbose:
        print(f"Wrote {index_path}: {len(chunk_files)} chunks, {len(index_mapping)} rooms")
    return index_path
