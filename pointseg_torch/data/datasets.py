"""Datasets and host-side loaders (the port's copy of
`pointseg/data/datasets.py`; numpy only, and it yields the same batches
from the same seed).

Rebuilds the reference's L2 layer (data_processing/block_datasets.py,
chunked_datasets.py, datasets.py) without torch:

- `BlockDataset` — per-block files, filename-parsed (area, room, block)
  index, optional fixed-size random sampling (randperm when N > k,
  with-replacement randint otherwise — reference block_datasets.py:119-128).
- `collate_blocks` — zero-pads points/labels and returns lengths
  (reference block_datasets.py:5-29), EXTENDED with static padding:
  instead of padding to the batch max (a new shape every batch),
  batches pad to a fixed budget or to bucketed sizes, so a step sees
  few distinct shapes (SURVEY.md §7 step 1).
- `Loader` — batching + shuffling + background thread prefetch, the
  stand-in for torch DataLoader worker processes (the reference's only
  parallelism, SURVEY.md §2). Short partial batches are padded with
  zero-length samples (masked out of loss/metrics by construction).
- `ChunkedRoomDataset` — whole-room samples from chunk archives with
  the precomputed-index / on-the-fly-index behaviors of
  chunked_datasets.py:35-163; returns dicts {'x', 'y', 'area',
  'room_idx'} with string labels for the legacy stack.

Reads both this framework's `.npz` blocks and the reference's `.pt`
blocks (torch, gated import) for drop-in data compatibility.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Iterator, Sequence

import numpy as np

from pointseg_torch.data.prepare import (
    INDEX_FILENAME,
    load_room_archive,
    room_archive_len,
)
from pointseg_torch.data.s3dis import NUM_S3DIS_CLASSES, POINT_FEATURE_DIM

_BLOCK_RE = re.compile(r"room(\d+)_block(\d+)\.(npz|pt)$")


def _load_block_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return z["points"], z["labels"]
    # reference-format .pt block (torch.save tuple) — optional torch dep
    import torch  # noqa: PLC0415

    points, labels = torch.load(path, map_location="cpu", weights_only=False)
    return points.numpy(), labels.numpy()


class BlockDataset:
    """The S3DIS dataset split into 1m x 1m blocks
    (reference block_datasets.py:33-130)."""

    def __init__(
        self,
        data_dir: str,
        included_areas: set[int],
        sampling: int | None = None,
        seed: int = 0,
    ):
        if not os.path.exists(data_dir):
            raise FileNotFoundError(f'Data directory "{data_dir}" does not exist.')
        if any(a < 1 or a > 6 for a in included_areas):
            raise ValueError(
                f"Included areas can only contain values from the range [1, 6], "
                f"got {included_areas}."
            )
        self.data_dir = data_dir
        self.sampling = sampling
        self._rng = np.random.default_rng(seed)
        # __getitem__ runs concurrently under Loader(num_workers>1);
        # numpy Generators are not thread-safe, so index draws serialize
        self._rng_lock = threading.Lock()
        self.blocks: list[tuple[int, int, int, str]] = []
        for a in sorted(included_areas):
            area_dir = os.path.join(data_dir, f"area_{a}")
            if not os.path.exists(area_dir):
                raise FileNotFoundError(f"Directory for area {a} does not exist.")
            entries = []
            for fn in os.listdir(area_dir):
                m = _BLOCK_RE.match(fn)
                if m:
                    entries.append((a, int(m.group(1)), int(m.group(2)), fn))
            if not entries:
                raise FileNotFoundError(
                    f"Directory for area {a} does not contain any blocks."
                )
            entries.sort()
            self.blocks.extend(entries)

    def __len__(self) -> int:
        return len(self.blocks)

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        a, _, _, fn = self.blocks[index]
        points, labels = _load_block_file(
            os.path.join(self.data_dir, f"area_{a}", fn)
        )
        if self.sampling is not None:
            n = points.shape[0]
            with self._rng_lock:
                if n > self.sampling:
                    idx = self._rng.permutation(n)[: self.sampling]
                else:
                    idx = self._rng.integers(0, n, size=self.sampling)
            points, labels = points[idx], labels[idx]
        return points.astype(np.float32), labels.astype(np.uint8)


def _round_up_to_bucket(n: int, buckets: Sequence[int] | None, multiple: int) -> int:
    if buckets:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]
    return ((n + multiple - 1) // multiple) * multiple


def collate_blocks(
    batch: list[tuple[np.ndarray, np.ndarray]],
    pad_to: int | None = None,
    buckets: Sequence[int] | None = None,
    pad_multiple: int = 512,
    num_classes: int = NUM_S3DIS_CLASSES,
    batch_size: int | None = None,
    pad_mode: str = "zero",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pads a batch (reference block_datasets.py:5-29) to a static
    shape: `pad_to` wins, else the smallest bucket >= batch max, else
    batch max rounded up to `pad_multiple`. Short batches are filled
    with zero-length rows when `batch_size` is given.

    pad_mode:
      "zero"   — the reference's semantics (zeros after the real points).
                 Safe when padding is small (the reference pads only to
                 the batch max), but heavy static padding plants a huge
                 duplicate-point cluster at the origin that shifts every
                 BatchNorm input distribution: measured -60 OA points on
                 bucket-padded whole-block eval (see
                 PARITY.md).
      "repeat" — pad by cyclically repeating the block's own points
                 (with their labels). Padding stays in-distribution, so
                 static bucket shapes don't distort neighborhoods;
                 metrics/loss still mask to the true `lengths`, so
                 reported numbers cover exactly the real points.
    """
    n_max = max(p.shape[0] for p, _ in batch)
    n_pad = pad_to if pad_to is not None else _round_up_to_bucket(
        n_max, buckets, pad_multiple
    )
    if n_pad < n_max:
        # truncation would silently drop labeled points; pad_to must cover
        raise ValueError(f"pad_to={n_pad} smaller than batch max {n_max}")
    if pad_mode not in ("zero", "repeat"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    b_pad = batch_size if batch_size is not None else len(batch)

    points = np.zeros((b_pad, n_pad, POINT_FEATURE_DIM), np.float32)
    labels = np.zeros((b_pad, n_pad, num_classes), np.uint8)
    lengths = np.zeros((b_pad,), np.int32)
    for i, (p, l) in enumerate(batch):
        n = p.shape[0]
        points[i, :n] = p
        labels[i, :n] = l
        lengths[i] = n
        if pad_mode == "repeat" and n and n < n_pad:
            reps = np.resize(np.arange(n), n_pad - n)  # cyclic indices
            points[i, n:] = p[reps]
            labels[i, n:] = np.asarray(l)[reps]
    return points, labels, lengths


class Loader:
    """Minimal host loader: shuffle, batch, collate, thread-prefetch.

    Yields (points, labels, lengths) numpy batches with static shapes.
    Replaces torch DataLoader + pinned memory (reference
    block_datasets.py:166-181): the prefetch thread overlaps host
    block reads with device compute.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_to: int | None = None,
        buckets: Sequence[int] | None = None,
        num_classes: int = NUM_S3DIS_CLASSES,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        pad_mode: str = "zero",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to = pad_to
        self.buckets = tuple(buckets) if buckets else None
        self.num_classes = num_classes
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.pad_mode = pad_mode
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        out = []
        for s in range(0, len(order), self.batch_size):
            idx = order[s : s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            out.append(idx)
        return out

    def _collate(self, samples):
        return collate_blocks(
            samples,
            pad_to=self.pad_to,
            buckets=self.buckets,
            num_classes=self.num_classes,
            batch_size=self.batch_size,
            pad_mode=self.pad_mode,
        )

    def _batches(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        batches = self._batch_indices()
        if self.num_workers <= 1:
            for idx in batches:
                yield self._collate([self.dataset[int(i)] for i in idx])
            return
        # Parallel block reads: per-sample futures submitted for a
        # sliding window of upcoming batches, so np.load + inflate of
        # the next batches overlaps this batch's collate/consume (one
        # serial reader cannot sustain the step rate).
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ahead = max(2, self.prefetch + 1)
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            window: deque = deque()
            it = iter(batches)

            def submit_next():
                idx = next(it, None)
                if idx is not None:
                    window.append(
                        [ex.submit(self.dataset.__getitem__, int(i)) for i in idx]
                    )

            for _ in range(ahead):
                submit_next()
            while window:
                futures = window.popleft()
                submit_next()
                yield self._collate([f.result() for f in futures])
            ex.shutdown(wait=True)
        except BaseException:
            # abandoned mid-epoch (consumer break / error): don't wait for
            # the in-flight read window — cancel it and reap the threads so
            # nothing lingers to contend with the training process
            ex.shutdown(wait=False, cancel_futures=True)
            raise

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def worker():
            try:
                batches = self._batches()
                try:
                    for item in batches:
                        # bounded put so an abandoned consumer (e.g. a
                        # benchmark breaking at max_batches) can't strand
                        # this thread on a full queue forever
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                finally:
                    batches.close()  # reap _batches' executor promptly
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                # the sentinel MUST reach a live consumer: a full queue
                # here can simply mean the consumer is still draining
                # (short epochs fill prefetch before the first get), so
                # keep trying until delivered or the consumer abandoned
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()


def create_block_dataloaders(
    data_dir: str,
    test_areas: set[int],
    train_batch_size: int = 4,
    test_batch_size: int = 4,
    train_sampling: int | None = 4096,
    test_sampling: int | None = None,
    train_shuffle: bool = True,
    test_shuffle: bool = False,
    test_pad_to: int | None = None,
    test_buckets: Sequence[int] | None = None,
    seed: int = 0,
    num_workers: int = 0,
    test_pad_mode: str = "repeat",
) -> tuple[Loader, Loader]:
    """Train/test loaders split by area (reference block_datasets.py:133-183).
    Train pads to exactly `train_sampling`; test uses buckets (or a fixed
    `test_pad_to`) so eval shapes stay out of the recompile loop."""
    areas = {1, 2, 3, 4, 5, 6}
    train_ds = BlockDataset(data_dir, areas - set(test_areas), train_sampling, seed)
    test_ds = BlockDataset(data_dir, set(test_areas), test_sampling, seed + 1)
    train = Loader(
        train_ds,
        train_batch_size,
        shuffle=train_shuffle,
        drop_last=False,
        pad_to=train_sampling,
        seed=seed,
        num_workers=num_workers,
    )
    test = Loader(
        test_ds,
        test_batch_size,
        shuffle=test_shuffle,
        pad_to=test_pad_to if test_sampling is None else test_sampling,
        buckets=test_buckets,
        seed=seed + 1,
        num_workers=num_workers,
        pad_mode=test_pad_mode,
    )
    return train, test


class RoomDataset:
    """Monolithic room-level dataset over per-area archives
    (reference data_processing/datasets.py:11-122): one `s3dis{a}.npz`
    per area, lazy per-item loads or full in-memory cache, and an index
    cache `s3dis_index_mapping.json` = {area: num_rooms} so init never
    reads the big archives (the reference even has a >1GB lite-
    interpreter metadata path, datasets.py:68-72 — npz headers make
    room counts free here)."""

    INDEX_FILENAME = "s3dis_index_mapping.json"

    def __init__(
        self,
        path: str,
        area_indices: Sequence[int] | None = None,
        load_in_memory: bool = False,
        use_cached_index: bool = True,
    ):
        self.path = path
        self.area_indices = list(area_indices or range(1, 7))
        self.load_in_memory = load_in_memory
        self._cache: dict[int, list[dict]] = {}
        self._last: tuple[int, list[dict]] | None = None
        self._classes: list[str] | None = None

        index_file = os.path.join(path, self.INDEX_FILENAME)
        counts: dict[int, int] = {}
        if use_cached_index and os.path.exists(index_file):
            with open(index_file) as f:
                counts = {int(k): int(v) for k, v in json.load(f).items()}
        else:
            for a in range(1, 7):
                p = self._area_file(a)
                if p is None:
                    continue
                counts[a] = room_archive_len(p)
            if use_cached_index:
                with open(index_file, "w") as f:
                    json.dump(counts, f)

        self.index_mapping = [
            (a, r)
            for a in self.area_indices
            if a in counts
            for r in range(counts[a])
        ]
        if load_in_memory:
            for a in set(a for a, _ in self.index_mapping):
                self._load_area(a)

    def _area_file(self, a: int) -> str | None:
        """Per-area archive path: this framework's `.npz`, else a
        reference-prepared `.pt` (data_processing/datasets.py:114-116)."""
        for ext in (".npz", ".pt"):
            p = os.path.join(self.path, f"s3dis{a}{ext}")
            if os.path.exists(p):
                return p
        return None

    def _load_area(self, a: int) -> list[dict]:
        if a in self._cache:
            return self._cache[a]
        if self._last is not None and self._last[0] == a:
            return self._last[1]
        rooms, classes = load_room_archive(
            self._area_file(a) or os.path.join(self.path, f"s3dis{a}.npz")
        )
        self._classes = classes
        if self.load_in_memory:
            self._cache[a] = rooms
        else:
            # one-entry LRU (see ChunkedRoomDataset._load_chunk)
            self._last = (a, rooms)
        return rooms

    @property
    def classes(self) -> list[str]:
        if self._classes is None and self.index_mapping:
            a = self.index_mapping[0][0]
            p = self._area_file(a)
            if p is not None and p.endswith(".npz"):
                # header-only read; .pt needs a full unpickle
                with np.load(p, allow_pickle=False) as z:
                    self._classes = [str(c) for c in z["classes"]]
            else:
                self._load_area(a)
        return self._classes or []

    def __len__(self) -> int:
        return len(self.index_mapping)

    def __getitem__(self, idx: int) -> dict:
        a, r = self.index_mapping[idx]
        rooms = self._load_area(a)
        room = rooms[r]
        # .pt rooms carry their own vocab (archives may differ)
        classes = room.get("classes") or self.classes
        return {
            "x": room["points"].astype(np.float32),
            "y": [classes[c] for c in room["labels"]],
            "area": a,
            "room_idx": r,
        }


def create_s3dis_dataloaders(
    data_path: str,
    batch_size: int = 1,
    load_in_memory: bool = False,
    use_cached_index: bool = True,
    seed: int = 0,
) -> tuple["ListLoader", "ListLoader"]:
    """Train areas 1-5 / test area 6 over the monolithic room dataset
    (reference datasets.py:125-161)."""
    train = RoomDataset(data_path, [1, 2, 3, 4, 5], load_in_memory, use_cached_index)
    test = RoomDataset(data_path, [6], load_in_memory, use_cached_index)
    return (
        ListLoader(train, batch_size, shuffle=True, seed=seed),
        ListLoader(test, batch_size, shuffle=False, seed=seed),
    )


class ChunkedRoomDataset:
    """Whole-room dataset over chunk archives
    (reference chunked_datasets.py:35-163)."""

    def __init__(
        self,
        path: str,
        area_indices: Sequence[int] | None = None,
        load_in_memory: bool = False,
        require_index_file: bool = True,
    ):
        self.path = path
        self.area_indices = list(area_indices or range(1, 7))
        self.load_in_memory = load_in_memory
        self._cache: dict[int, list[dict]] = {}
        self._last: tuple[int, list[dict]] | None = None
        self._classes: list[str] | None = None

        index_file = os.path.join(path, INDEX_FILENAME)
        # the reference writes its chunk index as a pickle
        # (chunked_datasets.py:55, precompute_chunk_index.py) — accept it
        # so reference-prepared directories work unmodified
        ref_index_file = os.path.join(path, "chunked_s3dis_index_mapping.pkl")
        cached = None
        if os.path.exists(index_file):
            with open(index_file) as f:
                cached = json.load(f)
        elif os.path.exists(ref_index_file):
            import pickle  # noqa: PLC0415

            with open(ref_index_file, "rb") as f:
                cached = pickle.load(f)
            cached["chunk_files"] = [
                str(name).replace("\\", "/") for name in cached["chunk_files"]
            ]
        if cached is not None:
            self.chunk_files = []
            remap = {}
            for i, name in enumerate(cached["chunk_files"]):
                area = int(os.path.basename(name).split("_")[0].replace("s3dis", ""))
                if area in self.area_indices:
                    remap[i] = len(self.chunk_files)
                    self.chunk_files.append(os.path.join(path, os.path.basename(name)))
            self.index_mapping = [
                (remap[ci], ri) for ci, ri in cached["index_mapping"] if ci in remap
            ]
        elif require_index_file:
            raise FileNotFoundError(
                f"Index file {index_file} not found. Run precompute_chunk_index "
                f"first or set require_index_file=False."
            )
        else:
            self._build_index_on_the_fly()

        if load_in_memory:
            for ci in range(len(self.chunk_files)):
                self._load_chunk(ci)

    def _build_index_on_the_fly(self):
        self.chunk_files = []
        for a in self.area_indices:
            names = sorted(
                f for f in os.listdir(self.path)
                if f.startswith(f"s3dis{a}_chunk")
                and (f.endswith(".npz") or f.endswith(".pt"))
            )
            self.chunk_files.extend(os.path.join(self.path, n) for n in names)
        self.index_mapping = []
        for ci, cf in enumerate(self.chunk_files):
            self.index_mapping.extend(
                (ci, ri) for ri in range(room_archive_len(cf))
            )

    def _load_chunk(self, ci: int) -> list[dict]:
        if ci in self._cache:
            return self._cache[ci]
        if self._last is not None and self._last[0] == ci:
            return self._last[1]
        rooms, classes = load_room_archive(self.chunk_files[ci])
        self._classes = classes
        if self.load_in_memory:
            self._cache[ci] = rooms
        else:
            # one-entry LRU: consecutive same-chunk accesses (the common
            # pattern) skip the full-archive decompression
            self._last = (ci, rooms)
        return rooms

    @property
    def classes(self) -> list[str]:
        if self._classes is None and self.chunk_files:
            cf = self.chunk_files[0]
            if cf.endswith(".npz"):
                with np.load(cf, allow_pickle=False) as z:
                    self._classes = [str(c) for c in z["classes"]]
            else:
                self._load_chunk(0)
        return self._classes or []

    def __len__(self) -> int:
        return len(self.index_mapping)

    def __getitem__(self, idx: int) -> dict:
        ci, ri = self.index_mapping[idx]
        rooms = self._load_chunk(ci)
        room = rooms[ri]
        area = int(
            os.path.basename(self.chunk_files[ci]).split("_")[0].replace("s3dis", "")
        )
        # .pt rooms carry their own vocab (archives may differ)
        classes = room.get("classes") or self.classes
        return {
            "x": room["points"].astype(np.float32),
            "y": [classes[c] for c in room["labels"]],
            "area": area,
            "room_idx": ri,
        }


class ListLoader:
    """List-collated loader for the legacy/chunked stack: batches are
    dicts of lists (reference custom_collate_fn,
    chunked_datasets.py:10-32)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            samples = [self.dataset[int(i)] for i in order[s : s + self.batch_size]]
            batch = {
                "x": [d["x"] for d in samples],
                "y": [d["y"] for d in samples],
                "area": np.array([d["area"] for d in samples]),
                "room_idx": np.array([d["room_idx"] for d in samples]),
            }
            yield batch


def create_chunked_dataloaders(
    data_path: str,
    batch_size: int = 1,
    load_in_memory: bool = False,
    require_index_file: bool = True,
    seed: int = 0,
) -> tuple[ListLoader, ListLoader]:
    """Train areas 1-5, test area 6 (reference chunked_datasets.py:166-204)."""
    train = ChunkedRoomDataset(
        data_path, [1, 2, 3, 4, 5], load_in_memory, require_index_file
    )
    test = ChunkedRoomDataset(data_path, [6], load_in_memory, require_index_file)
    return (
        ListLoader(train, batch_size, shuffle=True, seed=seed),
        ListLoader(test, batch_size, shuffle=False, seed=seed),
    )
