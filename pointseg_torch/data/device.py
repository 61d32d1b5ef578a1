"""Device-resident block store with on-device batch sampling (port of
`pointseg/data/device.py`).

The host loaders of `pointseg_torch.data.datasets` re-read and re-sample
block files every epoch and copy each batch to the device. This module
keeps the ENTIRE training split resident in device memory and performs
block choice + within-block point sampling + one-hot encoding there, so
steady-state training does no per-step host I/O and no per-step host to
device copy.

Layout: blocks are stored flat, `points (T, 9)` / `labels (T,)` with
per-block `offsets (M,)` / `counts (M,)`: no padding waste, so the
device cost is exactly the dataset size (S3DIS total is about 273M
points: 9.8 GB of float32 rows and 0.27 GB of labels).
`CompactDeviceStore` packs the canonical S3DIS block format into 16
bytes a point (xyz float32 bits + rgb/label bytes in one 32-bit word,
per-block centers separate), 4.4 GB for all of S3DIS, and reconstructs
the 9 features inside the sampler, bit-identical to the flat store.
`device_store_or_host_loader` tries flat -> compact -> chunked host
prefetcher, in that order, so training input adapts to the memory the
card has free of the model's own workspace.

Every gather from a per-point table (`points`, `labels`, `packed`) is
`pointseg_torch.ops.gather.gather_rows_flat`: one launch of the flat
CUDA gather kernel on the card (two a batch for the flat store, one for
the compact store), `index_select` on the CPU. The per-block lookups of
B entries (`offsets`, `counts`, `centers`) are plain indexing.

Sampling semantics: the reference samples `randperm(n)[:k]` when a
block has more than k points and `randint(0, n, k)` otherwise. The
stores use with-replacement `floor(u * n)` sampling for every block,
identical in expectation to the reference's short-block branch; the
host `BlockDataset` path keeps the exact reference semantics.

Random streams: each sampler is split into a deterministic core, which
takes the batch's block ids and the uniforms `u (B, npoints)` as
arguments (the tests feed it the numbers the JAX package drew), and a
thin wrapper that draws them from an explicit `torch.Generator` on the
store's device. An epoch's generator is seeded from `(seed, epoch)`
alone, so `DeviceEpochLoader.__iter__` and `scan_epoch` see the same
batches. PyTorch and JAX draw different numbers from the same seed.

Epoch structure mirrors the reference loader: one device-side
permutation of the block ids per epoch, consumed batch by batch; short
final batches are filled with id -1 rows that come back with length 0
(masked out of loss and metrics by the static-shape convention).

Nothing on the per-step path reads a device value on the host: the step
counter is a Python int, and masks are applied with `where`, never by
boolean indexing.

Row-sharded stores (`mesh=`, the JAX package's `sharding=NamedSharding(
mesh, P("data"))`): each rank of the mesh's data axis holds rows
[r T/n, (r+1) T/n) of the flat or packed tables, T divisible by n; the
per-block tables (`offsets`, `counts`, `centers`) are whole on every
rank. `sample()` gives every rank the whole batch, bit-equal to the
unsharded store's: each rank gathers the rows it holds with the flat
gather kernel on local indices, writes zeros in the others, and one int32
all-reduce (float32 points as their bits) assembles the batch
(`_assemble`); `parallel.shard_batch` then takes a rank's data rows.
Every rank must draw the same epoch order and uniforms (generators
seeded alike).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import queue
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from pointseg_torch.data.s3dis import BLOCK_SIZE, NUM_S3DIS_CLASSES
from pointseg_torch.ops.gather import gather_rows_flat
from pointseg_torch.parallel.mesh import Mesh, all_reduce_
from pointseg_torch.utils.trace import span


class NotPackableError(ValueError):
    """The block table is not exactly representable in the compact
    16-byte/point layout (non-u8 rgb, >255 classes, or rel coords that
    are not the IEEE f32 difference xyz - per-block-center)."""


def _exclusive_cumsum(counts: np.ndarray) -> np.ndarray:
    offsets = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=offsets[1:])
    return offsets


def pack_block_table(
    points: np.ndarray, labels: np.ndarray, counts: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Packs a canonical 9-feature block table into 16 bytes/point.

    Input: `points` (T, 9) f32 rows `[xyz, rgb, xyz - center]` (the
    block preprocessor's format, `pointseg_torch/data/blocks.py::augment_points`),
    `labels` (T,) ints, `counts` (M,) points per block. Output:

    - `packed` (T, 4) u32: the xyz f32 BIT PATTERNS (words 0-2) and
      `(r<<24)|(g<<16)|(b<<8)|label` (word 3);
    - `centers` (M, 3) f32 per-block centers.

    The packing is verified EXACT before returning: rgb must be integer
    0-255 (true for real S3DIS, whose colors are u8), labels must fit a
    byte, and `xyz - center` must reproduce the stored rel coords
    bit-for-bit (IEEE f32 subtraction is deterministic, so the device
    recompute matches too). Raises NotPackableError otherwise; callers
    fall back to the flat f32 store or the host loader.
    """
    points = np.ascontiguousarray(points, np.float32)
    labels = np.asarray(labels)
    counts = np.asarray(counts, np.int64)
    if points.ndim != 2 or points.shape[1] != 9:
        raise NotPackableError(
            f"compact store needs (T, 9) block features, got {points.shape}")
    if counts.sum() != points.shape[0]:
        raise ValueError("counts do not sum to the table length")
    if (counts <= 0).any():
        raise ValueError("compact store requires non-empty blocks")
    offsets = _exclusive_cumsum(counts)

    rgb = points[:, 3:6]
    if rgb.size and (
        (rgb < 0).any() or (rgb > 255).any() or (rgb != np.round(rgb)).any()
    ):
        raise NotPackableError("rgb features are not exact u8 values")
    lab = labels.astype(np.int64)
    if lab.size and (lab.min() < 0 or lab.max() > 255):
        raise NotPackableError("labels do not fit one byte")

    xyz = np.ascontiguousarray(points[:, :3])
    rel = np.ascontiguousarray(points[:, 6:9])

    # Candidate centers: (a) the preprocessor's formula recomputed from
    # each block's own points with the identical f32 op sequence
    # (augment_points: min + B/2 on x/y, min + (max-min)/2 on z);
    # (b) derived from the first point (covers foreign preprocessors
    # whose stored center the formula doesn't reproduce).
    mins = np.minimum.reduceat(xyz, offsets, axis=0)
    maxz = np.maximum.reduceat(xyz[:, 2], offsets)
    half = np.float32(BLOCK_SIZE / 2)
    formula = np.stack(
        [mins[:, 0] + half, mins[:, 1] + half,
         mins[:, 2] + (maxz - mins[:, 2]) / 2], axis=1)
    first_point = xyz[offsets] - rel[offsets]
    rel_bits = rel.view(np.uint32)

    def blocks_ok(centers):
        got = (xyz - np.repeat(centers, counts, axis=0)).view(np.uint32)
        return np.logical_and.reduceat((got == rel_bits).all(axis=1), offsets)

    ok_formula = blocks_ok(formula)
    if ok_formula.all():
        centers = formula
    else:
        ok_first = blocks_ok(first_point)
        if not (ok_formula | ok_first).all():
            raise NotPackableError(
                "rel features are not xyz - center for any recoverable center")
        centers = np.where(ok_formula[:, None], formula, first_point)

    packed = np.empty((points.shape[0], 4), np.uint32)
    packed[:, :3] = xyz.view(np.uint32)
    r, g, b = (rgb[:, i].astype(np.uint32) for i in range(3))
    packed[:, 3] = (r << 24) | (g << 16) | (b << 8) | lab.astype(np.uint32)
    return packed, np.ascontiguousarray(centers, np.float32)


def dataset_fingerprint(dataset) -> str | None:
    """Stable content key for a `BlockDataset`'s on-disk files (path,
    size, mtime_ns): keys the packed-store cache. None when the
    dataset does not expose its file list (in-memory datasets)."""
    blocks = getattr(dataset, "blocks", None)
    data_dir = getattr(dataset, "data_dir", None)
    if blocks is None or data_dir is None:
        return None
    h = hashlib.sha256()
    for a, _i, _j, fn in blocks:
        st = os.stat(os.path.join(data_dir, f"area_{a}", fn))
        h.update(f"{a}/{fn}:{st.st_size}:{st.st_mtime_ns}\n".encode())
    return h.hexdigest()[:24]


_FP_UNSET = object()


def load_packed_cached(dataset, cache_dir: str, num_workers: int = 8,
                       raw=None, fp=_FP_UNSET, skip_read: bool = False):
    """(packed, centers, counts) for `dataset`, served from an on-disk
    cache when the dataset fingerprint matches; packs (and writes the
    cache) otherwise. The single miss-path implementation: the
    `device_store_or_host_loader` compact stage calls this too (with
    its already-loaded `raw` blocks), so cache semantics live in one
    place.

    `fp`/`skip_read` let a caller that already fingerprinted the
    dataset and missed the cache avoid repeating both (the fingerprint
    is an os.stat sweep over every block file, about 100k stats at full
    S3DIS scale).

    The cache pays the raw block load and the pack once ever. Hits
    return the packed table MEMORY-MAPPED, so restart cost is metadata
    + the chunked upload alone. Writes publish a complete
    per-fingerprint directory with one atomic rename, so a killed or
    CONCURRENT writer never leaves a usable half cache behind. The
    layout on disk is the JAX package's: a cache written by either
    package is a hit for the other."""
    if fp is _FP_UNSET:
        fp = dataset_fingerprint(dataset)
    if not skip_read:
        cached = _read_pack_cache(cache_dir, fp)
        if cached is not None:
            return cached

    if raw is None:
        raw = _load_raw_blocks(dataset, num_workers)
    counts = np.asarray(raw[2], np.int32)
    packed, centers = pack_block_table(raw[0], raw[1], counts)
    if fp is not None:
        _write_pack_cache(cache_dir, fp, packed, centers, counts)
    return packed, centers, counts


_PACK_CACHE_NAMES = ("packed.npy", "centers.npy", "counts.npy")


def _read_pack_dir(d: str, fp: str):
    """One cache directory -> (packed mmap, centers, counts) or None.

    Validates meta.json's recorded rows/blocks against the arrays
    actually on disk (and counts.sum() against rows): a crash while
    OVERWRITING a legacy flat-layout cache can leave a fingerprint-
    matching meta next to a mix of old and new arrays, and serving
    that trains on wrong data or traps in the gather."""
    meta_p = os.path.join(d, "meta.json")
    if not os.path.exists(meta_p):
        return None
    try:
        with open(meta_p) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if meta.get("fingerprint") != fp or not all(
        os.path.exists(os.path.join(d, n)) for n in _PACK_CACHE_NAMES
    ):
        return None
    packed = np.load(os.path.join(d, _PACK_CACHE_NAMES[0]), mmap_mode="r")
    centers = np.load(os.path.join(d, _PACK_CACHE_NAMES[1]))
    counts = np.load(os.path.join(d, _PACK_CACHE_NAMES[2]))
    rows, blocks = meta.get("rows"), meta.get("blocks")
    if (packed.shape[0] != rows or counts.shape[0] != blocks
            or centers.shape[0] != blocks or int(counts.sum()) != rows):
        return None
    return packed, centers, counts


def _read_pack_cache(cache_dir: str, fp: str | None):
    """Cache hit -> (packed mmap, centers, counts); None otherwise.

    Looks in the per-fingerprint subdirectory `cache_dir/{fp}` (one
    atomic directory per dataset, so one cache dir can serve several
    datasets and concurrent writers can't interleave), then falls back
    to the legacy flat layout (arrays directly in `cache_dir`)."""
    if fp is None:
        return None
    hit = _read_pack_dir(os.path.join(cache_dir, fp), fp)
    if hit is not None:
        return hit
    return _read_pack_dir(cache_dir, fp)


def _write_pack_cache(cache_dir, fp, packed, centers, counts) -> None:
    """Publishes `cache_dir/{fp}` with ONE atomic directory rename.

    The full cache set (arrays + meta.json) is staged in a per-pid
    temp subdirectory, then renamed into place: a killed process
    leaves only an invisible temp dir, and two concurrent writers
    (same or different datasets) can't interleave per-file renames
    into a mixed cache. Loser of a same-fp publish race discards its
    staging dir: same fingerprint = same input files = identical
    content. Stale temp dirs from dead writers are swept
    opportunistically."""
    os.makedirs(cache_dir, exist_ok=True)
    pid = os.getpid()
    # sweep temp dirs left by crashed writers (best-effort)
    for entry in os.listdir(cache_dir):
        if not entry.startswith(".tmp-"):
            continue
        try:
            owner = int(entry.split("-")[1])
            os.kill(owner, 0)  # raises if the pid is gone
        except (ValueError, ProcessLookupError):
            with contextlib.suppress(OSError):
                shutil.rmtree(os.path.join(cache_dir, entry))
        except PermissionError:
            pass  # pid alive under another uid: leave it

    stage = os.path.join(cache_dir, f".tmp-{pid}")
    os.makedirs(stage, exist_ok=True)
    for name, arr in zip(_PACK_CACHE_NAMES, (packed, centers, counts)):
        np.save(os.path.join(stage, name), arr)
    with open(os.path.join(stage, "meta.json"), "w") as f:
        json.dump({"fingerprint": fp, "rows": int(packed.shape[0]),
                   "blocks": int(counts.shape[0])}, f)
    target = os.path.join(cache_dir, fp)
    try:
        os.replace(stage, target)
    except OSError:
        # target exists non-empty: either a concurrent same-fp writer
        # published identical content (keep theirs), or an invalid/
        # torn dir occupies the slot (replace it, else every future
        # read would miss and repack forever)
        if _read_pack_dir(target, fp) is None:
            with contextlib.suppress(OSError):
                shutil.rmtree(target)
            with contextlib.suppress(OSError):
                os.replace(stage, target)
                return
        with contextlib.suppress(OSError):
            shutil.rmtree(stage)


def _choose_rows(offsets, counts, ids, u):
    """Within-block row sampling shared by both store layouts.

    `ids` (B,) are the batch's block ids (-1: a fill row) and `u`
    (B, npoints) float32 uniforms in [0, 1). Returns (rows (B, npoints)
    int64 flat-table indices, safe block ids, valid mask)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    off = offsets[safe]                                       # (B,)
    cnt = torch.where(valid, counts[safe], 0)
    # the product stays in float32 and is clipped, as in the JAX sampler:
    # a count beyond 2^24 is rounded when converted and the product can
    # then reach it
    local = torch.floor(u * cnt[:, None].to(torch.float32)).to(torch.int64)
    local = torch.minimum(local.clamp(min=0), (cnt[:, None] - 1).clamp(min=0))
    return off[:, None] + local, safe, valid


def _finish_batch(pts, lab, valid, npoints, num_classes):
    """Fill-row masking + one-hot, shared by both layouts."""
    classes = torch.arange(num_classes, device=lab.device, dtype=lab.dtype)
    # fill rows carry zero labels + zero features + zero length
    onehot = ((lab[..., None] == classes) & valid[:, None, None]).to(torch.uint8)
    pts = torch.where(valid[:, None, None], pts, 0.0)
    lengths = torch.where(valid, npoints, 0).to(torch.int32)
    return pts, onehot, lengths


class _Shard:
    """A row-sharded table's place: this rank holds rows [start, start +
    rows) of `total`, on the data axis of `mesh`."""

    def __init__(self, mesh: Mesh, total: int):
        if total % mesh.world_size:
            raise ValueError(f"a table of {total} rows does not split over "
                             f"{mesh.world_size} ranks")
        self.mesh, self.total = mesh, total
        self.rows = total // mesh.world_size
        self.start = mesh.rank * self.rows

    def local(self, flat: torch.Tensor):
        """(local indices, held) of the global row indices `flat`: rows
        this rank does not hold read its row 0."""
        held = (flat >= self.start) & (flat < self.start + self.rows)
        return torch.where(held, flat - self.start, 0), held


def _assemble(words: torch.Tensor, held: torch.Tensor, shard: _Shard) -> torch.Tensor:
    """The whole batch's int32 words from each rank's own rows (zeros
    elsewhere): one all-reduce over the data axis."""
    return all_reduce_(torch.where(held[:, None], words, 0), shard.mesh)


def _sample_batch(
    points: torch.Tensor,    # (T, F) flat point table
    labels: torch.Tensor,    # (T,)  flat class ids
    offsets: torch.Tensor,   # (M,)
    counts: torch.Tensor,    # (M,)
    ids: torch.Tensor,       # (B,) block ids of the batch, -1 = fill row
    u: torch.Tensor,         # (B, npoints) uniforms in [0, 1)
    *,
    num_classes: int,
    shard: _Shard | None = None,
):
    """One sampled batch from the flat layout: two flat-table gathers
    (36-byte point rows, 1-byte labels); from a row-sharded table the same
    two of this rank's rows and one all-reduce."""
    batch_size, npoints = u.shape
    rows, _, valid = _choose_rows(offsets, counts, ids, u)
    flat = rows.reshape(-1)
    if shard is not None:
        flat, held = shard.local(flat)
    pts = gather_rows_flat(points, flat)
    lab = gather_rows_flat(labels, flat)
    if shard is not None:
        words = _assemble(torch.cat([pts.view(torch.int32), lab.to(torch.int32)[:, None]], 1),
                          held, shard)
        pts, lab = words[:, :-1].contiguous().view(torch.float32), words[:, -1].to(labels.dtype)
    pts = pts.reshape(batch_size, npoints, points.shape[-1])
    lab = lab.reshape(batch_size, npoints)
    return _finish_batch(pts, lab, valid, npoints, num_classes)


def _unpack(w: torch.Tensor, ctr: torch.Tensor):
    """Packed words (..., 4) int32 and their block centers (..., 3) ->
    ((..., 9) float32 features, (...) uint8 labels). Exact: xyz come
    back by reinterpreting the bits, never through a float conversion;
    rgb are exact byte -> float32 conversions; xyz - center recomputes
    the identical IEEE float32 subtraction the preprocessor ran. The
    table is held as int32 (same bits as the u32 on disk), so `>>` is
    arithmetic and every shift is masked."""
    xyz = w[..., :3].contiguous().view(torch.float32)
    w3 = w[..., 3]
    rgb = torch.stack(
        [(w3 >> 24) & 0xFF, (w3 >> 16) & 0xFF, (w3 >> 8) & 0xFF], dim=-1
    ).to(torch.float32)
    lab = (w3 & 0xFF).to(torch.uint8)
    return torch.cat([xyz, rgb, xyz - ctr], dim=-1), lab


def _sample_batch_packed(
    packed: torch.Tensor,    # (T, 4) int32, see pack_block_table
    centers: torch.Tensor,   # (M, 3) f32 per-block centers
    offsets: torch.Tensor,
    counts: torch.Tensor,
    ids: torch.Tensor,
    u: torch.Tensor,
    *,
    num_classes: int,
    shard: _Shard | None = None,
):
    """Sampled batch from the 16-byte/point packed table: one 16-byte-row
    gather fetches everything (against a 36-byte and a 1-byte one for the
    flat layout). Bit-identical to `_sample_batch` on the table it was
    packed from (see `_unpack`). From a row-sharded table: the gather of
    this rank's rows and one all-reduce."""
    batch_size, npoints = u.shape
    rows, safe, valid = _choose_rows(offsets, counts, ids, u)
    flat = rows.reshape(-1)
    if shard is not None:
        flat, held = shard.local(flat)
    w = gather_rows_flat(packed, flat)
    if shard is not None:
        w = _assemble(w, held, shard)
    w = w.reshape(batch_size, npoints, 4)
    pts, lab = _unpack(w, centers[safe][:, None, :])
    return _finish_batch(pts, lab, valid, npoints, num_classes)


def _load_raw_blocks(dataset, num_workers: int):
    """Bulk-loads a `BlockDataset` (raw, unsampled blocks) once via a
    thread pool; returns the concatenated (points, labels, counts)."""
    if getattr(dataset, "sampling", None) is not None:
        raise ValueError(
            "device stores want raw blocks; construct the "
            "BlockDataset with sampling=None (sampling runs on device)"
        )
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        blocks = list(pool.map(dataset.__getitem__, range(len(dataset))))
    pts = np.concatenate([p for p, _ in blocks], axis=0)
    labs = np.concatenate([
        # dataset items are (points, class-id labels) or (points, onehot)
        l.argmax(-1) if l.ndim == 2 else l for _, l in blocks
    ]).astype(np.uint8)
    counts = [p.shape[0] for p, _ in blocks]
    return pts, labs, counts


def upload_flat(arr: np.ndarray | torch.Tensor, device: torch.device | str,
                chunk_rows: int = 4_000_000, *, mesh: Mesh | None = None) -> torch.Tensor:
    """Copies a large host array into one preallocated tensor on
    `device`, `chunk_rows` rows at a time.

    On a CUDA device each chunk passes through one of two pinned staging
    buffers and is copied without blocking, so reading chunk i + 1 from
    the host (a page fault per page of a memory-mapped pack cache)
    overlaps the copy of chunk i, peak device memory is the table alone,
    and the host never holds more than two chunks of a memory-mapped
    table (which is read-only: `torch.from_numpy` on the whole of it
    would warn, and a full copy would defeat the mapping). uint32 arrays
    come back as int32 with the same bits. A tensor is moved as it is.
    With `mesh`, only this rank's rows [r T/n, (r+1) T/n) of the data axis
    are uploaded (T must divide by n).
    """
    device = torch.device(device)
    if mesh is not None and mesh.world_size > 1:
        shard = _Shard(mesh, arr.shape[0])
        arr = arr[shard.start:shard.start + shard.rows]
        if isinstance(arr, torch.Tensor):  # a copy: the whole table may be freed
            return arr.to(device, copy=True)
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    n = arr.shape[0]
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    out = torch.empty(arr.shape, dtype=dtype, device=device)
    rows = max(1, min(chunk_rows, n))
    pinned = device.type == "cuda"
    stages = [torch.empty((rows, *arr.shape[1:]), dtype=dtype, pin_memory=pinned)
              for _ in range(2 if pinned and n > rows else 1)]
    copied: list = [None] * len(stages)  # the event after each stage's last copy
    for i, start in enumerate(range(0, n, rows)):
        slot = i % len(stages)
        if copied[slot] is not None:
            copied[slot].synchronize()  # the stage is free to overwrite
        k = min(rows, n - start)
        stages[slot].numpy()[:k] = arr[start:start + k]
        out[start:start + k].copy_(stages[slot][:k], non_blocking=True)
        if pinned:
            copied[slot] = torch.cuda.Event()
            copied[slot].record(torch.cuda.current_stream(device))
    if pinned:
        torch.cuda.current_stream(device).synchronize()
    return out


def _per_block(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A per-block array (M entries: tiny) as a tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


class _DeviceStoreBase:
    """Shared store machinery: subclasses set `_tables` (the positional
    prefix of their `_sampler`), `counts`, `num_classes`, `device` and
    `shard` (None, or the row-sharded table's place)."""

    _sampler: staticmethod
    shard: _Shard | None = None

    @property
    def tables(self) -> tuple:
        return self._tables

    @property
    def num_blocks(self) -> int:
        return int(self.counts.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes this rank holds resident (its shard of a sharded table)."""
        return sum(x.numel() * x.element_size() for x in self._tables)

    def _set_shard(self, mesh: Mesh | None, total: int) -> None:
        self.shard = _Shard(mesh, total) if mesh is not None and mesh.world_size > 1 else None

    def _set_blocks(self, counts, device: torch.device) -> None:
        counts = np.asarray(counts, np.int64)
        # int64: row indices are formed as offsets + local and a table
        # may hold more than 2^31 rows
        self.offsets = _per_block(_exclusive_cumsum(counts), torch.int64, device)
        self.counts = _per_block(counts, torch.int64, device)
        self.device = device

    def sample_from(self, ids: torch.Tensor, u: torch.Tensor):
        """The deterministic core: the batch of block `ids` (B,) drawn
        with the uniforms `u` (B, npoints). Returns (points, onehot,
        lengths), all on the store's device."""
        return type(self)._sampler(*self._tables, ids, u, num_classes=self.num_classes,
                                   shard=self.shard)

    def sample(self, order: torch.Tensor, step: int, generator: torch.Generator,
               batch_size: int, npoints: int):
        """Batch number `step` of the epoch `order`, its uniforms drawn
        from `generator` (on the store's device). `step` is a Python int:
        slicing by it reads nothing back from the device."""
        with span("pointseg_torch.data.sample"):
            ids = order[step * batch_size:(step + 1) * batch_size]
            u = torch.rand((batch_size, npoints), generator=generator, device=self.device)
            return self.sample_from(ids, u)

    def epoch_order(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Random block permutation for one epoch, padded with -1 fill
        ids to a multiple of batch_size (device-side shuffle, the
        analogue of the reference DataLoader's shuffle=True)."""
        m = self.num_blocks
        perm = torch.randperm(m, generator=generator, device=self.device)
        pad = (-m) % batch_size
        if pad:
            perm = torch.cat([perm, perm.new_full((pad,), -1)])
        return perm

    @classmethod
    def from_block_dataset(cls, dataset, num_classes: int = NUM_S3DIS_CLASSES,
                           num_workers: int = 8, *, device: torch.device | str | None = None,
                           mesh: Mesh | None = None):
        pts, labs, counts = _load_raw_blocks(dataset, num_workers)
        return cls(pts, labs, counts, num_classes, device=device, mesh=mesh)


def _store_device(device, mesh: Mesh | None) -> torch.device:
    if device is None:
        if mesh is None:
            raise ValueError("a device store needs a device (or a mesh, whose device it takes)")
        return mesh.device
    return torch.device(device)


class DeviceBlockStore(_DeviceStoreBase):
    """The whole block split, resident on the device as flat f32 (36 B +
    1 B per point)."""

    _sampler = staticmethod(_sample_batch)

    def __init__(
        self,
        points: np.ndarray | torch.Tensor,
        labels: np.ndarray | torch.Tensor,
        counts: np.ndarray | Sequence[int],
        num_classes: int = NUM_S3DIS_CLASSES,
        *,
        device: torch.device | str | None = None,
        mesh: Mesh | None = None,
    ):
        """Args:
        points: (T, F) all block points, concatenated.
        labels: (T,) integer class ids.
        counts: (M,) points per block; offsets are the exclusive cumsum.
        device: where the tables live (arrays are uploaded in chunks,
            tensors moved as they are); default the mesh's device.
        mesh: row-shards the two tables over its data axis (module
            docstring); None keeps them whole.
        """
        device = _store_device(device, mesh)
        if not isinstance(points, torch.Tensor):
            points = np.asarray(points, np.float32)
        if not isinstance(labels, torch.Tensor):
            labels = np.asarray(labels, np.uint8)
        self._set_shard(mesh, points.shape[0])
        self.points = upload_flat(points, device, mesh=mesh)
        self.labels = upload_flat(labels, device, mesh=mesh)
        self._set_blocks(counts, device)
        self.num_classes = num_classes
        self._tables = (self.points, self.labels, self.offsets, self.counts)


class CompactDeviceStore(_DeviceStoreBase):
    """The whole block split at 16 bytes/point: full S3DIS (about 273M
    points) costs 4.4 GB instead of 10 GB of f32. Sampling output is
    BIT-IDENTICAL to `DeviceBlockStore` (verified at pack time, see
    `pack_block_table`); only the canonical S3DIS block format packs,
    `NotPackableError` otherwise."""

    _sampler = staticmethod(_sample_batch_packed)

    def __init__(
        self,
        points: np.ndarray,
        labels: np.ndarray,
        counts: np.ndarray | Sequence[int],
        num_classes: int = NUM_S3DIS_CLASSES,
        *,
        device: torch.device | str | None = None,
        mesh: Mesh | None = None,
    ):
        counts = np.asarray(counts, np.int64)
        packed, centers = pack_block_table(points, labels, counts)
        self._init_from_packed(packed, centers, counts, num_classes,
                               _store_device(device, mesh), mesh)

    @classmethod
    def from_packed(cls, packed, centers, counts,
                    num_classes: int = NUM_S3DIS_CLASSES, *,
                    device: torch.device | str | None = None, mesh: Mesh | None = None):
        """Wraps an ALREADY-packed table (a host array, memory-mapped or
        not, or a tensor) without re-verifying: for callers that packed
        via `pack_block_table` themselves or read the pack cache. With
        `mesh`, the table is row-sharded (module docstring)."""
        self = object.__new__(cls)
        self._init_from_packed(packed, centers, counts, num_classes,
                               _store_device(device, mesh), mesh)
        return self

    def _init_from_packed(self, packed, centers, counts, num_classes, device, mesh=None):
        self._set_shard(mesh, packed.shape[0])
        self.packed = upload_flat(packed, device, mesh=mesh)
        if self.packed.dtype != torch.int32 or self.packed.shape[1:] != (4,):
            raise ValueError(f"packed table must be (T, 4) of 32-bit words, got "
                             f"{self.packed.dtype} {tuple(self.packed.shape)}")
        self.centers = _per_block(centers, torch.float32, device)
        self._set_blocks(counts, device)
        self.num_classes = num_classes
        self._tables = (self.packed, self.centers, self.offsets, self.counts)


def flat_tables_from_compact(store: CompactDeviceStore, chunk_rows: int = 8_000_000):
    """Reconstructs the flat f32 tables ON DEVICE from a resident
    `CompactDeviceStore`: the (T, 9) ``[xyz, rgb, xyz - center]`` table
    and the (T,) u8 labels, bit-identical to the host table the store
    was packed from (the exactness argument of `_unpack`). The device
    then holds both layouts of the same data with no second host upload:
    for comparing the two samplers on one table. `chunk_rows` bounds the
    temporaries of the unpack. A row-sharded store gives this rank's rows
    of the flat tables (the shard a `DeviceBlockStore` with the same mesh
    holds)."""
    packed, centers, offsets, _ = store.tables
    total = packed.shape[0]
    first = 0 if store.shard is None else store.shard.start
    # big buffer first: when memory is short, the OOM lands on it with
    # nothing else allocated
    pbuf = torch.empty((total, 9), dtype=torch.float32, device=packed.device)
    lbuf = torch.empty((total,), dtype=torch.uint8, device=packed.device)
    for start in range(0, total, chunk_rows):
        stop = min(start + chunk_rows, total)
        idx = torch.arange(first + start, first + stop, device=packed.device)
        blk = torch.searchsorted(offsets, idx, right=True) - 1
        pbuf[start:stop], lbuf[start:stop] = _unpack(packed[start:stop], centers[blk])
    return pbuf, lbuf


def hbm_bytes_limit(device: torch.device | str) -> int | None:
    """The card's memory capacity in bytes; None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def device_store_or_host_loader(
    dataset,
    batch_size: int,
    npoints: int = 4096,
    num_classes: int = NUM_S3DIS_CLASSES,
    seed: int = 0,
    *,
    device: torch.device | str,
    model_workspace_bytes: int = 5 << 30,
    hbm_limit: int | None = None,
    store_bytes_estimate: int | None = None,
    chunk: int = 8,
    num_workers: int = 8,
    layout: str = "auto",
    pack_cache: str | None = None,
):
    """The training-input policy: flat device store when it fits, the
    16-byte/point compact store when only that fits (full S3DIS is
    10 GB flat against 4.4 GB packed), chunked host prefetcher when
    neither does.

    The store must leave room for the model's step temporaries, so the
    budget is hbm_limit - `model_workspace_bytes`. The default of 5 GiB
    is about twice the largest peak a train step of the ported models
    allocates at B=8, N=4096 (DeepGraphCnn: 2,543.8 MiB, PERF.md
    section 5); pass more for larger batches. When `store_bytes_estimate`
    is given (the FLAT store's bytes; callers that know their dataset
    size can skip a doomed upload), an over-budget layout is skipped
    without an upload attempt; otherwise each store is attempted and an
    allocation failure (or a NotPackableError for the compact layout)
    falls through to the next stage. `hbm_limit` defaults to the card's
    capacity (`hbm_bytes_limit`); on the CPU there is no limit.

    `layout` forces a stage: "flat" / "compact" / "host" skip the
    others entirely (a forced device layout still falls back to host on
    OOM / NotPackableError); "auto" (default) walks the chain.

    `pack_cache` names a directory persisting the PACKED table keyed by
    the dataset fingerprint: a hit skips the raw block load AND the
    pack, so restart cost becomes metadata + the chunked upload; a miss
    packs once and writes it. Setting it also opts auto mode into
    COMPACT-FIRST: only the compact stage packs, so flat-first would
    leave the cache permanently unwritten wherever flat fits. A
    non-packable dataset (float rgb) still falls back flat -> host.

    Only `torch.cuda.OutOfMemoryError` falls back; every other exception
    propagates, a missing card included (the stores raise on it).

    Returns (loader, mode) with mode in {"device", "compact", "host"};
    `loader.policy_reason` says why.
    """
    from pointseg_torch.data.datasets import Loader

    if layout not in ("auto", "flat", "compact", "host"):
        raise ValueError(f"layout must be auto/flat/compact/host, got {layout}")
    device = torch.device(device)
    limit = hbm_limit if hbm_limit is not None else hbm_bytes_limit(device)

    def fits(est):
        return not (est is not None and limit is not None
                    and est + model_workspace_bytes > limit)

    # flat layout: 36 B points + 1 B label; compact: 16 B packed
    compact_estimate = None if store_bytes_estimate is None else \
        (store_bytes_estimate * 16) // 37
    raw = None
    fp_key = dataset_fingerprint(dataset) if pack_cache is not None else None
    cached = _read_pack_cache(pack_cache, fp_key) if pack_cache else None

    def actual_estimate(name):
        """Store bytes derived from the loaded arrays (or the pack
        cache's metadata): used in auto mode when the caller gave no
        estimate, so a doomed full-scale upload is SKIPPED rather than
        attempted and rolled back."""
        if raw is not None:
            pts, _labs, counts = raw
            t, f, m = int(pts.shape[0]), int(pts.shape[1]), len(counts)
        else:  # cache hit: T rows of 16 B packed / T*37 flat
            packed, centers, counts = cached
            t, f, m = int(packed.shape[0]), 9, int(counts.shape[0])
        if name == "flat":
            return t * f * 4 + t  # f32 points + u8 labels
        return t * 16 + m * 12  # packed words + per-block meta

    def over_budget(name):
        """Appends the reason and says True when auto mode, given no
        caller estimate, measures `name` over the budget."""
        if layout == "auto" and stages[name][1] is None and \
                (raw is not None or cached is not None) and \
                not fits(actual_estimate(name)):
            reasons.append(f"{name}: over budget (measured "
                           f"{actual_estimate(name) / 1e9:.2f} GB)")
            return True
        return False

    stages = {
        "flat": (DeviceBlockStore, store_bytes_estimate, "device"),
        "compact": (CompactDeviceStore, compact_estimate, "compact"),
    }
    # Requesting a pack cache opts auto mode into COMPACT-FIRST: on a
    # hit the cache skips the raw block load + the pack entirely, and on
    # a miss only the compact stage packs (and thus writes the cache);
    # flat-first would leave `pack_cache` inert forever where flat fits.
    # The two stores sample bit-identically.
    order = ((("compact", "flat") if pack_cache is not None
              else ("flat", "compact")) if layout == "auto"
             else (layout,) if layout in stages else ())
    reasons: list[str] = []
    if layout == "auto" and pack_cache is not None:
        reasons.append(
            "pack-cache " + ("hit" if cached is not None else "miss")
            + ": compact preferred over flat (the compact store is what "
              "the cache holds; both sample bit-identically)")
    for name in order:
        cls, est, mode = stages[name]
        if layout == "auto" and not fits(est):
            reasons.append(f"{name}: over budget (caller estimate)")
            continue
        try:
            if over_budget(name):
                continue
            if name == "compact" and pack_cache is not None:
                if cached is None:
                    if raw is None:
                        raw = _load_raw_blocks(dataset, num_workers)
                        if over_budget(name):
                            continue
                    # fp_key was computed and the cache read-missed at
                    # function entry: don't repeat either
                    packed, centers, counts_arr = load_packed_cached(
                        dataset, pack_cache, num_workers, raw=raw,
                        fp=fp_key, skip_read=True)
                else:
                    packed, centers, counts_arr = cached
                store = CompactDeviceStore.from_packed(
                    packed, centers, counts_arr, num_classes=num_classes, device=device)
            else:
                if raw is None:
                    raw = _load_raw_blocks(dataset, num_workers)
                    if over_budget(name):
                        continue
                store = cls(*raw, num_classes=num_classes, device=device)
            loader = DeviceEpochLoader(store, batch_size, npoints, seed=seed)
            loader.policy_reason = "; ".join(reasons) or f"{name} fits"
            return loader, mode
        except NotPackableError as e:
            reasons.append(f"{name}: not packable ({e})")
        except torch.cuda.OutOfMemoryError:
            reasons.append(f"{name}: device OOM")

    # the device store wants raw blocks (sampling=None); the host path
    # samples on the host exactly like the reference loader
    sampled = copy.copy(dataset)
    if hasattr(sampled, "sampling"):
        sampled.sampling = npoints
    host = Loader(sampled, batch_size=batch_size, shuffle=True,
                  pad_to=npoints, num_classes=num_classes, seed=seed,
                  num_workers=num_workers)
    prefetcher = ChunkedDevicePrefetcher(host, device, chunk=chunk)
    prefetcher.policy_reason = "; ".join(reasons) or "host layout forced"
    return prefetcher, "host"


class ChunkedDevicePrefetcher:
    """Fewer, larger host to device copies for host loaders.

    Stacks `chunk` equal-shaped batches on the host (in a background
    thread, overlapped with device compute), pins the stacked arrays on
    a CUDA device and ships each as ONE non-blocking copy, then yields
    per-batch device slices: a transfer's fixed cost is paid once per
    chunk instead of once per step.

    Batches whose shapes differ from the running chunk (bucketed eval
    pads, short final batches) flush the chunk and start a new one, so
    any (points, labels, lengths) loader can be wrapped.
    """

    def __init__(self, loader, device: torch.device | str, chunk: int = 8,
                 prefetch: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.chunk = chunk
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.loader)

    def _stack(self, buf: list) -> list[torch.Tensor]:
        stacked = [torch.from_numpy(np.stack(arrs)) for arrs in zip(*buf)]
        if self.device.type == "cuda":
            stacked = [t.pin_memory() for t in stacked]
        return stacked

    def _host_chunks(self):
        buf: list = []
        for batch in self.loader:
            if buf and any(
                b.shape != p.shape for b, p in zip(batch, buf[-1])
            ):
                yield self._stack(buf)
                buf = []
            buf.append(batch)
            if len(buf) == self.chunk:
                yield self._stack(buf)
                buf = []
        if buf:
            yield self._stack(buf)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def worker():
            try:
                chunks = self._host_chunks()
                try:
                    for c in chunks:
                        # bounded put: an abandoned consumer must not
                        # strand this thread on a full queue forever
                        while not stop.is_set():
                            try:
                                q.put(c, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                finally:
                    chunks.close()  # unwind the inner loader promptly
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
                # ONE copy each; the pinned source stays referenced (and
                # PyTorch's host allocator holds its block) until it is done
                stacked = [a.to(self.device, non_blocking=True) for a in item]
                for i in range(item[0].shape[0]):
                    yield tuple(a[i] for a in stacked)
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()


class DeviceEpochLoader:
    """Iterable adapter: plugs the device store into `train_epoch` (which
    accepts any iterable of (points, labels, lengths)) with no host I/O
    and no host to device copy per step."""

    def __init__(self, store: _DeviceStoreBase, batch_size: int,
                 npoints: int = 4096, seed: int = 0, drop_last: bool = False):
        self.store = store
        self.batch_size = batch_size
        self.npoints = npoints
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        m = self.store.num_blocks
        if self.drop_last:
            return m // self.batch_size
        return (m + self.batch_size - 1) // self.batch_size

    def _epoch_start(self):
        """(order, generator) of the next epoch. The generator is seeded
        from (seed, epoch) alone and first draws the permutation, then
        one (B, npoints) block of uniforms per step, so every way of
        walking the epoch sees the same batches."""
        with span("pointseg_torch.data.epoch_start"):
            mixed = np.random.SeedSequence([self.seed, self._epoch]).generate_state(1, np.uint64)
            self._epoch += 1
            generator = torch.Generator(device=self.store.device)
            generator.manual_seed(int(mixed[0]))
            return self.store.epoch_order(generator, self.batch_size), generator

    def __iter__(self):
        order, generator = self._epoch_start()
        for step in range(len(self)):
            yield self.store.sample(order, step, generator, self.batch_size, self.npoints)

    def scan_epoch(self, state, scan_steps: int):
        """One epoch of (sample -> train step) with NO host read between
        the steps or after them: the same batch sequence and the same
        random streams as `__iter__` + `train_step`, every step of the
        epoch included whatever `scan_steps` divides.

        The JAX package fuses `scan_steps` iterations into one
        `lax.scan` program and dispatches `ceil(len / scan_steps)` of
        them. Here a chunk is just its iterations in a row and
        `scan_steps` (checked, >= 1) changes nothing that can be
        observed; what the path buys is that the host never waits for
        the card and so runs ahead of it. Each iteration's train step is
        `train_step`'s: on the card a replay of the step's CUDA graph
        (one launch a step; the sampling stays eager), captured on the
        first batch of its shape.

        Returns (state, metrics) with metrics a dict of (num_steps,)
        device tensors (loss/accuracy/miou per step), one fetch an epoch.
        """
        from pointseg_torch.train.state import train_step

        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        order, generator = self._epoch_start()
        per_step = [
            train_step(state, *self.store.sample(order, step, generator, self.batch_size,
                                                 self.npoints))
            for step in range(len(self))]
        metrics = {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]} if per_step else {}
        return state, metrics
