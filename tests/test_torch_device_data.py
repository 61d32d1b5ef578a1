"""pointseg_torch.data.device and the flat row gather on the CPU.

The same numpy inputs go through `pointseg.data.device` and the port:

- `gather_rows_flat_plain` against the Pallas `gather_rows_flat` in
  interpret mode: equal arrays (a gather moves bits).
- the numpy half (`pack_block_table`, the pack cache) against the JAX
  package's: equal arrays, and a cache written by one package is read by
  the other.
- the sampler cores against `_sample_batch` / `_sample_batch_packed`,
  fed the block order and the uniforms that JAX drew: points, one-hot
  and lengths equal BIT FOR BIT (the arithmetic is one float32 product,
  a floor, integer clips and, for the compact store, one float32
  subtraction; nothing is summed).
- inside the port: compact equals flat bit for bit, the chunked upload
  equals the whole array, the loaders are deterministic in
  (seed, epoch), and every branch of the input policy.

Mirrors `tests/test_device_data.py`, which holds the JAX package.
"""

import json
import os
import shutil
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pointseg.data.device as jdev
import pointseg_torch.data.device as dev
from pointseg.data.datasets import BlockDataset as JaxBlockDataset
from pointseg.ops.pallas.gather import gather_rows_flat as pallas_gather_rows_flat
from pointseg_torch import ops
from pointseg_torch.data.blocks import augment_points
from pointseg_torch.data.datasets import BlockDataset, Loader
from pointseg_torch.data.synthetic import make_block_dataset
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.gather import gather_rows_flat, gather_rows_flat_plain

torch.set_num_threads(2)

CPU = torch.device("cpu")
U_MAX = np.nextafter(np.float32(1), np.float32(0))  # the largest float32 below 1


# --------------------------------------------------------------- the gather


@pytest.mark.parametrize("dtype,C", [(np.float32, 16), (np.int32, 4), (np.float32, 9)])
def test_gather_rows_flat_plain_matches_pallas_interpret(dtype, C):
    rng = np.random.default_rng(0)
    R, M = 256, 256
    table = (rng.normal(size=(R, C)) * 1000).astype(dtype)
    idx = rng.integers(0, R, size=M).astype(np.int32)
    idx[:2] = (0, R - 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_gather_rows_flat(jnp.asarray(table), jnp.asarray(idx),
                                                  chunk=128, window=4))
    got = gather_rows_flat_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    before = dict(_kernels.LAUNCHES)
    via_wrapper = gather_rows_flat(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
    assert _kernels.LAUNCHES == before  # a CPU tensor never counts as a launch


@pytest.mark.parametrize("shape,dtype", [((1000,), np.uint8), ((1000, 4), np.int32),
                                         ((1000, 9), np.float32), ((1000, 35), np.float32)])
def test_gather_rows_flat_takes_any_row_width(shape, dtype):
    """The store's tables: 1-byte labels (1-D), 16-byte packed words,
    36-byte point rows, and an odd width; an Mrows that is no multiple
    of anything; int32 and int64 indices."""
    rng = np.random.default_rng(1)
    table = rng.integers(0, 200, size=shape).astype(dtype)
    idx = rng.integers(0, shape[0], size=777)
    for index_type in (np.int32, np.int64):
        got = gather_rows_flat(torch.from_numpy(table), torch.from_numpy(idx.astype(index_type)))
        assert got.dtype == torch.from_numpy(table).dtype
        np.testing.assert_array_equal(got.numpy(), table[idx])
    empty = gather_rows_flat(torch.from_numpy(table), torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, *shape[1:])


def test_gather_rows_flat_refuses_bad_arguments():
    table = torch.zeros((10, 4))
    for bad in (10, -1):  # the plain version raises; the kernel traps
        with pytest.raises((IndexError, RuntimeError)):
            gather_rows_flat(table, torch.tensor([0, bad]))
    with pytest.raises(ValueError, match="1-D integer"):
        gather_rows_flat(table, torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="1-D integer"):
        gather_rows_flat(table, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="cpu.*cuda"):
        gather_rows_flat(torch.empty((10, 4), device="meta"),
                         torch.zeros(3, dtype=torch.int64, device="meta"))
    # forward only: no graph reaches the table
    assert not gather_rows_flat(table.requires_grad_(True), torch.tensor([1, 2])).requires_grad
    assert ops.gather_rows_flat is gather_rows_flat


# ------------------------------------------------------------ the numpy half


def _canonical_blocks(num_blocks=6, seed=3, lo=80, hi=300, counts=None):
    """Blocks in the preprocessor's output format (augment_points):
    [xyz, u8 rgb, xyz - center], the compact store's packing domain."""
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = rng.integers(lo, hi, size=num_blocks)
    pts, labs = [], []
    for n in counts:
        raw = np.empty((n, 6), np.float32)
        raw[:, :3] = rng.uniform(0, 30, size=(n, 3))
        raw[:, 3:] = rng.integers(0, 256, size=(n, 3))
        pts.append(augment_points(raw))
        labs.append(rng.integers(0, 14, size=n).astype(np.uint8))
    return np.concatenate(pts), np.concatenate(labs), np.asarray(counts)


def _first_point_blocks():
    """A foreign preprocessor: rel = xyz - c for half-integer centers c
    that the augment formula does not reproduce."""
    rng = np.random.default_rng(5)
    counts = np.array([50, 70])
    pts = []
    for n in counts:
        p = np.empty((n, 9), np.float32)
        p[:, :3] = rng.uniform(0, 10, size=(n, 3))
        p[:, 3:6] = rng.integers(0, 256, size=(n, 3))
        p[:, 6:9] = p[:, :3] - (rng.integers(0, 20, size=3) / 2).astype(np.float32)
        pts.append(p)
    pts = np.concatenate(pts)
    return pts, rng.integers(0, 14, size=pts.shape[0]).astype(np.uint8), counts


@pytest.mark.parametrize("blocks", [_canonical_blocks, _first_point_blocks],
                         ids=["canonical", "first_point_center"])
def test_pack_block_table_matches_jax_package(blocks):
    pts, labs, counts = blocks()
    want_packed, want_centers = jdev.pack_block_table(pts, labs, counts)
    packed, centers = dev.pack_block_table(pts, labs, counts)
    assert packed.dtype == np.uint32 and packed.shape == (pts.shape[0], 4)
    np.testing.assert_array_equal(packed, want_packed)
    np.testing.assert_array_equal(centers.view(np.uint32), want_centers.view(np.uint32))


def _spoil(what):
    pts, labs, counts = _canonical_blocks(num_blocks=3)
    labs = labs.astype(np.int64)
    if what == "rgb":
        pts[:, 4] += 0.25
    elif what == "rel":
        pts[:, 6] *= 1.0001
    elif what == "labels":
        labs[5] = 256
    elif what == "width":
        pts = pts[:, :6]
    elif what == "counts":
        counts = counts + 1
    elif what == "empty":
        counts = np.concatenate([counts, [0]])
    return pts, labs, counts


@pytest.mark.parametrize("what,error", [
    ("rgb", "NotPackableError"), ("rel", "NotPackableError"), ("labels", "NotPackableError"),
    ("width", "NotPackableError"), ("counts", "ValueError"), ("empty", "ValueError")])
def test_pack_block_table_rejects_what_the_jax_package_rejects(what, error):
    args = _spoil(what)
    for module in (jdev, dev):
        expected = getattr(module, error, ValueError)
        with pytest.raises(expected) as caught:
            module.pack_block_table(*args)
        if error == "ValueError":
            assert not isinstance(caught.value, module.NotPackableError)


@pytest.fixture(scope="module")
def block_dir(tmp_path_factory):
    return make_block_dataset(str(tmp_path_factory.mktemp("blocks") / "b"), areas=(1, 2),
                              rooms_per_area=2, points_per_room=3000, seed=0, rgb_u8=True)


@pytest.fixture(scope="module")
def float_rgb_dir(tmp_path_factory):
    return make_block_dataset(str(tmp_path_factory.mktemp("blocks") / "f"), areas=(1,),
                              rooms_per_area=2, points_per_room=3000, seed=1)


def _dataset(block_dir, areas=(1,)):
    return BlockDataset(block_dir, set(areas), sampling=None)


@pytest.mark.parametrize("writer,reader", [(dev, jdev), (jdev, dev)],
                         ids=["port_writes_jax_reads", "jax_writes_port_reads"])
def test_pack_cache_is_shared_between_the_packages(block_dir, tmp_path, writer, reader):
    datasets = {dev: _dataset(block_dir), jdev: JaxBlockDataset(block_dir, {1}, sampling=None)}
    assert dev.dataset_fingerprint(datasets[dev]) == jdev.dataset_fingerprint(datasets[jdev])
    cache = str(tmp_path / "cache")
    packed, centers, counts = writer.load_packed_cached(datasets[writer], cache, num_workers=2)
    fp = reader.dataset_fingerprint(datasets[reader])
    assert sorted(os.listdir(os.path.join(cache, fp))) == [
        "centers.npy", "counts.npy", "meta.json", "packed.npy"]
    hit = reader._read_pack_cache(cache, fp)
    assert hit is not None and isinstance(hit[0], np.memmap)
    for got, want in zip(hit, (packed, centers, counts)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with mock.patch.object(reader, "_load_raw_blocks",
                           side_effect=AssertionError("a hit must not load raw blocks")):
        again = reader.load_packed_cached(datasets[reader], cache)
    np.testing.assert_array_equal(np.asarray(again[0]), np.asarray(packed))


def test_pack_cache_rejects_torn_and_mixed_caches(block_dir, tmp_path):
    """A meta.json that no longer describes the arrays beside it is a
    miss, and a repack replaces the invalid directory."""
    ds = _dataset(block_dir)
    cache = str(tmp_path / "c")
    dev.load_packed_cached(ds, cache, num_workers=2)
    fp = dev.dataset_fingerprint(ds)
    fpd = os.path.join(cache, fp)
    assert dev._read_pack_cache(cache, fp) is not None

    packed = np.load(os.path.join(fpd, "packed.npy"))
    np.save(os.path.join(fpd, "packed.npy"), packed[:-7])  # another dataset's table
    assert dev._read_pack_cache(cache, fp) is None
    np.save(os.path.join(fpd, "packed.npy"), packed)
    assert dev._read_pack_cache(cache, fp) is not None

    counts = np.load(os.path.join(fpd, "counts.npy")).copy()
    counts[0] += 1
    np.save(os.path.join(fpd, "counts.npy"), counts)
    assert dev._read_pack_cache(cache, fp) is None
    dev.load_packed_cached(ds, cache, num_workers=2)  # repairs the slot
    assert dev._read_pack_cache(cache, fp) is not None

    os.remove(os.path.join(fpd, "meta.json"))
    assert dev._read_pack_cache(cache, fp) is None
    dev.load_packed_cached(ds, cache, num_workers=2)
    with open(os.path.join(fpd, "meta.json")) as f:
        meta = json.load(f)
    meta["blocks"] += 1
    with open(os.path.join(fpd, "meta.json"), "w") as f:
        json.dump(meta, f)
    assert dev._read_pack_cache(cache, fp) is None
    with open(os.path.join(fpd, "meta.json"), "w") as f:
        f.write("{ torn")
    assert dev._read_pack_cache(cache, fp) is None
    assert dev._read_pack_cache(cache, None) is None  # an in-memory dataset has no key


def test_pack_cache_legacy_flat_layout_and_two_datasets(block_dir, tmp_path):
    ds1, ds2 = _dataset(block_dir, (1,)), _dataset(block_dir, (2,))
    cache = str(tmp_path / "c")
    p1, _, _ = dev.load_packed_cached(ds1, cache, num_workers=2)
    p2, _, _ = dev.load_packed_cached(ds2, cache, num_workers=2)
    fp1, fp2 = dev.dataset_fingerprint(ds1), dev.dataset_fingerprint(ds2)
    assert fp1 != fp2
    np.testing.assert_array_equal(np.asarray(dev._read_pack_cache(cache, fp1)[0]), p1)
    np.testing.assert_array_equal(np.asarray(dev._read_pack_cache(cache, fp2)[0]), p2)
    # the layout of older caches: arrays and meta.json directly in the directory
    for name in ("packed.npy", "centers.npy", "counts.npy", "meta.json"):
        shutil.move(os.path.join(cache, fp1, name), os.path.join(cache, name))
    os.rmdir(os.path.join(cache, fp1))
    hit = dev._read_pack_cache(cache, fp1)
    assert hit is not None
    np.testing.assert_array_equal(np.asarray(hit[0]), p1)
    assert jdev._read_pack_cache(cache, fp1) is not None


# --------------------------------------------- sampler cores against the JAX ones


def _jax_draws(key, batch_size, npoints):
    """The uniforms `_choose_rows` draws from `key`."""
    _, sub = jax.random.split(key)
    return np.array(jax.random.uniform(sub, (batch_size, npoints)))


def _stores(pts, labs, counts):
    return {
        "flat": (jdev.DeviceBlockStore(pts, labs, counts, num_classes=14),
                 dev.DeviceBlockStore(pts, labs, counts, num_classes=14, device=CPU)),
        "compact": (jdev.CompactDeviceStore(pts, labs, counts, num_classes=14),
                    dev.CompactDeviceStore(pts, labs, counts, num_classes=14, device=CPU)),
    }


def _assert_batches_bit_equal(got, want):
    (gp, go, gl), (wp, wo, wl) = got, want
    assert gp.dtype == torch.float32 and go.dtype == torch.uint8 and gl.dtype == torch.int32
    np.testing.assert_array_equal(gp.numpy().view(np.uint32),
                                  np.asarray(wp, np.float32).view(np.uint32))
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_sampler_core_bit_equal_to_jax_with_jax_order_and_uniforms(layout):
    """A whole JAX epoch (7 blocks, batch 4: the last batch has a fill
    row), replayed by the port from the order and uniforms JAX drew."""
    pts, labs, counts = _canonical_blocks(num_blocks=7, seed=11)
    jstore, store = _stores(pts, labs, counts)[layout]
    order = jstore.epoch_order(jax.random.key(3), batch_size=4)
    assert int(order[-1]) == -1
    ids = torch.from_numpy(np.array(order)).long()
    step, key = jnp.zeros((), jnp.int32), jax.random.key(7)
    for s in range(2):
        u = _jax_draws(key, 4, 64)
        *want, step, key = jstore.sample(order, step, key, 4, 64)
        got = store.sample_from(ids[4 * s:4 * s + 4], torch.from_numpy(u))
        _assert_batches_bit_equal(got, want)
    assert int(got[2][-1]) == 0 and not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_sampler_core_edge_draws_bit_equal_to_jax(layout, monkeypatch):
    """u at 0 and at the largest float32 below 1 (the last row of a block
    of 20,000 points, from a product formed in float32), a block of one
    point, and a fill row in the middle of the batch. JAX's sampler is
    run untraced with its uniform draw replaced by ours."""
    pts, labs, counts = _canonical_blocks(counts=[20000, 1, 150, 90], seed=12)
    jstore, store = _stores(pts, labs, counts)[layout]
    rng = np.random.default_rng(13)
    u = rng.random((4, 32)).astype(np.float32)
    u[:, 0], u[:, 1], u[:, 2] = 0.0, U_MAX, np.float32(0.99999)
    ids = np.array([0, 1, -1, 3], np.int32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    raw = type(jstore)._raw_sampler
    *want, _, _ = raw(*jstore.tables, jnp.asarray(ids), jnp.zeros((), jnp.int32),
                      jax.random.key(0), batch_size=4, npoints=32, num_classes=14)
    got = store.sample_from(torch.from_numpy(ids).long(), torch.from_numpy(u))
    _assert_batches_bit_equal(got, want)
    # the last row of the 20,000-point block, never the next block's first
    np.testing.assert_array_equal(got[0][0, 1].numpy(), pts[19999])
    np.testing.assert_array_equal(got[0][1].numpy(), np.broadcast_to(pts[20000], (32, 9)))
    assert got[2].tolist() == [32, 32, 0, 32]


# ------------------------------------------------------------ inside the port


def _toy_store(num_blocks=5, num_classes=4, seed=0):
    """Blocks whose feature 0 is the block id and feature 1 the label:
    a leak across blocks or a broken (point, label) pairing shows."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(50, 400, size=num_blocks)
    pts, labs = [], []
    for b, n in enumerate(counts):
        p = rng.normal(size=(n, 9)).astype(np.float32)
        lab = rng.integers(0, num_classes, size=n).astype(np.uint8)
        p[:, 0], p[:, 1] = b, lab
        pts.append(p)
        labs.append(lab)
    return dev.DeviceBlockStore(np.concatenate(pts), np.concatenate(labs), counts,
                                num_classes=num_classes, device=CPU)


def test_samples_stay_within_their_block_and_keep_their_labels():
    store = _toy_store()
    gen = torch.Generator().manual_seed(0)
    order = store.epoch_order(gen, batch_size=2)
    for step in range(store.num_blocks // 2):
        pts, onehot, lengths = store.sample(order, step, gen, batch_size=2, npoints=64)
        assert pts.shape == (2, 64, 9) and onehot.shape == (2, 64, 4)
        ids = order[2 * step:2 * step + 2]
        assert torch.equal(pts[:, :, 0], ids[:, None].float().expand(2, 64))
        assert torch.equal(onehot.argmax(-1), pts[:, :, 1].long())
        assert lengths.tolist() == [64, 64]


def test_epoch_order_is_a_permutation_padded_with_fill_ids():
    store = _toy_store(num_blocks=7)
    order = store.epoch_order(torch.Generator().manual_seed(5), batch_size=4)
    assert order.shape == (8,) and order.dtype == torch.int64 and int(order[-1]) == -1
    assert sorted(order[:7].tolist()) == list(range(7))
    exact = _toy_store(num_blocks=8).epoch_order(torch.Generator().manual_seed(5), 4)
    assert sorted(exact.tolist()) == list(range(8))


def test_epoch_loader_is_deterministic_in_seed_and_epoch():
    store = _toy_store(num_blocks=6)
    first = [b for b in dev.DeviceEpochLoader(store, 2, 32, seed=9)]
    again = [b for b in dev.DeviceEpochLoader(store, 2, 32, seed=9)]
    other = [b for b in dev.DeviceEpochLoader(store, 2, 32, seed=10)]
    assert len(first) == 3
    for a, b in zip(first, again):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(a[0], b[0]) for a, b in zip(first, other))
    loader = dev.DeviceEpochLoader(store, 2, 32, seed=9)
    e1 = torch.cat([p[:, 0, 0] for p, _, _ in loader])
    e2 = torch.cat([p[:, 0, 0] for p, _, _ in loader])  # the next epoch reshuffles
    assert sorted(e1.tolist()) == sorted(e2.tolist()) and not torch.equal(e1, e2)
    assert torch.equal(e1, torch.cat([b[0][:, 0, 0] for b in first]))
    seven = _toy_store(num_blocks=7)
    assert len(dev.DeviceEpochLoader(seven, 2, 32)) == 4
    short = dev.DeviceEpochLoader(seven, 2, 32, drop_last=True)
    assert len(short) == 3 and len(list(short)) == 3


def test_compact_store_bit_identical_to_flat():
    pts, labs, counts = _canonical_blocks()
    flat = dev.DeviceBlockStore(pts, labs, counts, num_classes=14, device=CPU)
    compact = dev.CompactDeviceStore(pts, labs, counts, num_classes=14, device=CPU)
    assert compact.nbytes < flat.nbytes / 2
    assert compact.packed.dtype == torch.int32
    batches = [list(dev.DeviceEpochLoader(s, 4, 64, seed=7)) for s in (flat, compact)]
    assert len(batches[0]) == 2
    for (fp, fo, fl), (cp, co, cl) in zip(*batches):
        assert torch.equal(fp.view(torch.int32), cp.view(torch.int32))
        assert torch.equal(fo, co) and torch.equal(fl, cl)


def test_flat_tables_from_compact_bit_exact():
    pts, labs, counts = _canonical_blocks(num_blocks=7, seed=21)
    compact = dev.CompactDeviceStore(pts, labs, counts, num_classes=14, device=CPU)
    # more than one full chunk and a ragged tail
    dpts, dlab = dev.flat_tables_from_compact(compact, chunk_rows=257)
    np.testing.assert_array_equal(dpts.numpy().view(np.uint32), pts.view(np.uint32))
    np.testing.assert_array_equal(dlab.numpy(), labs)
    flat = dev.DeviceBlockStore(dpts, dlab, counts, num_classes=14, device=CPU)
    assert flat.points.data_ptr() == dpts.data_ptr()  # tensors are taken as they are
    a = next(iter(dev.DeviceEpochLoader(flat, 4, 64, seed=1)))
    b = next(iter(dev.DeviceEpochLoader(compact, 4, 64, seed=1)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_upload_flat_chunked_matches_whole(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(1000, 9)).astype(np.float32)
    np.testing.assert_array_equal(dev.upload_flat(arr, CPU, chunk_rows=300).numpy(), arr)
    np.testing.assert_array_equal(dev.upload_flat(arr, CPU).numpy(), arr)
    lab = rng.integers(0, 14, size=1000).astype(np.uint8)
    np.testing.assert_array_equal(dev.upload_flat(lab, CPU, chunk_rows=256).numpy(), lab)
    # a memory-mapped, read-only table of u32 words comes back as int32 bits
    words = rng.integers(0, 2**32, size=(777, 4), dtype=np.uint64).astype(np.uint32)
    np.save(tmp_path / "packed.npy", words)
    mapped = np.load(tmp_path / "packed.npy", mmap_mode="r")
    got = dev.upload_flat(mapped, CPU, chunk_rows=100)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), words)
    assert dev.upload_flat(np.zeros((0, 4), np.uint32), CPU).shape == (0, 4)
    assert dev.hbm_bytes_limit("cpu") is None


def test_from_block_dataset_matches_host_reads(block_dir):
    ds = _dataset(block_dir, (1, 2))
    store = dev.DeviceBlockStore.from_block_dataset(ds, num_workers=2, device=CPU)
    assert store.num_blocks == len(ds) and store.nbytes > 0
    assert store.counts.tolist() == [ds[i][0].shape[0] for i in range(len(ds))]
    assert store.points.shape == (int(store.counts.sum()), 9)
    first_points, first_labels = ds[0]
    np.testing.assert_array_equal(store.points[:first_points.shape[0]].numpy(), first_points)
    np.testing.assert_array_equal(store.labels[:first_points.shape[0]].numpy(),
                                  first_labels.argmax(-1))
    with pytest.raises(ValueError, match="sampling=None"):
        dev.DeviceBlockStore.from_block_dataset(BlockDataset(block_dir, {1}, sampling=64),
                                                device=CPU)


def test_chunked_prefetcher_matches_loader(block_dir):
    """Exactly the wrapped loader's batches, in order, across the flushes
    that a change of shape (bucketed pads, a short last chunk) forces."""
    ds = _dataset(block_dir, (1, 2))
    kw = dict(batch_size=3, shuffle=False, pad_to=None, buckets=(512, 1024, 4096),
              prefetch=0, num_workers=0)
    plain = list(Loader(ds, **kw))
    wrapped = list(dev.ChunkedDevicePrefetcher(Loader(ds, **kw), CPU, chunk=4))
    assert len(plain) == len(wrapped) == len(dev.ChunkedDevicePrefetcher(Loader(ds, **kw), CPU))
    for host, device_batch in zip(plain, wrapped):
        for a, b in zip(host, device_batch):
            assert isinstance(b, torch.Tensor)
            np.testing.assert_array_equal(a, b.numpy())


def test_chunked_prefetcher_surfaces_loader_errors():
    def broken():
        yield (np.zeros((2, 4, 9), np.float32), np.zeros((2, 4, 14), np.uint8),
               np.zeros(2, np.int32))
        raise OSError("block file vanished")

    class Once:
        def __iter__(self):
            return broken()

        def __len__(self):
            return 2

    with pytest.raises(OSError, match="vanished"):
        list(dev.ChunkedDevicePrefetcher(Once(), CPU, chunk=4))


# ------------------------------------------------------------------ the policy


def _policy(ds, **kwargs):
    return dev.device_store_or_host_loader(ds, batch_size=2, npoints=128, num_classes=14,
                                           seed=0, device=CPU, num_workers=2, **kwargs)


def _flat_bytes(ds):
    return sum(ds[i][0].shape[0] for i in range(len(ds))) * 37


def test_policy_device_store_by_default_and_host_over_budget(block_dir):
    ds = _dataset(block_dir, (1, 2))
    dev_loader, mode = _policy(ds)
    assert mode == "device" and dev_loader.policy_reason == "flat fits"
    assert isinstance(dev_loader.store, dev.DeviceBlockStore)
    host_loader, mode = _policy(ds, hbm_limit=1 << 20, model_workspace_bytes=1 << 20,
                                store_bytes_estimate=1 << 20)
    assert mode == "host" and isinstance(host_loader, dev.ChunkedDevicePrefetcher)
    assert "flat: over budget (caller estimate)" in host_loader.policy_reason
    assert "compact: over budget (caller estimate)" in host_loader.policy_reason
    for loader in (dev_loader, host_loader):
        batches = list(loader)
        assert len(batches) == len(loader)
        pts, onehot, lengths = batches[0]
        assert pts.shape == (2, 128, 9) and pts.dtype == torch.float32
        assert onehot.shape == (2, 128, 14) and lengths.shape == (2,)


def test_policy_falls_back_to_compact_then_host(block_dir, float_rgb_dir):
    ds = _dataset(block_dir)
    budget = dict(hbm_limit=_flat_bytes(ds), model_workspace_bytes=_flat_bytes(ds) // 2)
    loader, mode = _policy(ds, store_bytes_estimate=_flat_bytes(ds), **budget)
    assert mode == "compact" and isinstance(loader.store, dev.CompactDeviceStore)
    assert next(iter(loader))[0].shape == (2, 128, 9)
    # float rgb does not pack: compact is skipped for its reason, host it is
    ds2 = _dataset(float_rgb_dir)
    loader, mode = _policy(ds2, store_bytes_estimate=_flat_bytes(ds), **budget)
    assert mode == "host" and "compact: not packable" in loader.policy_reason


def test_policy_measures_the_fit_without_a_caller_estimate(block_dir):
    ds = _dataset(block_dir)
    total = _flat_bytes(ds) // 37
    loader, mode = _policy(ds, hbm_limit=total * 37, model_workspace_bytes=total * 37 // 2)
    assert mode == "compact" and "flat: over budget (measured" in loader.policy_reason
    loader, mode = _policy(ds, hbm_limit=total * 8, model_workspace_bytes=total * 4)
    assert mode == "host"
    assert "flat: over budget (measured" in loader.policy_reason
    assert "compact: over budget (measured" in loader.policy_reason


@pytest.mark.parametrize("layout,kwargs,mode", [
    ("compact", {}, "compact"), ("host", {}, "host"),
    # a forced layout ignores a budget that would reject it
    ("flat", dict(hbm_limit=1, model_workspace_bytes=1, store_bytes_estimate=10**9), "device")])
def test_policy_layout_override(block_dir, layout, kwargs, mode):
    loader, got = _policy(_dataset(block_dir), layout=layout, **kwargs)
    assert got == mode
    if layout == "host":
        assert loader.policy_reason == "host layout forced"
    with pytest.raises(ValueError, match="layout"):
        _policy(_dataset(block_dir), layout="nope")


def test_policy_forced_compact_falls_to_host_when_not_packable(float_rgb_dir):
    loader, mode = _policy(_dataset(float_rgb_dir), layout="compact")
    assert mode == "host" and "not packable" in loader.policy_reason


def test_policy_only_out_of_memory_falls_back(block_dir, monkeypatch):
    ds = _dataset(block_dir)

    def no_room(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(dev, "upload_flat", no_room)
    loader, mode = _policy(ds)
    assert mode == "host"
    assert loader.policy_reason == "flat: device OOM; compact: device OOM"

    def broken(*args, **kwargs):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(dev, "upload_flat", broken)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _policy(ds)


def test_pack_cache_hit_skips_the_raw_load(block_dir, tmp_path):
    ds = _dataset(block_dir)
    cache = str(tmp_path / "pack_cache")
    loader1, mode = _policy(ds, layout="compact", pack_cache=cache)
    assert mode == "compact"
    fp0 = dev.dataset_fingerprint(ds)
    assert os.path.exists(os.path.join(cache, fp0, "meta.json"))
    with mock.patch.object(dev, "_load_raw_blocks",
                           side_effect=AssertionError("a hit must not load raw blocks")):
        loader2, mode = _policy(ds, layout="compact", pack_cache=cache)
    assert mode == "compact"
    b1, b2 = next(iter(loader1)), next(iter(loader2))
    assert all(torch.equal(a, b) for a, b in zip(b1, b2))
    # touching a source file changes the fingerprint: a miss, and a repack
    path = os.path.join(block_dir, "area_1", ds.blocks[0][3])
    stat = os.stat(path)
    os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns + 1))
    try:
        assert dev._read_pack_cache(cache, dev.dataset_fingerprint(ds)) is None
        loader3, mode = _policy(ds, layout="compact", pack_cache=cache)
        assert mode == "compact"
        assert all(torch.equal(a, b) for a, b in zip(b1, next(iter(loader3))))
    finally:
        os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns))


def test_pack_cache_makes_auto_mode_compact_first(block_dir, tmp_path):
    ds = _dataset(block_dir)
    cache = str(tmp_path / "pack_cache")
    loader, mode = _policy(ds, pack_cache=cache)  # a miss: packs, writes, compact all the same
    assert mode == "compact" and "pack-cache miss" in loader.policy_reason
    with mock.patch.object(dev, "_load_raw_blocks",
                           side_effect=AssertionError("a hit must not load raw blocks")):
        loader, mode = _policy(ds, pack_cache=cache)  # flat would fit: compact is chosen
    assert mode == "compact" and "pack-cache hit" in loader.policy_reason
