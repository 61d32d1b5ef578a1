"""pointseg_torch.data against pointseg.data: the port keeps its own copy
of the numpy data layer, and the two must stay the same program. The
same synthetic dataset and seed give equal files and equal batches
(numpy equality, not closeness), through the train and the test loader.
"""

import filecmp
import os

import numpy as np
import pytest

from pointseg import data as jdata
from pointseg.data import blocks as jblocks
from pointseg.data import datasets as jdatasets
from pointseg.data import native as jnative
from pointseg.data import prepare as jprepare
from pointseg.data import synthetic as jsynthetic
from pointseg_torch import data as tdata
from pointseg_torch.data import blocks as tblocks
from pointseg_torch.data import datasets as tdatasets
from pointseg_torch.data import native as tnative
from pointseg_torch.data import prepare as tprepare
from pointseg_torch.data import synthetic as tsynthetic


@pytest.fixture(scope="module")
def block_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_parity")
    kw = dict(rooms_per_area=1, points_per_room=3000, seed=3, rgb_u8=True)
    return (jsynthetic.make_block_dataset(str(root / "jax"), **kw),
            tsynthetic.make_block_dataset(str(root / "port"), **kw))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_constants_are_the_same():
    for name in ("S3DIS_CLASSES", "S3DIS_CLASSES_13", "NUM_S3DIS_CLASSES", "BLOCK_SIZE",
                 "MIN_POINTS_PER_BLOCK", "POINT_FEATURE_DIM", "AREAS"):
        assert getattr(tdata, name) == getattr(jdata, name), name
    assert tprepare.INDEX_FILENAME == jprepare.INDEX_FILENAME


def test_synthetic_block_datasets_are_the_same_files(block_dirs):
    jdir, tdir = block_dirs
    names = _files(jdir)
    assert names == _files(tdir) and len(names) > 20
    for name in names:
        a, b = os.path.join(jdir, name), os.path.join(tdir, name)
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for key in za.files:
                    np.testing.assert_array_equal(za[key], zb[key], err_msg=f"{name}:{key}")
        else:
            assert filecmp.cmp(a, b, shallow=False), name


@pytest.mark.parametrize("which", ["train", "test"])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_loaders_yield_identical_batches(block_dirs, which, num_workers):
    """Both packages' loaders over ONE directory, two epochs (the shuffle
    and the per-block sampling draw from the seed). With reader threads
    the per-block sampling draws in the order the threads arrive, in
    either package, so there the train batches are held to their block
    order (the lengths) and shapes only."""
    kw = dict(test_areas={6}, train_batch_size=4, test_batch_size=2, train_sampling=512,
              test_buckets=(1024, 2048, 4096), seed=5, num_workers=num_workers,
              test_pad_mode="repeat")
    want = jdatasets.create_block_dataloaders(block_dirs[0], **kw)[which == "test"]
    got = tdatasets.create_block_dataloaders(block_dirs[0], **kw)[which == "test"]
    assert len(got) == len(want) > 0
    for _ in range(2):
        batches_w, batches_g = list(want), list(got)
        assert len(batches_g) == len(batches_w) == len(want)
        for bw, bg in zip(batches_w, batches_g):
            for w, g in zip(bw, bg):
                assert g.dtype == w.dtype and g.shape == w.shape
                if which == "test" or num_workers == 0:
                    np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(bg[2], bw[2])


def test_collate_and_random_batch_are_the_same():
    rng = np.random.default_rng(0)
    samples = [(rng.random((n, 9)).astype(np.float32),
                np.eye(14, dtype=np.uint8)[rng.integers(0, 14, n)]) for n in (700, 300, 1000)]
    for kw in (dict(pad_to=1500), dict(buckets=(512, 1024, 2048), pad_mode="repeat"),
               dict(buckets=(512, 1024), batch_size=4)):
        for w, g in zip(jdatasets.collate_blocks(samples, **kw),
                        tdatasets.collate_blocks(samples, **kw)):
            np.testing.assert_array_equal(g, w)
    for w, g in zip(jsynthetic.random_batch(np.random.default_rng(1), 2, 64),
                    tsynthetic.random_batch(np.random.default_rng(1), 2, 64)):
        np.testing.assert_array_equal(g, w)


def test_block_grid_and_augmentation_are_the_same():
    rng = np.random.default_rng(2)
    pts = (rng.random((500, 6)) * np.array([3.2, 2.7, 3.0, 255, 255, 255])).astype(np.float32)
    for w, g in zip(jblocks.get_block_starts(pts[:, 0], pts[:, 1]),
                    tblocks.get_block_starts(pts[:, 0], pts[:, 1])):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tblocks.augment_points(pts), jblocks.augment_points(pts))
    labels = rng.integers(0, 14, 500)
    np.testing.assert_array_equal(tblocks.one_hot_encode_labels(labels),
                                  jblocks.one_hot_encode_labels(labels))


def test_raw_text_etl_is_the_same_with_and_without_the_native_parser(tmp_path):
    ann = tmp_path / "raw" / "Area_1" / "office_1" / "Annotations"
    ann.mkdir(parents=True)
    rng = np.random.default_rng(6)
    for name in ("chair_1", "table_1", "wall_2"):
        rows = np.concatenate([rng.random((50, 3)) * 4, rng.integers(0, 256, (50, 3))], axis=1)
        (ann / f"{name}.txt").write_text(
            "\n".join(" ".join(f"{v:.3f}" for v in r) for r in rows) + "\nbad line\n")
    vocab_j = jprepare.prepare_s3dis(str(tmp_path / "raw"), str(tmp_path / "out_j"),
                                     verbose=False)
    vocab_t = tprepare.prepare_s3dis(str(tmp_path / "raw"), str(tmp_path / "out_t"),
                                     verbose=False)
    assert vocab_t == vocab_j
    rooms_j, classes_j = jprepare.load_room_archive(str(tmp_path / "out_j" / "s3dis1.npz"))
    rooms_t, classes_t = tprepare.load_room_archive(str(tmp_path / "out_t" / "s3dis1.npz"))
    assert classes_t == classes_j and len(rooms_t) == len(rooms_j) == 1
    for key in ("points", "labels"):
        np.testing.assert_array_equal(rooms_t[0][key], rooms_j[0][key])
    # both bind the one native/parser.cpp (or both fall back to Python)
    path = str(ann / "chair_1.txt")
    native_j, native_t = jnative.parse_annotation_file(path), tnative.parse_annotation_file(path)
    assert (native_j is None) == (native_t is None)
    if native_t is not None:
        np.testing.assert_array_equal(native_t, native_j)
        np.testing.assert_array_equal(native_t, tprepare._parse_annotation_file(path))
