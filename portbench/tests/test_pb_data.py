"""The generator's blocks: the format the port reads, the frozen grid and
9-feature rule, and the S3DIS density."""

import re

import numpy as np
import pytest

from portbench.data import blocks, rooms

PARAMS = {"areas": [1], "blocks_per_area": 60, "points_per_block": 10920,
          "room_blocks_x": [3, 8], "room_blocks_y": [3, 7], "height_m": [2.6, 3.2],
          "furniture_per_room": [4, 12], "noise_m": 0.002, "generator_seed": 0}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("blocks") / "set"
    return out, rooms.generate(PARAMS, out)


def test_files_in_the_port_format(written):
    out, manifest = written
    names = sorted(p.name for p in (out / "area_1").iterdir())
    assert len(names) == len(manifest["blocks"]) == 60
    assert all(re.fullmatch(r"room\d{2}_block\d{3}\.npz", n) for n in names)
    for row in manifest["blocks"][:10]:
        a, r, b, n = row[:4]
        with np.load(out / f"area_{a}" / f"room{r:02d}_block{b:03d}.npz") as z:
            p, y = z["points"], z["labels"]
        assert p.dtype == np.float32 and p.shape == (n, 9)
        assert y.dtype == np.uint8 and y.shape == (n, 14) and (y.sum(axis=1) == 1).all()
        assert n >= blocks.MIN_POINTS_PER_BLOCK
        rgb = p[:, 3:6]
        assert (rgb == np.rint(rgb)).all() and rgb.min() >= 0 and rgb.max() <= 255
        assert not np.signbit(rgb).any()  # bytes: no -0.0
        # the 9-feature rule, bit for bit
        np.testing.assert_array_equal(p, blocks.nine_features(p[:, :6]))
        assert np.ptp(p[:, 0]) < 1.0 and np.ptp(p[:, 1]) < 1.0


def test_mean_density_is_s3dis(written):
    _, manifest = written
    counts = np.array([r[3] for r in manifest["blocks"]])
    assert abs(counts.mean() - 10920) < 1e-9  # points are drawn as 10,920 a block
    assert counts.min() > 1000 and counts.std() > 1000  # edges and walls vary


def test_frozen_rule_matches_the_port(written):
    from pointseg_torch.data import blocks as port

    rng = np.random.default_rng(3)
    surfaces, _, _ = rooms.room_surfaces(rng, 4, 3, (2.6, 3.2), (4, 12))
    pts, codes = rooms.sample_room(rng, surfaces, 50000, 0.002)
    xs, ys = port.get_block_starts(pts[:, 0], pts[:, 1])
    np.testing.assert_array_equal(xs, blocks.block_starts(pts[:, 0]))
    np.testing.assert_array_equal(ys, blocks.block_starts(pts[:, 1]))
    mine = list(blocks.cut_room(pts, codes))
    assert len(mine) == 12
    labels = port.one_hot_encode_labels(codes)
    theirs = {}
    index = 1
    for x0 in xs:
        for y0 in ys:
            bp, bl = port.extract_block(pts, labels, x0, y0)
            if bp.shape[0] >= blocks.MIN_POINTS_PER_BLOCK:
                theirs[index] = (port.augment_points(bp), bl)
            index += 1
    for index, p9, y in mine:
        np.testing.assert_array_equal(p9, theirs[index][0])
        np.testing.assert_array_equal(y, theirs[index][1])


def test_cache_key_ignores_the_seed_and_follows_the_parameters():
    assert rooms.dataset_key(PARAMS) == rooms.dataset_key(dict(PARAMS))
    assert rooms.dataset_key(PARAMS) != rooms.dataset_key(dict(PARAMS, noise_m=0.003))
