"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine without it run it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The kernels compute distances and scores with the plain versions'
rounding, so indices, `in_ball` and the 3-NN distances must be equal, not
close; the gather moves bits, so its rows are equal too. Only the
gather's gradient (atomic adds on the card) is compared to a tolerance.
"""

import numpy as np
import pytest
import torch

from pointseg_torch.models import create_model
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.ballquery import (
    _ball_query_cuda,
    _radius_sq,
    ball_query_plain,
    ball_query_raw,
)
from pointseg_torch.ops.fps import farthest_point_sampling, farthest_point_sampling_plain
from pointseg_torch.ops.gather import gather_rows, gather_rows_plain
from pointseg_torch.ops.interpolate import three_nn, three_nn_plain
from pointseg_torch.ops.knn import _knn_cuda, knn_indices, knn_indices_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, B, N, device, dup_from=None):
    rng = np.random.default_rng(seed)
    pts = (rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])).astype(np.float32)
    if dup_from is not None:  # repeat-padding: the tail repeats the head
        pts[:, dup_from:] = pts[:, : N - dup_from]
    return torch.from_numpy(pts).to(device)


@pytest.mark.parametrize("B,N,C", [(8, 4096, 1024), (8, 64, 16), (3, 3000, 1000),
                                   (2, 16384, 1024)])
def test_fps_kernel_matches_plain(device, B, N, C):
    pts = _cloud(0, B, N, device, dup_from=N - N // 4)
    start = torch.arange(B, dtype=torch.int32, device=device) * 7
    before = _kernels.LAUNCHES["fps"]
    got = farthest_point_sampling(pts, C, start_indices=start)
    assert _kernels.LAUNCHES["fps"] == before + 1
    want = farthest_point_sampling_plain(pts, C, start)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fps_kernel_mask_matches_plain(device):
    pts = _cloud(1, 4, 500, device)
    mask = torch.rand((4, 500), generator=torch.Generator().manual_seed(2)).to(device) > 0.3
    start = mask.int().argmax(dim=1).to(torch.int32)
    got = farthest_point_sampling(pts, 100, mask=mask)
    torch.testing.assert_close(got, farthest_point_sampling_plain(pts, 100, start, mask),
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,C,N,r,K", [(8, 1024, 4096, 0.1, 32), (8, 16, 64, 0.8, 32),
                                       (3, 1000, 3000, 0.2, 32), (2, 1024, 16384, 0.1, 32),
                                       (2, 100, 700, 0.3, 7)])
def test_ball_query_kernel_matches_plain(device, B, C, N, r, K):
    pts = _cloud(3, B, N, device, dup_from=N - N // 5)
    cents = pts[:, :C].contiguous()
    before = _kernels.LAUNCHES["ball_query"]
    idx, in_ball = ball_query_raw(cents, pts, r, K)
    assert _kernels.LAUNCHES["ball_query"] == before + 1
    want_idx, want_in = ball_query_plain(cents, pts, r, K)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)


def test_ball_query_kernel_mask_matches_plain(device):
    pts = _cloud(4, 2, 900, device)
    mask = torch.rand((2, 900), generator=torch.Generator().manual_seed(5)).to(device) > 0.5
    idx, in_ball = ball_query_raw(pts[:, :200], pts, 0.25, 16, mask=mask)
    want_idx, want_in = ball_query_plain(pts[:, :200], pts, 0.25, 16, mask=mask)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)


def _assert_ball_query_2l(cents, pts, r, K, depth=None, mask=None):
    """The two-level kernel (one launch, nothing else) against the plain
    version and the flat kernel: indices and `in_ball` equal."""
    before = dict(_kernels.LAUNCHES)
    if depth is None:
        idx, in_ball = ball_query_raw(cents, pts, r, K, mask=mask, select="two_level")
    else:
        idx, in_ball = _ball_query_cuda(cents.contiguous(), pts, _radius_sq(r), K, mask,
                                        "two_level", depth)
    assert _kernels.LAUNCHES["ball_query_2l"] == before["ball_query_2l"] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    want_idx, want_in = ball_query_plain(cents, pts, r, K, mask=mask)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)
    flat_idx, flat_in = ball_query_raw(cents, pts, r, K, mask=mask)
    torch.testing.assert_close(idx, flat_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, flat_in, rtol=0, atol=0)
    return in_ball


@pytest.mark.parametrize("depth", [1, 4, 5])
@pytest.mark.parametrize("N,r,K", [(N, r, K) for N, r in ((16, 0.8), (64, 0.8), (100, 0.3),
                                                          (4096, 0.1))
                                   for K in (1, 16, 32) if K <= N])
def test_ball_query_two_level_kernel_matches_plain_and_flat(device, depth, N, r, K):
    """Depth 1 refills a lane after every pick; N = 16 leaves half the
    lanes without a column and takes every point at K = 16; N = 100 is
    no multiple of 32; the tail repeats the head (exact ties)."""
    pts = _cloud(30, 4, N, device, dup_from=N - N // 5)
    C = min(N, 300)
    in_ball = _assert_ball_query_2l(pts[:, :C].contiguous(), pts, r, K, depth=depth)
    assert bool(in_ball[..., 0].all())  # every centroid is in its own ball


@pytest.mark.parametrize("B,C,N,r,K", [(8, 1024, 4096, 0.1, 32), (8, 1024, 1024, 0.1, 32),
                                       (8, 1024, 4096, 0.05, 16), (8, 16, 16, 0.8, 16),
                                       (8, 16, 64, 0.4, 16), (3, 1000, 3000, 0.2, 32),
                                       (2, 1024, 16384, 0.1, 32), (1, 512, 65536, 0.1, 32),
                                       (2, 100, 700, 0.3, 7)])
def test_ball_query_two_level_kernel_at_the_models_shapes(device, B, C, N, r, K):
    """PointNeXt's and MSG's stage shapes (centroids == coords for the
    InvResMLP ones), the ragged repeated-points shape and the evaluation
    buckets, at the depth the wrapper picks."""
    pts = _cloud(31, B, N, device, dup_from=N - N // 5)
    _assert_ball_query_2l(pts[:, :C].contiguous(), pts, r, K)


@pytest.mark.parametrize("depth", [1, 4, 5])
def test_ball_query_two_level_kernel_mask_and_empty_balls(device, depth):
    """Masked points are never members and still fill in index order; a
    fully masked cloud and a radius of 0 around centroids off the cloud
    give balls with no member at all."""
    pts = _cloud(32, 3, 900, device)
    mask = torch.rand((3, 900), generator=torch.Generator().manual_seed(5)).to(device) > 0.5
    mask[2] = False
    in_ball = _assert_ball_query_2l(pts[:, :200].contiguous(), pts, 0.25, 16, depth=depth,
                                    mask=mask)
    assert not bool(in_ball[2].any()) and bool(in_ball[:2].any())
    away = (pts[:, :50] + 10.0).contiguous()
    in_ball = _assert_ball_query_2l(away, pts, 0.0, 32, depth=depth)
    assert not bool(in_ball.any())


@pytest.mark.parametrize("select,counter", [("flat", "ball_query"),
                                            ("two_level", "ball_query_2l")])
def test_ball_query_kernels_treat_nan_as_outside(device, select, counter):
    """A point with a NaN coordinate is in no ball (d <= r² is false), as
    in the plain version, and a NaN centroid's ball is empty."""
    pts = _cloud(33, 2, 500, device)
    pts[0, 7, 1] = float("nan")
    pts[1, 499] = float("nan")
    cents = pts[:, :100].contiguous()
    before = _kernels.LAUNCHES[counter]
    idx, in_ball = ball_query_raw(cents, pts, 0.3, 32, select=select)
    assert _kernels.LAUNCHES[counter] == before + 1
    want_idx, want_in = ball_query_plain(cents, pts, 0.3, 32)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)
    assert not bool(in_ball[0, 7].any())
    assert not bool(((idx[0] == 7) & in_ball[0]).any())


def test_ball_query_two_level_kernel_takes_distances_above_1e7(device):
    """No finite sentinel: a cloud 5 km across (d² up to 7.5e7) orders its
    members by distance like any other."""
    pts = _cloud(34, 2, 600, device) * 5000.0
    _assert_ball_query_2l(pts[:, :64].contiguous(), pts, 9000.0, 32)


@pytest.mark.parametrize("B,N,M", [(8, 4096, 1024), (8, 64, 16), (3, 3000, 1000),
                                   (2, 5000, 3)])
def test_three_nn_kernel_matches_plain(device, B, N, M):
    tgt = _cloud(6, B, N, device)
    src = _cloud(7, B, M, device, dup_from=M - M // 3 if M > 3 else None)
    before = _kernels.LAUNCHES["three_nn"]
    d2, idx = three_nn(tgt, src)
    assert _kernels.LAUNCHES["three_nn"] == before + 1
    want_d2, want_idx = three_nn_plain(tgt, src)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(d2, want_d2, rtol=0, atol=0)


def test_three_nn_kernel_mask_matches_plain(device):
    tgt, src = _cloud(8, 2, 700, device), _cloud(9, 2, 90, device)
    mask = torch.rand((2, 90), generator=torch.Generator().manual_seed(10)).to(device) > 0.4
    d2, idx = three_nn(tgt, src, src_mask=mask)
    want_d2, want_idx = three_nn_plain(tgt, src, src_mask=mask)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(d2, want_d2, rtol=0, atol=0)


def _features(seed, B, N, F, device, dup_from=None):
    """Activation-like rows: LeakyReLU(0.2) of normal draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    x = np.where(x > 0, x, np.float32(0.2) * x)
    if dup_from is not None:
        x[:, dup_from:] = x[:, : N - dup_from]
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("select,counter", [("flat", "knn"), ("two_level", "knn_2l")])
@pytest.mark.parametrize("B,N,F,k,dup", [(8, 4096, 3, 20, False), (8, 4096, 64, 20, False),
                                         (2, 1000, 64, 20, True), (3, 333, 7, 32, True),
                                         (1, 40, 130, 5, False), (2, 64, 3, 1, False)])
def test_knn_kernels_match_plain(device, select, counter, B, N, F, k, dup):
    x = _features(20, B, N, F, device, dup_from=N - N // 4 if dup else None)
    before = dict(_kernels.LAUNCHES)
    got = knn_indices(x, k, select=select)
    assert _kernels.LAUNCHES[counter] == before[counter] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    torch.testing.assert_close(got, knn_indices_plain(x, k), rtol=0, atol=0)


@pytest.mark.parametrize("depth", [1, 4, 5])
def test_two_level_knn_is_exact_at_every_depth(device, depth):
    # shallow stacks and repeated points force the rescan
    x = _features(21, 2, 2048, 16, device, dup_from=1024)
    want = knn_indices(x, 20, select="flat")
    got = _knn_cuda(x, 20, "two_level", depth)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_knn_on_clustered_columns_refills_one_lane(device):
    """All of a row's neighbours in one lane (columns 32 w) of the
    two-level kernel: every round past the stack depth rescans."""
    rng = np.random.default_rng(22)
    x = rng.normal(size=(1, 2048, 8)).astype(np.float32) * 10
    x[0, ::32] = rng.normal(size=(64, 8)).astype(np.float32) * 0.01
    x = torch.from_numpy(x).to(device)
    want = knn_indices_plain(x, 20)
    assert bool((want[0, 0] % 32 == 0).all())
    for select in ("flat", "two_level"):
        torch.testing.assert_close(knn_indices(x, 20, select=select), want, rtol=0, atol=0)


@pytest.mark.parametrize("select,counter,depth", [("flat", "knn", 4), ("two_level", "knn_2l", 4),
                                                  ("two_level", "knn_2l", 1)])
@pytest.mark.parametrize("B,N,F,k,keep,dup", [(2, 300, 5, 6, 0.7, False),
                                              (8, 4096, 64, 20, 0.8, False),
                                              (2, 1000, 16, 20, 0.5, True),
                                              (3, 200, 3, 20, 0.05, False)])
def test_knn_kernels_take_mask_and_no_self(device, select, counter, depth, B, N, F, k, keep, dup):
    """`mask` and `include_self=False` run in the kernels and equal the
    plain version slot for slot, masked rows and rows with fewer than k
    points left (keep 0.05: about 10 of 200) included."""
    x = _features(23, B, N, F, device, dup_from=N - N // 4 if dup else None)
    mask = torch.rand((B, N), generator=torch.Generator().manual_seed(1)).to(device) < keep
    for kwargs in ({"mask": mask}, {"include_self": False},
                   {"mask": mask, "include_self": False}):
        before = dict(_kernels.LAUNCHES)
        if depth == 4:
            got = knn_indices(x, k, select=select, **kwargs)
        else:
            got = _knn_cuda(x, k, select, depth, **kwargs)
        assert _kernels.LAUNCHES[counter] == before[counter] + 1
        assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
        torch.testing.assert_close(got, knn_indices_plain(x, k, **kwargs), rtol=0, atol=0)
    if keep > 0.3:
        own = torch.arange(N, device=device)[None, :, None]
        assert not bool((knn_indices(x, k, select=select, include_self=False) == own).any())


@pytest.mark.parametrize("select", ["flat", "two_level"])
def test_knn_kernels_stay_in_bounds_on_nan_rows(device, select):
    """A NaN point (a diverged activation) ranks last for everybody, its
    own list included, as in the plain version's sort; every index stays
    in [0, N), so the gather that follows reads valid rows."""
    x = _features(26, 2, 500, 8, device)
    x[0, 7] = float("nan")
    x[1, 499, 3] = float("nan")
    got = knn_indices(x, 20, select=select)
    assert int(got.min()) >= 0 and int(got.max()) < 500
    torch.testing.assert_close(got, knn_indices_plain(x, 20), rtol=0, atol=0)
    assert not bool((got[0, 8:] == 7).any()) and not bool((got[1, :499] == 499).any())
    gathered = gather_rows(x, got)
    torch.cuda.synchronize()
    assert gathered.shape == (2, 500, 20, 8)


@pytest.mark.parametrize("B,N,M,C", [(8, 4096, 81920, 64), (8, 4096, 81920, 128),
                                     (8, 1024, 8192, 35), (2, 100, 7, 3), (1, 5, 33, 4)])
def test_gather_rows_kernel_matches_plain_forward_and_backward(device, B, N, M, C):
    rng = np.random.default_rng(24)
    table = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, N, (B, M // 4, 4)).astype(np.int32)).to(device)
    weight = torch.from_numpy(rng.normal(size=(B, M // 4, 4, C)).astype(np.float32)).to(device)
    before = _kernels.LAUNCHES["gather_rows"]
    t1 = table.clone().requires_grad_(True)
    got = gather_rows(t1, idx)
    assert _kernels.LAUNCHES["gather_rows"] == before + 1
    t2 = table.clone().requires_grad_(True)
    want = gather_rows_plain(t2, idx)
    assert got.shape == (B, M // 4, 4, C)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (got * weight).sum().backward()
    (want * weight).sum().backward()
    # both sum the same terms with atomics, in an order that changes
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-4, atol=1e-4)
    # int64 indices and a table slice that is not 16-byte aligned
    torch.testing.assert_close(gather_rows(table, idx.long()), want.detach(), rtol=0, atol=0)
    if C % 4 == 0 and N > 1:
        odd = table.reshape(-1)[1:1 + B * (N - 1) * C].reshape(B, N - 1, C)
        small = idx.clamp(max=N - 2)
        torch.testing.assert_close(gather_rows(odd, small), gather_rows_plain(odd, small),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("name,kwargs", [
    ("DeepGraphCnn", {}), ("DeepGraphCnn", {"static_graph": True}),
    ("DGCNN", {"knn_select": "two_level"})])
def test_dgcnn_on_the_card_matches_the_cpu(device, name, kwargs):
    """Eval logits through the kernels against the plain versions on the
    CPU. Feature-space graphs (conv2-4) can flip a neighbour where the
    card's matmuls round another way, so the dynamic graph is held to
    "nearly every point" and the static graph, xyz only, to 1e-4."""
    torch.manual_seed(0)
    model = create_model(name, **kwargs).eval()
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.random((2, 2048, 9)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(device)(x.to(device)).cpu()
    if kwargs.get("static_graph"):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        moved = ((got - want).abs() > 1e-4 + 1e-4 * want.abs()).any(dim=-1)
        assert float(moved.float().mean()) < 0.02


@pytest.mark.parametrize("name,kwargs", [
    ("PointNet++", {}), ("PointNet++", {"ball_select": "two_level"}),
    ("PointNeXt", {"ball_select": "two_level"}), ("PointNeXt-B", {"filler": "index"}),
    ("PointNet++MSG", {"ball_select": "two_level", "filler": "index"})])
def test_model_on_the_card_matches_the_cpu(device, name, kwargs):
    """Eval logits through the kernels match the plain versions' on the
    CPU with the same weights (matmul and reduction order differ)."""
    torch.manual_seed(0)
    model = create_model(name, **kwargs).eval()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((2, 2048, 9)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(device)(x.to(device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
