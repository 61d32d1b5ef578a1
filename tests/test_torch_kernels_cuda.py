"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine without it run it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The kernels compute distances and scores with the plain versions'
rounding, so indices, `in_ball` and the 3-NN distances must be equal, not
close; the gathers move bits, so their rows are equal too. Only the
batched gather's gradient (atomic adds on the card) is compared to a
tolerance.
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
from pointseg_torch.ops.fps import (
    _fps_cuda,
    farthest_point_sampling,
    farthest_point_sampling_plain,
)
from pointseg_torch.ops.gather import (
    gather_rows,
    gather_rows_flat,
    gather_rows_flat_plain,
    gather_rows_plain,
    gather_rows_with_coords,
)
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


# The training stages, a ragged cloud, the eval buckets; N = 37, 1100,
# 4099 and 4096 with C = N; each power of two from 128 to 8192 (P x threads
# of the register path at every block size) and one past it, 12,288 and
# 12,289 (the shared-memory path's end) and 65,536 (global memory); C = 1,
# one cloud and 64 clouds.
FPS_CASES = [(8, 4096, 1024), (8, 64, 16), (3, 3000, 1000), (2, 16384, 1024), (2, 37, 37),
             (2, 1100, 300), (2, 4099, 1024), (2, 4096, 4096), (1, 65536, 1024), (1, 4096, 1),
             (64, 1024, 256), (1, 4096, 1024)]
FPS_CASES += [(2, n + extra, 200) for n in (128, 256, 512, 1024, 2048, 4096, 8192, 12288)
              for extra in (0, 1)]


@pytest.mark.parametrize("B,N,C", FPS_CASES)
def test_fps_kernel_matches_plain(device, B, N, C):
    pts = _cloud(0, B, N, device, dup_from=N - N // 4)
    start = torch.arange(B, dtype=torch.int32, device=device) * 7 % N
    before = _kernels.LAUNCHES["fps"]
    got = farthest_point_sampling(pts, C, start_indices=start)
    assert _kernels.LAUNCHES["fps"] == before + 1
    want = farthest_point_sampling_plain(pts, C, start)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024, -1])
@pytest.mark.parametrize("points", [1, 2, 4, 8, 16, 32])
def test_fps_register_path_matches_plain_at_every_block_size(device, threads, points):
    """Forced block sizes, each at P x threads points and one fewer (a
    thread with a slot past the cloud); a P over the block size's register
    budget is refused. -1: the shared-memory kernel at the same clouds."""
    if threads == -1:
        threads, forced = 256, -1
    else:
        forced = threads
    if forced > 0 and points > (16 if threads >= 512 else 32):
        with pytest.raises(torch.cuda.CudaError):
            _fps_cuda(_cloud(1, 1, points * threads, device), 8,
                      torch.zeros(1, dtype=torch.int32, device=device), None, threads)
        return
    for N in (points * threads, points * threads - 1):
        pts = _cloud(1, 2, N, device, dup_from=N - N // 4)
        start = torch.tensor([0, N - 1], dtype=torch.int32, device=device)
        C = min(N, 300)
        got = _fps_cuda(pts, C, start, None, forced)
        torch.testing.assert_close(got, farthest_point_sampling_plain(pts, C, start),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("N", [100, 4096, 16384])
def test_fps_kernel_on_identical_points_picks_the_lowest_index(device, N):
    """Every distance ties: after the start, every step picks index 0."""
    pts = torch.full((2, N, 3), 0.25, device=device)
    start = torch.tensor([5, N - 1], dtype=torch.int32, device=device)
    got = farthest_point_sampling(pts, 50, start_indices=start)
    torch.testing.assert_close(got, farthest_point_sampling_plain(pts, 50, start), rtol=0, atol=0)
    assert bool((got[:, 1:] == 0).all())


@pytest.mark.parametrize("B,N,C", [(4, 500, 100), (2, 4096, 1024), (2, 6000, 512),
                                   (2, 16384, 256)])
def test_fps_kernel_mask_matches_plain(device, B, N, C):
    pts = _cloud(1, B, N, device)
    mask = torch.rand((B, N), generator=torch.Generator().manual_seed(2)).to(device) > 0.3
    start = mask.int().argmax(dim=1).to(torch.int32)
    got = farthest_point_sampling(pts, C, mask=mask)
    torch.testing.assert_close(got, farthest_point_sampling_plain(pts, C, start, mask),
                               rtol=0, atol=0)


@pytest.mark.parametrize("N,C", [(300, 40), (4096, 1024), (16384, 1024)])
def test_fps_kernel_with_exactly_c_valid_points_picks_them_all(device, N, C):
    """A mask that leaves exactly C points, the start at the last index
    (masked out, so the first valid point starts): the C picks are those
    points, in the plain version's order."""
    pts = _cloud(3, 2, N, device)
    mask = torch.zeros((2, N), dtype=torch.bool, device=device)
    for b in range(2):
        mask[b, torch.randperm(N - 1, generator=torch.Generator().manual_seed(b))[:C]] = True
    start = torch.full((2,), N - 1, dtype=torch.int32, device=device)
    first_valid = mask.int().argmax(dim=1).to(torch.int32)
    got = farthest_point_sampling(pts, C, start_indices=first_valid, mask=mask)
    torch.testing.assert_close(got, farthest_point_sampling_plain(pts, C, first_valid, mask),
                               rtol=0, atol=0)
    for b in range(2):
        assert torch.equal(got[b].sort().values.long(), torch.nonzero(mask[b])[:, 0])
    last = farthest_point_sampling(pts, C, start_indices=start)  # unmasked, from N - 1
    assert int(last[0, 0]) == N - 1
    torch.testing.assert_close(last, farthest_point_sampling_plain(pts, C, start), rtol=0, atol=0)


def test_fps_kernel_is_captured_by_a_cuda_graph_and_replayed_on_new_input(device):
    clouds = [_cloud(4 + i, 8, 4096, device) for i in range(2)]
    start = torch.zeros(8, dtype=torch.int32, device=device)
    inp = clouds[0].clone()
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):  # warm-up off the default stream
        farthest_point_sampling(inp, 1024, start_indices=start)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = farthest_point_sampling(inp, 1024, start_indices=start)
    for x in (clouds[1], clouds[0]):
        inp.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, farthest_point_sampling_plain(x, 1024, start))


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


@pytest.mark.parametrize("B,N,F,k", [
    (2, 4099, 64, 20), (1, 37, 64, 20), (1, 37, 3, 20), (2, 500, 1, 20), (2, 500, 3, 1),
    (2, 500, 6, 32), (2, 500, 9, 20), (2, 300, 64, 32), (2, 500, 67, 20), (2, 500, 128, 20),
    (1, 700, 128, 1), (2, 400, 8, 20), (2, 400, 12, 32), (1, 130, 132, 7), (1, 200, 384, 20),
    (8, 1100, 64, 20), (8, 1100, 9, 20), (5, 4099, 3, 32)])
def test_knn_flat_kernel_tile_edges_match_plain_and_two_level(device, B, N, F, k):
    """What the flat kernel's register tile can get wrong: N no multiple of
    the 128-candidate tile or of a block's query rows, row widths on the
    16-byte path (multiples of 4) and on the 4-byte path, more than one
    64-feature chunk, the widest F, k = 1 and 32, and batches small enough
    that a warp takes four or two query rows ((8, 1100): four). With and
    without `mask` and `include_self=False`; the tail repeats the head."""
    x = _features(27, B, N, F, device, dup_from=N - N // 4)
    mask = torch.rand((B, N), generator=torch.Generator().manual_seed(3)).to(device) < 0.8
    mask[0, 10:] = False  # a cloud with fewer than k points left
    for kwargs in ({}, {"mask": mask}, {"include_self": False},
                   {"mask": mask, "include_self": False}):
        want = knn_indices_plain(x, k, **kwargs)
        before = dict(_kernels.LAUNCHES)
        got = knn_indices(x, k, **kwargs)
        assert _kernels.LAUNCHES["knn"] == before["knn"] + 1
        assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(knn_indices(x, k, select="two_level", **kwargs), want,
                                   rtol=0, atol=0)


def test_knn_flat_kernel_on_rows_that_are_not_16_byte_aligned(device):
    """F % 4 == 0 at an address 4 bytes past a 16-byte boundary takes the
    4-byte path and gives the same lists."""
    x = _features(28, 2, 400, 8, device)
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view_as(x).copy_(x)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(knn_indices(shifted, 20), knn_indices_plain(x, 20), rtol=0, atol=0)


def _launch_cases(device):
    """(name, kernel call, plain call, two inputs) for kernels 8 and 4."""
    gen = torch.Generator(device).manual_seed(43)
    table = torch.rand((240_000, 9), device=device, generator=gen)
    rows = [torch.randint(0, 240_000, (8 * 4096,), device=device, generator=gen)
            for _ in range(2)]
    clouds = [_features(29 + i, 2, 1024, 64, device) for i in range(2)]
    return [("gather_rows_flat", lambda i: gather_rows_flat(table, i),
             lambda i: gather_rows_flat_plain(table, i), rows),
            ("knn", lambda x: knn_indices(x, 20), lambda x: knn_indices_plain(x, 20), clouds)]


def test_kernels_launch_on_the_current_stream_not_the_default_one(device):
    """Under `torch.cuda.stream(side)` the input is written behind a long
    wait on `side`; a launch that went to another stream would read it
    before it is there."""
    side = torch.cuda.Stream(device)
    for name, kernel_fn, plain_fn, (first, _) in _launch_cases(device):
        want = plain_fn(first)
        inp = torch.zeros_like(first)
        torch.cuda.synchronize()
        before = _kernels.LAUNCHES[name]
        with torch.cuda.stream(side):
            torch.cuda._sleep(40_000_000)
            inp.copy_(first)
            got = kernel_fn(inp)
        side.synchronize()
        assert _kernels.LAUNCHES[name] == before + 1
        assert torch.equal(got, want), name


def test_kernels_are_captured_by_a_cuda_graph_and_replayed_on_new_input(device):
    side = torch.cuda.Stream(device)
    for name, kernel_fn, plain_fn, (first, second) in _launch_cases(device):
        inp = first.clone()
        with torch.cuda.stream(side):  # warm-up off the default stream
            kernel_fn(inp)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kernel_fn(inp)
        for x in (second, first):
            inp.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, plain_fn(x)), name


def test_launch_makes_another_device_current_only_for_the_call(device):
    """With two cards: a tensor on the second one while the first is
    current launches there and leaves the first current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    table = torch.rand((1000, 9), device=other)
    idx = torch.randint(0, 1000, (333,), device=other)
    assert torch.cuda.current_device() == 0
    got = gather_rows_flat(table, idx)
    assert torch.cuda.current_device() == 0 and got.device == other
    assert torch.equal(got, gather_rows_flat_plain(table, idx))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,N,M,C", [(8, 4096, 81920, 64), (8, 4096, 81920, 128),
                                     (8, 1024, 8192, 35), (2, 100, 7, 3), (1, 5, 33, 4),
                                     (8, 256, 2048, 131), (8, 64, 512, 259)])
def test_gather_rows_kernel_matches_plain_forward_and_backward(device, B, N, M, C, dtype):
    """Rows of every byte width the kernel copies in (16, 8, 4 and 2-byte
    units); the backward in float32, where both sides add with atomics."""
    rng = np.random.default_rng(24)
    table = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(device, dtype)
    idx = torch.from_numpy(rng.integers(0, N, (B, M // 4, 4)).astype(np.int32)).to(device)
    weight = torch.from_numpy(rng.normal(size=(B, M // 4, 4, C)).astype(np.float32)).to(device)
    before = dict(_kernels.LAUNCHES)
    t1 = table.clone().requires_grad_(True)
    got = gather_rows(t1, idx)
    assert _kernels.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    t2 = table.clone().requires_grad_(True)
    want = gather_rows_plain(t2, idx)
    assert got.shape == (B, M // 4, 4, C) and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    if dtype == torch.float32:
        (got * weight).sum().backward()
        (want * weight).sum().backward()
        # both sum the same terms with atomics, in an order that changes
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-4, atol=1e-4)
    # int64 indices, a table that needs no gradient, and one under no_grad
    assert torch.equal(gather_rows(table, idx.long()), want)
    with torch.no_grad():
        assert torch.equal(gather_rows(t1, idx), want)
    if N > 1:  # a table slice that is not 16-byte aligned: narrower units, same rows
        odd = table.reshape(-1)[1:1 + B * (N - 1) * C].reshape(B, N - 1, C)
        small = idx.clamp(max=N - 2)
        assert odd.data_ptr() % 16 != 0
        assert torch.equal(gather_rows(odd, small), gather_rows_plain(odd, small))
    # a table that is not contiguous is copied first, and gives the same rows
    wide = torch.cat([table, table[..., :1]], dim=-1)[..., :C]
    assert not wide.is_contiguous() and torch.equal(gather_rows(wide, idx), want)


# SetAbstraction groupings: (N, h, centroids, K) of PointNet++, MSG and PointNeXt
SA_GROUPINGS = [(4096, 32, 1024, 32), (1024, 64, 256, 32), (256, 128, 64, 32), (64, 256, 16, 32),
                (4096, 16, 1024, 16), (1024, 64, 1024, 32), (16, 512, 16, 16), (5, 7, 3, 4)]


@pytest.mark.parametrize("features_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,h,C,K", SA_GROUPINGS)
def test_gather_rows_with_coords_is_one_launch_equal_to_the_concat_form(device, N, h, C, K,
                                                                     features_dtype):
    """Both outputs bit-equal to gathering the concatenated table (the
    JAX package's form; for bf16 features, to two gathers), contiguous, in
    one launch; `coords.grad` None, and in float32 `features.grad` equal to
    autograd of `torch.gather` to 1e-4 (atomic adds on both sides)."""
    rng = np.random.default_rng(25)
    B = 8
    feats = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(device)
    feats = feats.to(features_dtype)
    coords = _cloud(26, B, N, device)
    idx = torch.from_numpy(rng.integers(0, N, (B, C, K)).astype(np.int32)).to(device)
    weight = torch.from_numpy(rng.normal(size=(B, C, K, h)).astype(np.float32)).to(device)
    tf, tc = feats.clone().requires_grad_(True), coords.clone().requires_grad_(True)
    before = dict(_kernels.LAUNCHES)
    gf, gc = gather_rows_with_coords(tf, tc, idx)
    assert _kernels.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    if features_dtype == torch.float32:
        rows = gather_rows_plain(torch.cat([feats, coords], dim=-1), idx)
        want_f, want_c = rows[..., :h], rows[..., h:]
    else:
        want_f, want_c = gather_rows_plain(feats, idx), gather_rows_plain(coords, idx)
    assert gf.is_contiguous() and gc.is_contiguous() and not gc.requires_grad
    assert torch.equal(gf, want_f) and torch.equal(gc, want_c)
    if features_dtype == torch.float32:
        (gf * weight).sum().backward()
        ref = feats.clone().requires_grad_(True)
        (gather_rows_plain(ref, idx) * weight).sum().backward()
        torch.testing.assert_close(tf.grad, ref.grad, rtol=1e-4, atol=1e-4)
    assert tc.grad is None
    # int64 indices and coordinates that are a view of wider rows, as the
    # first stage's input is
    points = torch.cat([coords, coords * 2, coords * 3], dim=-1)
    with torch.no_grad():
        again = gather_rows_with_coords(tf, points[..., :3], idx.long())
    assert torch.equal(again[0], want_f) and torch.equal(again[1], want_c)


@pytest.mark.parametrize("Mrows", [8 * 4096, 32769, 1])
@pytest.mark.parametrize("shape,dtype", [((240_000,), torch.uint8), ((240_000, 4), torch.int32),
                                         ((240_000, 9), torch.float32),
                                         ((240_000, 35), torch.float32),
                                         ((5000, 3), torch.uint8), ((5000, 2), torch.int32),
                                         ((5000, 3), torch.float16), ((5000, 8), torch.float64)])
def test_gather_rows_flat_kernel_matches_plain(device, shape, dtype, Mrows):
    """Rows of 1, 16, 36 and 140 bytes (the store's tables and an odd
    width) and of 3, 8, 6 and 64 bytes (every unit the kernel copies in),
    at the sampler's 8 x 4096 rows and at counts that divide nothing."""
    gen = torch.Generator(device).manual_seed(40)
    table = torch.randint(0, 250, shape, device=device, generator=gen).to(dtype)
    idx = torch.randint(0, shape[0], (Mrows,), device=device, generator=gen)
    idx[0], idx[-1] = shape[0] - 1, 0
    before = dict(_kernels.LAUNCHES)
    got = gather_rows_flat(table, idx)
    assert _kernels.LAUNCHES["gather_rows_flat"] == before["gather_rows_flat"] + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    want = gather_rows_flat_plain(table, idx)
    assert got.shape == (Mrows, *shape[1:]) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(gather_rows_flat(table, idx.int()), want)  # converted once, to int64
    if len(shape) == 2:  # a view that starts one element in: narrower alignment, same rows
        shifted = table.reshape(-1)[1:1 + (shape[0] - 1) * shape[1]].reshape(shape[0] - 1, shape[1])
        small = idx.clamp(max=shape[0] - 2)
        assert torch.equal(gather_rows_flat(shifted, small), gather_rows_flat_plain(shifted, small))
        with pytest.raises(ValueError, match="contiguous"):
            gather_rows_flat(table[:, :1], idx)


def test_gather_rows_flat_kernel_past_2_to_the_31_elements(device):
    """240 million rows of nine 4-byte words: 2.16e9 elements, 8.64e9
    bytes. Row r holds r + column, so the rows wanted are known without
    a second table; the last rows lie past both 2^31 elements and 2^32
    bytes."""
    T = 240_000_000
    table = torch.empty((T, 9), dtype=torch.int32, device=device)
    cols = torch.arange(9, dtype=torch.int32, device=device)
    for start in range(0, T, 20_000_000):
        rows = torch.arange(start, min(start + 20_000_000, T), dtype=torch.int32, device=device)
        table[start:start + rows.shape[0]] = rows[:, None] + cols
    gen = torch.Generator(device).manual_seed(41)
    idx = torch.randint(0, T, (8 * 4096,), device=device, generator=gen)
    idx[:4] = torch.tensor([0, T - 1, 2**31 // 9 + 1, 2**32 // 36 + 1], device=device)
    got = gather_rows_flat(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, idx[:, None].int() + cols)
    assert torch.equal(got, gather_rows_flat_plain(table, idx))


@pytest.mark.parametrize("bad", [-1, 1000, 2**40])
def test_gather_rows_flat_kernel_traps_on_an_index_outside_the_table(device, bad):
    """An index outside [0, R) is never dereferenced: the kernel traps and
    the next synchronisation raises. A trap ends the process's CUDA
    context, so the launch runs in a process of its own."""
    import subprocess
    import sys

    script = (
        "import torch\n"
        "from pointseg_torch.ops.gather import gather_rows_flat\n"
        "table = torch.zeros((1000, 4), device='cuda')\n"
        "good = gather_rows_flat(table, torch.tensor([0, 999], device='cuda'))\n"
        "torch.cuda.synchronize()\n"
        "print('good launch ok', flush=True)\n"
        f"gather_rows_flat(table, torch.tensor([0, {bad}], device='cuda'))\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, flush=True)\n"
        "else:\n"
        "    print('no error', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert "good launch ok" in out.stdout, out.stdout + out.stderr
    assert "raised" in out.stdout and "no error" not in out.stdout, out.stdout + out.stderr


def test_device_stores_sample_the_same_batches_on_the_card_as_on_the_cpu(device):
    """Both stores through kernel 8 on the card against the plain path on
    the CPU, from the same block ids and uniforms: bit-equal, and
    compact equal to flat."""
    from pointseg_torch.data import device as dev
    from pointseg_torch.data.blocks import augment_points

    rng = np.random.default_rng(42)
    counts = rng.integers(1, 5000, size=40)
    counts[3] = 1
    raw = np.empty((int(counts.sum()), 6), np.float32)
    raw[:, :3] = rng.uniform(0, 30, size=(raw.shape[0], 3))
    raw[:, 3:] = rng.integers(0, 256, size=(raw.shape[0], 3))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pts = np.concatenate([augment_points(raw[a:b]) for a, b in zip(offsets[:-1], offsets[1:])])
    labs = rng.integers(0, 14, size=pts.shape[0]).astype(np.uint8)
    ids = torch.tensor([0, 3, -1, 17, 39, 5, 5, 21])
    u = torch.from_numpy(rng.random((8, 4096)).astype(np.float32))
    u[:, 0], u[:, 1] = 0.0, float(np.nextafter(np.float32(1), np.float32(0)))
    batches = {}
    for cls in (dev.DeviceBlockStore, dev.CompactDeviceStore):
        for where in (torch.device("cpu"), device):
            store = cls(pts, labs, counts, num_classes=14, device=where)
            before = _kernels.LAUNCHES["gather_rows_flat"]
            batches[cls, where.type] = store.sample_from(ids.to(where), u.to(where))
            launched = _kernels.LAUNCHES["gather_rows_flat"] - before
            assert launched == (0 if where.type == "cpu" else
                                2 if cls is dev.DeviceBlockStore else 1)
    want = batches[dev.DeviceBlockStore, "cpu"]
    for got in batches.values():
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


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
