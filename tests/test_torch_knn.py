"""pointseg_torch's kNN, graph features and row gather against pointseg's
on the CPU, same numpy inputs.

The port's plain version sums the F-term Gram product term by term; XLA
sums it in its own order (and the Pallas kernels, in interpret mode, by
a matrix product), so two neighbours whose scores differ in the last
bits may swap. kNN is therefore compared as sets per row, plus an order
check that allows a differing slot only where the float64 squared
distances of the two picks differ by less than TIE (1e-5, relative to
1 + d²). Exact ties (repeated points) must resolve to the lowest index
in both, which the set + order check covers: a repeated point's copies
have the same float64 distance, and the explicit test below demands
index equality there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointseg import ops as jops
from pointseg.ops.dispatch import set_use_pallas
from pointseg.ops.pallas.knn import knn_indices_pallas, knn_indices_pallas_2l
from pointseg_torch import ops as tops
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.gather import gather_rows_plain
from pointseg_torch.ops.ballquery import TWO_LEVEL_DEPTH
from pointseg_torch.ops.knn import default_depth, knn_indices_plain

torch.set_num_threads(2)

TIE = 1e-5


@pytest.fixture(autouse=True)
def _jax_oracle_unless_called_directly():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


def _activations(seed, B, N, F):
    """LeakyReLU(0.2) of normal draws: what conv2-4 select on."""
    x = np.random.default_rng(seed).normal(size=(B, N, F)).astype(np.float32)
    return np.where(x > 0, x, np.float32(0.2) * x)


def _assert_same_neighbours(x, got, want):
    """Equal sets per row; a slot may differ only between near-ties."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    x64 = x.astype(np.float64)
    b = np.arange(x.shape[0])[:, None, None]
    d_got = ((x64[b, got] - x64[:, :, None, :]) ** 2).sum(-1)
    d_want = ((x64[b, want] - x64[:, :, None, :]) ** 2).sum(-1)
    differs = got != want
    assert np.all(np.abs(d_got - d_want)[differs] < TIE * (1 + d_want[differs]))
    return int(differs.sum())


@pytest.mark.parametrize("B,N,F,k", [(2, 256, 3, 8), (2, 1024, 3, 20), (2, 512, 64, 20),
                                     (3, 300, 16, 12), (1, 64, 5, 64)])
def test_knn_matches_jax_oracle(B, N, F, k):
    x = _activations(0, B, N, F)
    want = jops.knn_indices(jnp.asarray(x), k)
    got = tops.knn_indices(torch.from_numpy(x), k)
    swapped = _assert_same_neighbours(x, got.numpy(), want)
    assert swapped <= 0.002 * got.numel()
    # self is the nearest: the score of a row against itself is exactly 0
    np.testing.assert_array_equal(got[..., 0].numpy(), np.broadcast_to(np.arange(N), (B, N)))


@pytest.mark.parametrize("pallas", ["flat", "two_level"])
def test_knn_matches_pallas_kernels_in_interpret_mode(pallas):
    """The one port call (its plain version on a CPU tensor) against the
    JAX package's flat and two-level Pallas kernels in interpret mode."""
    x = _activations(1, 2, 256, 8)
    with pltpu.force_tpu_interpret_mode():
        if pallas == "flat":
            want = knn_indices_pallas(jnp.asarray(x), 6, tile=64)
        else:
            want = knn_indices_pallas_2l(jnp.asarray(x), 6, tile=128, seg=128)
    got = tops.knn_indices(torch.from_numpy(x), 6)
    _assert_same_neighbours(x, got.numpy(), want)


# Shapes that the flat CUDA kernel's tiles treat differently (its plain
# version is what runs here): N below one 128-candidate tile (37) and no
# multiple of a tile or of a block's 64 query rows (131, standing for the
# card's 4099), row widths on its 4-byte path (1, 3, 6, 9, 67), on its
# 16-byte path (64, 128) and past one 64-feature chunk (67, 128), k = 1 and
# k = 32, one cloud.
TILE_EDGE_SHAPES = [(1, 37, 64, 20), (2, 131, 64, 20), (2, 131, 1, 20), (2, 131, 3, 20),
                    (2, 131, 6, 20), (2, 131, 9, 20), (2, 131, 67, 20), (2, 131, 64, 1),
                    (2, 131, 64, 32), (1, 131, 9, 32), (1, 131, 128, 20)]


@pytest.mark.parametrize("options", ["plain", "mask", "no_self", "mask_no_self"])
@pytest.mark.parametrize("B,N,F,k", TILE_EDGE_SHAPES)
def test_knn_tile_edge_shapes_equal_the_jax_oracle(B, N, F, k, options):
    """Indices equal, not only as sets. XLA sums the Gram product in its
    own order, so at a large N some input seeds swap a near-tie; at these
    sizes seeds 0, 1 and 2 all agree for every shape and option (searched),
    and seed 0 is pinned. After a change to the score arithmetic, search
    again before loosening anything."""
    x = _activations(0, B, N, F)
    mask = np.random.default_rng(1000).random((B, N)) > 0.3
    kw_j, kw_t = {}, {}
    if "mask" in options:
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if "no_self" in options:
        kw_j["include_self"] = kw_t["include_self"] = False
    want = np.asarray(jops.knn_indices(jnp.asarray(x), k, **kw_j))
    before = dict(_kernels.LAUNCHES)
    got = tops.knn_indices(torch.from_numpy(x), k, **kw_t).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert _kernels.LAUNCHES == before
    if "no_self" in options:
        assert not (want == np.arange(N)[None, :, None]).any()


@pytest.mark.parametrize("B,N,F,k", [(2, 256, 9, 32), (2, 256, 67, 20)])
def test_knn_tile_edge_shapes_equal_the_pallas_kernels_in_interpret_mode(B, N, F, k):
    """Two of the added widths (the 4-byte path; past one feature chunk)
    against both Pallas kernels, which need N % 128 == 0. Seed 0 pinned as
    above (seeds 0-2 agree)."""
    x = _activations(0, B, N, F)
    with pltpu.force_tpu_interpret_mode():
        flat = np.asarray(knn_indices_pallas(jnp.asarray(x), k, tile=64))
        two_level = np.asarray(knn_indices_pallas_2l(jnp.asarray(x), k, tile=128, seg=128))
    got = tops.knn_indices(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, flat)
    np.testing.assert_array_equal(got, two_level)


def test_knn_cuda_limits_are_the_kernels():
    """`MAX_K` and `MAX_F` are what the flat kernel of `csrc/knn.cu` can
    take: one list slot a lane, and a block's 64 query rows held whole in
    shared memory beside two 128-candidate tiles. Past them the shape rule
    runs the two-level kernel, which stages the query rows 64 features at
    a time: its shared memory does not grow with F, so it takes any F."""
    from pointseg_torch.ops import knn as knn_module

    shared = 227 * 1024
    flat = lambda F: 4 * (64 * F + 64 + 2 * 128 + 2 * 128 * 68)  # noqa: E731
    two_level = lambda F: 4 * ((2 if F > 64 else 1) * 32 * 64 + 2 * 128 + 2 * 128 * 68)  # noqa
    assert knn_module.MAX_K == 32
    assert flat(knn_module.MAX_F) <= shared and flat(631) <= shared < flat(632)
    assert two_level(10**6) == two_level(65) <= shared // 2


def test_knn_repeated_points_resolve_to_the_lowest_index():
    """Coordinates on a 1/8 grid, the tail repeating the head: many exact
    ties, and every product and sum is exact in float32 whatever its
    order, so the two packages must give equal indices."""
    rng = np.random.default_rng(2)
    x = (np.round(rng.normal(size=(2, 512, 3)) * 8) / 8).astype(np.float32)
    x[:, 384:] = x[:, :128]
    want = np.asarray(jops.knn_indices(jnp.asarray(x), 20))
    got = tops.knn_indices(torch.from_numpy(x), 20).numpy()
    np.testing.assert_array_equal(got, want)
    # a point and its copy are at distance 0 from both: lowest index first
    np.testing.assert_array_equal(got[:, 384:, 0], np.broadcast_to(np.arange(128), (2, 128)))


def test_knn_mask_and_include_self_match_jax():
    x = _activations(3, 2, 300, 6)
    mask = np.random.default_rng(4).random((2, 300)) > 0.3
    want = jops.knn_indices(jnp.asarray(x), 9, mask=jnp.asarray(mask))
    got = tops.knn_indices(torch.from_numpy(x), 9, mask=torch.from_numpy(mask))
    _assert_same_neighbours(x, got.numpy(), want)
    assert mask[np.arange(2)[:, None, None], got.numpy()].all()  # never a masked neighbour

    want = jops.knn_indices(jnp.asarray(x), 9, include_self=False)
    got = tops.knn_indices(torch.from_numpy(x), 9, include_self=False)
    _assert_same_neighbours(x, got.numpy(), want)
    assert not (got.numpy() == np.arange(300)[None, :, None]).any()

    both = tops.knn_indices(torch.from_numpy(x), 9, mask=torch.from_numpy(mask),
                            include_self=False)
    want = jops.knn_indices(jnp.asarray(x), 9, mask=jnp.asarray(mask), include_self=False)
    _assert_same_neighbours(x, both.numpy(), want)


def test_knn_plain_blocks_do_not_change_the_result(monkeypatch):
    from pointseg_torch.ops import knn as knn_module

    x = torch.from_numpy(_activations(5, 2, 200, 4))
    want = knn_indices_plain(x, 7, include_self=False)
    monkeypatch.setattr(knn_module, "PLAIN_BLOCK_BYTES", 4 * 2 * 200 * 37)  # 37-row blocks
    torch.testing.assert_close(knn_indices_plain(x, 7, include_self=False), want,
                               rtol=0, atol=0)


def test_knn_argument_checks_and_no_launch_on_the_cpu():
    x = torch.from_numpy(_activations(6, 1, 32, 3))
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(TypeError, match="select"):  # the shape picks the kernel
        tops.knn_indices(x, 4, select="two_level")
    with pytest.raises(ValueError, match="k <= N"):
        tops.knn_indices(x, 33)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        tops.knn_indices(torch.empty((1, 32, 3), device="meta"), 4)
    tops.knn_indices(x, 4)
    assert _kernels.LAUNCHES == before
    assert [default_depth(k) for k in (1, 3, 4, 20, 21, 32)] == [4, 4, 4, 4, 5, 5]


@pytest.mark.parametrize("with_idx,with_knn_on", [(False, False), (True, False), (False, True)])
def test_graph_feature_matches_jax(with_idx, with_knn_on):
    x = _activations(7, 2, 128, 5)
    pos = _activations(8, 2, 128, 3)
    kw_j, kw_t = {}, {}
    if with_idx:
        idx = np.random.default_rng(9).integers(0, 128, (2, 128, 6)).astype(np.int32)
        kw_j["idx"], kw_t["idx"] = jnp.asarray(idx), torch.from_numpy(idx)
    if with_knn_on:
        kw_j["knn_on"], kw_t["knn_on"] = jnp.asarray(pos), torch.from_numpy(pos)
        _assert_same_neighbours(pos, tops.knn_indices(torch.from_numpy(pos), 6).numpy(),
                                jops.knn_indices(jnp.asarray(pos), 6))
    want = np.asarray(jops.graph_feature(jnp.asarray(x), 6, **kw_j))
    got = tops.graph_feature(torch.from_numpy(x), 6, **kw_t)
    assert got.shape == (2, 128, 6, 10)
    # differences and copies of float32 inputs: equal, not close
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,shape", [(64, (40, 20)), (35, (16, 32)), (3, (7,))])
def test_gather_rows_function_and_gradient_match_jax_and_plain(C, shape):
    from pointseg.ops.gather import gather_rows as jax_gather_rows

    rng = np.random.default_rng(10)
    table = rng.normal(size=(2, 50, C)).astype(np.float32)
    idx = rng.integers(0, 50, (2, *shape)).astype(np.int32)
    weight = rng.normal(size=(2, *shape, C)).astype(np.float32)

    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    want_grad = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_gather_rows(t, jnp.asarray(idx)) * weight))(jnp.asarray(table)))

    torch.use_deterministic_algorithms(True)
    try:
        t1 = torch.from_numpy(table).requires_grad_(True)
        got = tops.gather_rows(t1, torch.from_numpy(idx))
        (got * torch.from_numpy(weight)).sum().backward()
        t2 = torch.from_numpy(table).requires_grad_(True)
        plain = gather_rows_plain(t2, torch.from_numpy(idx).long())
        (plain * torch.from_numpy(weight)).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(plain.detach().numpy(), want)
    # a scatter-add of the same float32 terms; the order within a row differs
    np.testing.assert_allclose(t1.grad.numpy(), want_grad, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_gather_rows_refuses_an_index_out_of_range_on_the_cpu():
    table = torch.zeros((1, 4, 2))
    with pytest.raises((RuntimeError, IndexError)):
        tops.gather_rows(table, torch.tensor([[4]]))
    assert tops.gather_neighbors(table, torch.zeros((1, 4, 3), dtype=torch.int32)).shape == (
        1, 4, 3, 2)


# ------------------------------------- a model of the two-level kernel's rules
#
# numpy model of how `knn_two_level_kernel` orders its picks, on the same
# clouds as the plain version, the JAX oracle and the Pallas two-level
# kernel: lane l of a warp owns the columns {32 i + l} (four of each
# 128-wide tile), offered in ascending order; a sorted stack of `depth`
# (score, column) a lane, entered only strictly in front of its last entry
# (-inf never enters); k rounds take the first head by (score desc, column
# asc) and pop it; a lane whose stack ran dry while it owns columns not yet
# consumed is refilled with its best `depth` columns behind the last one
# consumed.


def _two_level_knn_model(x, k, depth, mask=None, include_self=True):
    """(B, N, k) int32 as the two-level kernel picks them; the scores are the
    plain version's bits, -inf where masked, excluded or NaN."""
    from pointseg_torch.ops.knn import _scores, _sqnorm

    xt = torch.from_numpy(x)
    x2 = _sqnorm(xt)
    s = _scores(xt, x2, xt, x2).numpy()
    B, N, _ = x.shape
    s = np.where(np.isnan(s), np.float32(-np.inf), s)
    if mask is not None:
        s = np.where(mask[:, None, :], s, np.float32(-np.inf))
    if not include_self:
        s[:, np.arange(N), np.arange(N)] = -np.inf
    out = np.zeros((B, N, k), np.int32)
    front = lambda a, b: a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])  # noqa: E731
    for b in range(B):
        for row in range(N):
            v = s[b, row].tolist()
            stacks = []
            for lane in range(32):
                stack = []
                for tile in range(0, N, 128):
                    for col in range(tile + lane, min(tile + 128, N), 32):
                        if len(stack) == depth and not v[col] > stack[-1][0]:
                            continue
                        if v[col] == -math.inf:
                            continue
                        at = next((i for i, e in enumerate(stack) if v[col] > e[0]), len(stack))
                        stack = (stack[:at] + [(v[col], col)] + stack[at:])[:depth]
                stacks.append(stack)
            owned = [len(range(lane, N, 32)) for lane in range(32)]
            taken, last = [0] * 32, [None] * 32
            for j in range(k):
                for lane in range(32):
                    if stacks[lane] or taken[lane] >= owned[lane]:
                        continue
                    behind = [(v[c], c) for c in range(lane, N, 32)
                              if last[lane] is None or front(last[lane], (v[c], c))]
                    if behind:  # its best `depth` behind the last consumed
                        stacks[lane] = sorted(behind, key=lambda e: (-e[0], e[1]))[:depth]
                    else:
                        taken[lane] = owned[lane]
                heads = [(st[0], lane) for lane, st in enumerate(stacks) if st]
                (hv, hc), lane = heads[0]
                for (ev, ec), el in heads[1:]:
                    if front((ev, ec), (hv, hc)):
                        (hv, hc), lane = (ev, ec), el
                out[b, row, j] = hc
                last[lane] = stacks[lane].pop(0)
                taken[lane] += 1
    return out


def _grid_cloud(seed, B, N, F):
    """Features on a 1/8 grid, the last quarter repeating the first: every
    product and sum is exact in float32 whatever its order, so all exact
    ties, and the JAX oracle and the Pallas kernel give the same bits."""
    x = (np.round(np.random.default_rng(seed).normal(size=(B, N, F)) * 8) / 8).astype(np.float32)
    x[:, N - N // 4:] = x[:, : N // 4]
    return x


@pytest.mark.parametrize("k", [6, 20, 40])
@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("options", ["plain", "mask", "no_self", "mask_no_self"])
def test_two_level_knn_model_matches_plain_jax_and_pallas_2l(k, deep, options):
    """Depth 1 (a rescan after every pick) and the kernel's depth, with and
    without the mask and the point itself, k below and past 32."""
    x = _grid_cloud(70, 2, 256, 4)
    depth = default_depth(k) if deep else 1
    mask = np.random.default_rng(71).random((2, 256)) > 0.3
    mask[1, 20:] = False  # a cloud with fewer than k points left
    kw_j, kw_t, kw_m = {}, {}, {}
    if "mask" in options:
        kw_j["mask"], kw_t["mask"], kw_m["mask"] = jnp.asarray(mask), torch.from_numpy(mask), mask
    if "no_self" in options:
        kw_j["include_self"] = kw_t["include_self"] = kw_m["include_self"] = False
    got = _two_level_knn_model(x, k, depth, **kw_m)
    np.testing.assert_array_equal(got, knn_indices_plain(torch.from_numpy(x), k, **kw_t).numpy())
    np.testing.assert_array_equal(got, np.asarray(jops.knn_indices(jnp.asarray(x), k, **kw_j)))
    if options == "plain":
        with pltpu.force_tpu_interpret_mode():
            pallas = knn_indices_pallas_2l(jnp.asarray(x), k, tile=128, seg=128)
        np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("B,N,F,k", [(2, 256, 8, 33), (2, 256, 8, 64), (2, 128, 640, 20),
                                     (1, 96, 700, 40)])
def test_knn_past_the_flat_kernels_limits_matches_jax(B, N, F, k):
    """The shapes the CUDA path sends to the two-level kernel (k > 32, F >
    MAX_F): the plain version equal to the JAX oracle, on grid clouds,
    whose scores are exact in any order."""
    x = _grid_cloud(72, B, N, F)
    want = np.asarray(jops.knn_indices(jnp.asarray(x), k))
    got = tops.knn_indices(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


class _Launches:
    """Stands in for `_kernels.on_cuda`, `_kernels.launch` and
    `_kernels.check` on the CPU: a CPU tensor takes the CUDA path, and the
    calls it would make are recorded, no kernel run."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(_kernels, "on_cuda", lambda t: True)
        monkeypatch.setattr(_kernels, "launch", lambda kernel, symbol, device, *args:
                            self.calls.append((kernel, symbol)))
        monkeypatch.setattr(_kernels, "check", lambda *args: None)


@pytest.mark.parametrize("k,F,want", [(20, 64, "pointseg_knn"), (32, 512, "pointseg_knn"),
                                      (40, 64, "pointseg_knn_2l"), (20, 700, "pointseg_knn_2l"),
                                      (64, 1024, "pointseg_knn_2l")])
def test_knn_flat_select_routes_past_its_limits_to_the_two_level_kernel(monkeypatch, k, F, want):
    """The public call picks by shape; the private route forces kernel 5
    at any shape."""
    from pointseg_torch.ops.knn import _knn_cuda

    launches = _Launches(monkeypatch)
    x = torch.zeros((1, 64, F))
    tops.knn_indices(x, k)
    _knn_cuda(x, k, "two_level", default_depth(k))
    assert launches.calls == [(want.replace("pointseg_", ""), want), ("knn_2l", "pointseg_knn_2l")]


@pytest.mark.parametrize("select", ["flat", "two_level"])
def test_knn_cuda_refuses_rows_of_no_feature_and_depths_it_lacks(monkeypatch, select):
    """F = 0 (no shape the JAX function takes) and a stack depth the
    two-level kernel is not built for raise before any launch."""
    from pointseg_torch.ops.knn import _knn_cuda

    launches = _Launches(monkeypatch)
    with pytest.raises(ValueError, match="F >= 1"):
        _knn_cuda(torch.zeros((1, 64, 0)), 4, select, default_depth(4))
    with pytest.raises(ValueError, match="depth"):
        _knn_cuda(torch.zeros((1, 64, 3)), 4, select, 3)
    assert launches.calls == []


@pytest.mark.parametrize("K,want", [(16, "pointseg_ball_query"), (32, "pointseg_ball_query"),
                                    (33, "pointseg_ball_query_2l"), (48, "pointseg_ball_query_2l")])
def test_ball_query_flat_select_routes_past_32_to_the_two_level_kernel(monkeypatch, K, want):
    """The public calls (raw, and with the repeat filler the kernel
    writes) pick by shape; the private route forces kernel 6 at any K."""
    from pointseg_torch.ops.ballquery import _ball_query_cuda

    launches = _Launches(monkeypatch)
    pts = torch.zeros((1, 64, 3))
    tops.ball_query_raw(pts, pts, 0.1, K)
    tops.ball_query(pts, pts, 0.1, K)
    _ball_query_cuda(pts, pts, 0.01, K, None, "two_level", TWO_LEVEL_DEPTH)
    assert launches.calls == [(want.replace("pointseg_", ""), want)] * 2 + [
        ("ball_query_2l", "pointseg_ball_query_2l")]
