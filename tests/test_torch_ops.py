"""pointseg_torch.ops against pointseg.ops on the CPU.

The same numpy inputs go through the JAX oracle, the JAX package's
Pallas kernel in interpret mode (for FPS, ball query and 3-NN, as
tests/test_pallas.py runs them) and the port's plain PyTorch version,
which a CPU tensor selects. Selected indices must be equal; values
agree to rtol 1e-5 (float32 arithmetic in another order).

Ties are tested with duplicated points, whose distances are equal
however they are rounded. Distances that are equal only in exact
arithmetic (a lattice) are not: compiled XLA on the CPU contracts the
sum of squares into fused multiply-adds, while the port rounds every
product and sum on its own, as its CUDA kernels do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointseg import ops as jops
from pointseg.ops.ballquery import set_filler_mode
from pointseg.ops.gather import gather_rows as jax_gather_rows
from pointseg.ops.gather import gather_rows_with_coords as jax_gather_rows_with_coords
from pointseg.ops.pallas import (
    ball_query_pallas,
    farthest_point_sampling_pallas,
    three_nn_pallas,
)
from pointseg.ops.pallas.ballquery import ball_query_pallas_2l
from pointseg_torch import ops as tops
from pointseg_torch.ops.gather import gather_rows_plain
from pointseg_torch.ops.ballquery import TWO_LEVEL_DEPTH

torch.set_num_threads(2)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(seed, B, N, scale=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    return (rng.random((B, N, 3)) * np.asarray(scale)).astype(np.float32)


# ------------------------------------------------------------------ FPS


def _fps_case(name):
    if name == "random":
        return _cloud(0, 2, 200), np.zeros(2, np.int32), 48
    if name == "explicit_start":
        return _cloud(1, 3, 150, (1, 1, 3)), np.array([5, 77, 149], np.int32), 40
    if name == "duplicates":
        # eval batches pad a block by repeating its points: exact ties
        pts = _cloud(2, 2, 160)
        pts[:, 100:] = pts[:, :60]
        return pts, np.array([3, 0], np.int32), 80
    raise ValueError(name)


@pytest.mark.parametrize("case", ["random", "explicit_start", "duplicates"])
def test_fps_matches_jax_and_pallas(case):
    pts, start, C = _fps_case(case)
    want = np.asarray(jops.farthest_point_sampling(
        jnp.asarray(pts), C, start_indices=jnp.asarray(start)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(farthest_point_sampling_pallas(
            jnp.asarray(pts), C, start_indices=jnp.asarray(start)))
    got = tops.farthest_point_sampling(_t(pts), C, start_indices=_t(start))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_fps_default_start_is_zero():
    pts = _cloud(3, 2, 100)
    want = np.asarray(jops.farthest_point_sampling(jnp.asarray(pts), 20))
    got = tops.farthest_point_sampling(_t(pts), 20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == 0).all()


def test_fps_mask_matches_jax():
    pts = _cloud(4, 2, 120)
    mask = np.ones((2, 120), bool)
    mask[0, :10] = False  # the default start (0) is excluded
    mask[1, 60:] = False
    want = np.asarray(jops.farthest_point_sampling(
        jnp.asarray(pts), 30, mask=jnp.asarray(mask)))
    got = tops.farthest_point_sampling(_t(pts), 30, mask=_t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask[np.arange(2)[:, None], got.numpy()].all()


def test_fps_generator_draws_reproducible_starts():
    pts = _t(_cloud(5, 4, 90))
    a = tops.farthest_point_sampling(pts, 10, generator=torch.Generator().manual_seed(7))
    b = tops.farthest_point_sampling(pts, 10, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the draw is the start; the rest is FPS from it
    again = tops.farthest_point_sampling(pts, 10, start_indices=a[:, 0])
    torch.testing.assert_close(again, a, rtol=0, atol=0)


def test_sample_matches_jax():
    pts = _cloud(6, 2, 64)
    want = np.asarray(jops.sample(jnp.asarray(pts), 16))
    np.testing.assert_array_equal(tops.sample(_t(pts), 16).numpy(), want)


# ----------------------------------------------------------- ball query


def test_pairwise_sqdist_matches_jax():
    a, b = _cloud(7, 2, 40), _cloud(8, 2, 70)
    want = np.asarray(jops.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = tops.pairwise_sqdist(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (got >= 0).all()


# (seed, B, C, N, radius, K): sparse and dense balls, fillers in most rows
BQ_CASES = [(10, 2, 32, 256, 0.15, 8), (11, 2, 64, 300, 0.3, 16), (12, 1, 16, 128, 0.6, 32)]


@pytest.mark.parametrize("seed,B,C,N,r,K", BQ_CASES)
def test_ball_query_raw_matches_pallas_and_index_oracle(seed, B, C, N, r, K):
    pts = _cloud(seed, B, N)
    cents = pts[:, :C]
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_in = ball_query_pallas(jnp.asarray(cents), jnp.asarray(pts), r, K)
    set_filler_mode("index")
    try:
        o_idx, o_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), r, K)
    finally:
        set_filler_mode(None)
    idx, in_ball = tops.ball_query_raw(_t(cents), _t(pts), r, K)
    assert idx.dtype == torch.int32 and in_ball.dtype == torch.bool
    assert 0 < in_ball.float().mean() < 1  # both members and fillers occur
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(p_in))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(o_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(o_in))


@pytest.mark.parametrize("filler", ["repeat", "index"])
def test_ball_query_filler_modes_match_jax(filler):
    pts = _cloud(13, 2, 200)
    cents = pts[:, ::5]
    set_filler_mode(filler)
    try:
        want_idx, want_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), 0.2, 12)
    finally:
        set_filler_mode(None)
    idx, in_ball = tops.ball_query(_t(cents), _t(pts), 0.2, 12, filler=filler)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in))


def test_ball_query_mask_matches_jax():
    pts = _cloud(14, 2, 180)
    cents = pts[:, :40]
    mask = np.random.default_rng(15).random((2, 180)) > 0.3
    want_idx, want_in = jops.ball_query(
        jnp.asarray(cents), jnp.asarray(pts), 0.25, 10, mask=jnp.asarray(mask))
    idx, in_ball = tops.ball_query(_t(cents), _t(pts), 0.25, 10, mask=_t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in))
    members = np.take_along_axis(mask[:, None, :], idx.numpy(), axis=2)
    assert members[in_ball.numpy()].all()


def test_ball_query_rejects_bad_filler_and_k():
    pts = _t(_cloud(16, 1, 20))
    with pytest.raises(ValueError):
        tops.ball_query(pts, pts, 0.2, 4, filler="nearest")
    with pytest.raises(ValueError):
        tops.ball_query(pts, pts, 0.2, 0)
    # K > N is a ball wider than its level: all N points, then slot 0 as a non-member
    idx, in_ball = tops.ball_query(pts, pts, 0.2, 21)
    want_idx, want_in = tops.ball_query(pts, pts, 0.2, 20)
    assert torch.equal(idx, torch.cat([want_idx, want_idx[..., :1]], dim=-1))
    assert torch.equal(in_ball, torch.cat([want_in, torch.zeros_like(want_in[..., :1])], dim=-1))
    with pytest.raises(TypeError, match="select"):  # the shape picks the kernel
        tops.ball_query(pts, pts, 0.2, 4, select="two_level")


# (seed, C, radius, K): N = 256 in two 128-column segments, what the Pallas
# two-level kernel needs; sparse balls (fillers in most rows), dense balls
# and centroids == coords (every ball holds its own centre at d² = 0)
BQ2L_CASES = [(40, 32, 0.15, 8), (41, 64, 0.3, 16), (42, 16, 0.6, 32), (43, 256, 0.1, 32)]


@pytest.mark.parametrize("seed,C,r,K", BQ2L_CASES)
def test_ball_query_two_level_matches_pallas_2l_and_flat(seed, C, r, K):
    """The one port call (its plain version on a CPU tensor) against the
    JAX package's two-level and flat Pallas kernels in interpret mode:
    indices and `in_ball` exact, raw and under both fillers."""
    pts = _cloud(seed, 2, 256)
    cents = pts[:, :C]
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_in = ball_query_pallas_2l(jnp.asarray(cents), jnp.asarray(pts), r, K, seg=128)
        flat_idx, flat_in = ball_query_pallas(jnp.asarray(cents), jnp.asarray(pts), r, K)
    p_idx, p_in = np.asarray(p_idx), np.asarray(p_in)
    idx, in_ball = tops.ball_query_raw(_t(cents), _t(pts), r, K)
    assert 0 < in_ball.float().mean() < 1  # both members and fillers occur
    np.testing.assert_array_equal(idx.numpy(), p_idx)
    np.testing.assert_array_equal(in_ball.numpy(), p_in)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(flat_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(flat_in))
    for filler in ("repeat", "index"):
        want = np.where(p_in, p_idx, p_idx[..., :1]) if filler == "repeat" else p_idx
        got, got_in = tops.ball_query(_t(cents), _t(pts), r, K, filler=filler)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=filler)
        np.testing.assert_array_equal(got_in.numpy(), p_in)


@pytest.mark.parametrize("filler", ["repeat", "index"])
def test_ball_query_two_level_mask_matches_jax_and_flat(filler):
    """With a mask (the JAX package sends masked queries to its oracle):
    masked points are never members and still serve as index-ordered
    fillers; a fully masked cloud gives fillers only."""
    pts = _cloud(44, 3, 256)
    cents = pts[:, :48]
    mask = np.random.default_rng(45).random((3, 256)) > 0.4
    mask[2] = False
    set_filler_mode(filler)
    try:
        want_idx, want_in = jops.ball_query(
            jnp.asarray(cents), jnp.asarray(pts), 0.25, 16, mask=jnp.asarray(mask))
    finally:
        set_filler_mode(None)
    assert not np.asarray(want_in)[2].any()
    idx, in_ball = tops.ball_query(_t(cents), _t(pts), 0.25, 16, mask=_t(mask), filler=filler)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in))


def test_group_takes_select_and_filler():
    rng = np.random.default_rng(46)
    pts = _cloud(46, 2, 150)
    feats = rng.normal(size=(2, 150, 5)).astype(np.float32)
    set_filler_mode("index")
    try:
        want = np.asarray(jops.group(jnp.asarray(pts[:, :30]), jnp.asarray(pts),
                                     jnp.asarray(feats), 0.2, 8))
    finally:
        set_filler_mode(None)
    got = tops.group(_t(pts[:, :30]), _t(pts), _t(feats), 0.2, 8, filler="index")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("normalize", [False, True])
def test_group_matches_jax(normalize):
    rng = np.random.default_rng(17)
    pts = _cloud(17, 2, 150)
    feats = rng.normal(size=(2, 150, 5)).astype(np.float32)
    cents = pts[:, :30]
    want = np.asarray(jops.group(jnp.asarray(cents), jnp.asarray(pts), jnp.asarray(feats),
                                 0.3, 8, normalize=normalize))
    got = tops.group(_t(cents), _t(pts), _t(feats), 0.3, 8, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


# ----------------------------------------------------------------- 3-NN


@pytest.mark.parametrize("seed,B,N,M", [(20, 2, 256, 64), (21, 2, 100, 37), (22, 1, 64, 3)])
def test_three_nn_matches_jax_and_pallas(seed, B, N, M):
    tgt, src = _cloud(seed, B, N), _cloud(seed + 100, B, M)
    want_d, want_i = jops.three_nn(jnp.asarray(tgt), jnp.asarray(src))
    d2, idx = tops.three_nn(_t(tgt), _t(src))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d), rtol=RTOL, atol=1e-6)
    if N % 8 == 0:  # the Pallas wrapper tiles N by multiples of 8
        with pltpu.force_tpu_interpret_mode():
            p_d, p_i = three_nn_pallas(jnp.asarray(tgt), jnp.asarray(src))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(p_i))
        np.testing.assert_allclose(d2.numpy(), np.asarray(p_d), rtol=RTOL, atol=1e-6)


def test_three_nn_ties_and_mask_match_jax():
    src = _cloud(23, 2, 40)
    src[:, 20:] = src[:, :20]  # every source has a duplicate
    tgt = _cloud(24, 2, 50)
    mask = np.ones((2, 40), bool)
    mask[:, 5:15] = False
    want_d, want_i = jops.three_nn(jnp.asarray(tgt), jnp.asarray(src),
                                   src_mask=jnp.asarray(mask))
    d2, idx = tops.three_nn(_t(tgt), _t(src), src_mask=_t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d), rtol=RTOL, atol=1e-6)


def test_interpolate_matches_jax():
    rng = np.random.default_rng(25)
    tgt, src = _cloud(25, 2, 120), _cloud(26, 2, 30)
    feats = rng.normal(size=(2, 30, 7)).astype(np.float32)
    want = np.asarray(jops.interpolate(jnp.asarray(feats), jnp.asarray(tgt), jnp.asarray(src)))
    got = tops.interpolate(_t(feats), _t(tgt), _t(src))
    # The IDW weights are as exact as the port's own 3-NN output allows
    d2, idx = (a.numpy().astype(np.float64) for a in tops.three_nn(_t(tgt), _t(src)))
    w = 1.0 / (d2 + 1e-9)
    w /= w.sum(-1, keepdims=True)
    rows = np.take_along_axis(feats[:, None].astype(np.float64),
                              idx.astype(np.int64)[..., None], axis=2)
    np.testing.assert_allclose(got.numpy(), (w[..., None] * rows).sum(2), rtol=RTOL, atol=1e-6)
    # Against JAX: the Gram form cancels |q|² (~1) down to a neighbour's d²
    # (~1e-3), so a 1-ulp difference in how the two round the dot product
    # is ~1e-4 relative in d² and in the weights.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------- models of the kernels' rules
#
# numpy models of how the CUDA kernels order their picks, run on the same
# clouds as the plain versions and the JAX functions, so that a wrong tie
# rule shows here and not only on the card. The ball query (flat kernel):
# S warps a centroid, each scanning every S-th 32-point chunk in index
# order; a chunk's members go to a 32-entry staging list, a full list is
# sorted once and merged into the kept 32; once K are kept a point is
# taken only when its d² is strictly below the K-th; the fillers step over
# the members in index order. 3-NN: one list a target, sources in chunks in
# index order, a source a candidate when !(raw > third best) before the
# clamp, a chunk's candidates entering nearest first until one does not.

INT_MAX = 2**31 - 1
NEG_TINY = np.float32(-1.4e-45)  # the smallest negative float32


def _gram_raw(q, p, p_valid=None):
    """(C, N) raw Gram d² of one cloud, rounded operation by operation in
    float32 as the kernels do, before the clamp; |p|² is NaN (ball query)
    where `p_valid` is False."""
    q, p = q.astype(np.float32), p.astype(np.float32)
    q2 = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    p2 = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    if p_valid is not None:
        p2 = np.where(p_valid, p2, np.float32(np.nan))
    cross = (q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1]) \
        + q[:, None, 2] * p[None, :, 2]
    with np.errstate(invalid="ignore"):
        return (q2[:, None] - np.float32(2) * cross) + p2[None, :]


def _flat_ball_model(raw, K, r2, S):
    """One ball: (idx (K,), in_ball (K,)) as the flat kernel picks them."""
    N = raw.shape[0]
    chunks = (N + 31) // 32
    lists, total = [], 0
    for s in range(S):
        lim, count, staged, kept = r2, 0, [], []

        def flush():
            nonlocal kept, staged, lim
            kept = sorted(kept + staged)[:32]  # the bitonic sort and merge keep 32
            staged = []
            if len(kept) >= K:
                kth = kept[K - 1][0]
                lim = np.nextafter(kth, np.float32(-np.inf)) if kth > 0 else NEG_TINY

        for k in range(s, chunks, S):
            cols = np.arange(32 * k, min(32 * k + 32, N))
            with np.errstate(invalid="ignore"):
                bits = cols[raw[cols] <= lim]
            if not bits.size:
                continue
            count += bits.size
            if len(staged) + bits.size > 32:
                flush()
            staged += [(np.float32(max(raw[j], 0)), int(j)) for j in bits]
        flush()
        lists.append(kept)
        total += count
    merged = sorted(e for kept in lists for e in kept)[:32]
    idx = [i for _, i in merged[:K]]
    if total < K:  # every member is listed: step over them for the fillers
        members = sorted(i for _, i in merged)
        for j in range(K - total):
            f = j
            for m in members:
                f += m <= f
            idx.append(f)
    return np.array(idx, np.int32), np.arange(K) < min(total, K)


def _flat_ball_model_batch(cents, pts, r, K, S, mask=None):
    r2 = np.float32(r) * np.float32(r)
    B, C = cents.shape[:2]
    idx, in_ball = np.zeros((B, C, K), np.int32), np.zeros((B, C, K), bool)
    for b in range(B):
        raw = _gram_raw(cents[b], pts[b], None if mask is None else mask[b])
        for c in range(C):
            idx[b, c], in_ball[b, c] = _flat_ball_model(raw[c], K, r2, S)
    return idx, in_ball


def _takes(best, d):
    """`Best3::takes`: a candidate whose index is above every listed one
    at its distance enters only strictly below the third, or an empty slot."""
    return d < best[2][0] or best[2][1] == INT_MAX


def _insert_later(best, d, i):
    """`Best3::insert_later` of threenn.cu on a list of three (d, i)."""
    n1 = d < best[1][0] or best[1][1] == INT_MAX
    n0 = d < best[0][0] or best[0][1] == INT_MAX
    best[2] = best[1] if n1 else (d, i)
    best[1] = best[0] if n0 else ((d, i) if n1 else best[1])
    best[0] = (d, i) if n0 else best[0]


def _three_nn_model(tgt, src, width, src_mask=None):
    """(d2, idx) of every target as the 3-NN kernel finds them: sources in
    chunks of `width` (the kernel's 32 or, two an iteration, 64); a source
    is a candidate when !(raw > third best); a chunk's candidates enter
    nearest first by (d², index), -0 as +0, and the first that does not
    enter ends the chunk. The result must not depend on `width`."""
    B, N = tgt.shape[:2]
    M = src.shape[1]
    out_d, out_i = np.zeros((B, N, 3), np.float32), np.zeros((B, N, 3), np.int32)
    for b in range(B):
        raw = _gram_raw(tgt[b], src[b])
        if src_mask is not None:  # |s|² = +inf: the distance is +inf
            raw = np.where(src_mask[b][None, :], raw, np.float32(np.inf))
        d_all = np.where(np.isnan(raw), np.float32(0), np.maximum(raw, np.float32(0)))
        for n in range(N):
            best = [(np.float32(np.inf), INT_MAX)] * 3
            for j0 in range(0, M, width):
                cols = [j for j in range(j0, min(j0 + width, M)) if not raw[n, j] > best[2][0]]
                for j in sorted(cols, key=lambda j: (abs(d_all[n, j]), j)):
                    if not _takes(best, d_all[n, j]):
                        break
                    _insert_later(best, d_all[n, j], j)
            out_d[b, n] = [d for d, _ in best]
            out_i[b, n] = [i for _, i in best]
    return out_d, out_i


def _tie_cloud(seed, B, N, dup_every=3, scale=(1, 1, 3)):
    """A block cloud in which every `dup_every`-th point repeats an earlier
    one: exact ties in d² at every centroid."""
    pts = _cloud(seed, B, N, scale)
    pts[:, ::dup_every] = pts[:, : (N + dup_every - 1) // dup_every]
    return pts


def _off_cloud(seed, B, N):
    """A cloud whose first points, moved 10 m away, serve as centroids:
    balls with no member at all (a radius of 0 would not do: XLA's fused
    sums give a point's own d² as ~1e-6, the kernels' exact ones 0)."""
    pts = _tie_cloud(seed, B, N, 2)
    pts[:, :16] += 10.0
    return pts


# (cloud, C, r, K): ties, a ball 100x larger than K (every point of 512
# inside r = 4, K = 4), centroids == points (d² = 0 ties with duplicates),
# empty balls, a ragged N
BALL_MODEL_CASES = {
    "ties": (lambda: _tie_cloud(50, 2, 300), 40, 0.3, 16),
    "ball 100x K": (lambda: _tie_cloud(51, 1, 512, 4), 24, 4.0, 4),
    "centroids are points": (lambda: _tie_cloud(52, 2, 200, 2), 200, 0.25, 32),
    "empty balls": (lambda: _off_cloud(53, 1, 100), 8, 0.5, 8),
    "ragged N": (lambda: _cloud(54, 2, 77, (1, 1, 3)), 24, 0.6, 32),
}


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(BALL_MODEL_CASES))
def test_flat_ball_query_model_matches_plain_and_jax(case, S):
    make, C, r, K = BALL_MODEL_CASES[case]
    pts = make()
    cents = pts[:, :C]
    want_idx, want_in = tops.ball_query_raw(_t(cents), _t(pts), r, K)
    got_idx, got_in = _flat_ball_model_batch(cents, pts, r, K, S)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_in, want_in.numpy())
    set_filler_mode("index")
    try:
        o_idx, o_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), r, K)
    finally:
        set_filler_mode(None)
    np.testing.assert_array_equal(got_idx, np.asarray(o_idx))
    np.testing.assert_array_equal(got_in, np.asarray(o_in))


@pytest.mark.parametrize("S", [1, 4])
def test_flat_ball_query_model_with_a_mask_matches_plain_and_jax(S):
    """Masked points are never members and still fill in index order; a
    cloud whose points are all masked gives fillers only."""
    pts = _tie_cloud(55, 3, 260)
    cents = pts[:, :30]
    mask = np.random.default_rng(56).random((3, 260)) > 0.5
    mask[2] = False
    got_idx, got_in = _flat_ball_model_batch(cents, pts, 0.35, 16, S, mask)
    want_idx, want_in = tops.ball_query_raw(_t(cents), _t(pts), 0.35, 16, mask=_t(mask))
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_in, want_in.numpy())
    o_idx, o_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), 0.35, 16,
                                  mask=jnp.asarray(mask))  # repeat filler
    np.testing.assert_array_equal(np.where(got_in, got_idx, got_idx[..., :1]), np.asarray(o_idx))
    np.testing.assert_array_equal(got_in, np.asarray(o_in))
    assert not got_in[2].any() and (got_idx[2] == np.arange(16)).all()


@pytest.mark.parametrize("filler", ["repeat", "index"])
@pytest.mark.parametrize("case", sorted(BALL_MODEL_CASES))
def test_ball_query_fillers_match_jax_and_pallas_on_edge_clouds(case, filler):
    """`ball_query` with both fillers against the JAX function and the
    Pallas kernel in interpret mode on the same tie-heavy and edge clouds."""
    make, C, r, K = BALL_MODEL_CASES[case]
    pts = make()
    cents = pts[:, :C]
    set_filler_mode(filler)
    try:
        want_idx, want_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), r, K)
    finally:
        set_filler_mode(None)
    idx, in_ball = tops.ball_query(_t(cents), _t(pts), r, K, filler=filler)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in))
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_in = ball_query_pallas(jnp.asarray(cents), jnp.asarray(pts), r, K)
    p_idx, p_in = np.asarray(p_idx), np.asarray(p_in)
    if filler == "repeat":
        p_idx = np.where(p_in, p_idx, p_idx[..., :1])
    np.testing.assert_array_equal(idx.numpy(), p_idx)
    np.testing.assert_array_equal(in_ball.numpy(), p_in)


# The two-level ball query (kernel 6): the flat kernel's scan, S warps a
# ball each owning every S-th 32-point chunk, lane l of a warp the columns
# 32 k + l of its chunks, offered in ascending order. A lane keeps a sorted
# stack of `depth` members by (d², index); a member enters while its raw d²
# <= lim, r² until the stack is full, then just below the stack's last
# entry. Rounds take the first head and pop it, a dry lane whose stack had
# filled refilled with its first member behind the last consumed, until K
# are out or no lane offers one. One warp a ball writes the rounds and
# counts the fillers (the j-th lowest index outside the ball); S warps each
# list their first K and merge as the flat kernel's do.


def _two_level_ball_model(raw, K, r2, S, depth):
    """One ball: (idx (K,), in_ball (K,)) as the two-level kernel picks them."""
    N = raw.shape[0]
    with np.errstate(invalid="ignore"):
        member = raw <= r2
    d = np.where(raw > 0, raw, np.float32(0))
    key = lambda j: (float(d[j]), int(j))  # noqa: E731
    lists, total = [], 0
    for s in range(S):
        stacks, fulls = [], []
        for lane in range(32):
            cols = [32 * k + lane for k in range(s, (N + 31) // 32, S) if 32 * k + lane < N]
            stack, lim = [], r2
            for j in cols:
                if not raw[j] <= lim:
                    continue
                stack = sorted(stack + [key(j)])[:depth]
                if len(stack) == depth:
                    tail = np.float32(stack[-1][0])
                    lim = np.nextafter(tail, np.float32(-np.inf)) if tail > 0 else -np.inf
            stacks.append((stack, cols))
            fulls.append(len(stack) == depth)
        picks, last = [], [None] * 32
        while len(picks) < K:
            for lane, (stack, cols) in enumerate(stacks):
                if stack or not fulls[lane]:
                    continue
                behind = sorted(key(j) for j in cols if member[j] and key(j) > last[lane])
                if behind:
                    stack.append(behind[0])
                else:
                    fulls[lane] = False
            heads = [(stack[0], lane) for lane, (stack, _) in enumerate(stacks) if stack]
            if not heads:
                break
            head, lane = min(heads)
            picks.append(head)
            last[lane] = stacks[lane][0].pop(0)
        lists.append(picks)
        total += len(picks)
    picks = sorted(e for picks in lists for e in picks)[:K]
    idx = [i for _, i in picks]
    fillers = [j for j in range(N) if not member[j]]
    idx += fillers[: K - len(idx)]
    return np.array(idx, np.int32), np.arange(K) < min(total, K)


def _two_level_ball_model_batch(cents, pts, r, K, S, depth, mask=None):
    r2 = np.float32(r) * np.float32(r)
    B, C = cents.shape[:2]
    idx, in_ball = np.zeros((B, C, K), np.int32), np.zeros((B, C, K), bool)
    for b in range(B):
        raw = _gram_raw(cents[b], pts[b], None if mask is None else mask[b])
        for c in range(C):
            idx[b, c], in_ball[b, c] = _two_level_ball_model(raw[c], K, r2, S, depth)
    return idx, in_ball


# BALL_MODEL_CASES and a K past 32 (one warp a ball only)
TWO_LEVEL_BALL_CASES = {**BALL_MODEL_CASES,
                        "K past 32": (lambda: _tie_cloud(57, 2, 300), 30, 0.5, 48)}


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("case,S", [(case, S) for case in sorted(TWO_LEVEL_BALL_CASES)
                                    for S in (1, 2, 4)
                                    if S == 1 or TWO_LEVEL_BALL_CASES[case][3] <= 32])
def test_two_level_ball_query_model_matches_plain_and_jax(case, S, depth):
    """Warps a ball (S) merge lists of at most 32: K past 32 is one warp a
    ball, as the kernel takes it."""
    make, C, r, K = TWO_LEVEL_BALL_CASES[case]
    pts = make()
    cents = pts[:, :C]
    got_idx, got_in = _two_level_ball_model_batch(cents, pts, r, K, S, depth)
    want_idx, want_in = tops.ball_query_raw(_t(cents), _t(pts), r, K)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_in, want_in.numpy())
    set_filler_mode("index")
    try:
        o_idx, o_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), r, K)
    finally:
        set_filler_mode(None)
    np.testing.assert_array_equal(got_idx, np.asarray(o_idx))
    np.testing.assert_array_equal(got_in, np.asarray(o_in))


@pytest.mark.parametrize("depth", [1, TWO_LEVEL_DEPTH])
@pytest.mark.parametrize("S,K", [(1, 16), (4, 16), (1, 40)])
def test_two_level_ball_query_model_with_a_mask_matches_plain_jax_and_pallas_2l(S, K, depth):
    """On a tie cloud of 256 points (two 128-column segments, what the
    Pallas two-level kernel needs): unmasked against the Pallas kernel in
    interpret mode; masked (a cloud all masked: fillers only) against the
    plain version and the JAX function."""
    pts = _tie_cloud(58, 3, 256)
    cents = pts[:, :40]
    got_idx, got_in = _two_level_ball_model_batch(cents, pts, 0.35, K, S, depth)
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_in = ball_query_pallas_2l(jnp.asarray(cents), jnp.asarray(pts), 0.35, K, seg=128)
    np.testing.assert_array_equal(got_idx, np.asarray(p_idx))
    np.testing.assert_array_equal(got_in, np.asarray(p_in))
    mask = np.random.default_rng(59).random((3, 256)) > 0.5
    mask[2] = False
    got_idx, got_in = _two_level_ball_model_batch(cents, pts, 0.35, K, S, depth, mask)
    want_idx, want_in = tops.ball_query_raw(_t(cents), _t(pts), 0.35, K, mask=_t(mask))
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_in, want_in.numpy())
    set_filler_mode("index")
    try:
        o_idx, o_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), 0.35, K,
                                      mask=jnp.asarray(mask))
    finally:
        set_filler_mode(None)
    np.testing.assert_array_equal(got_idx, np.asarray(o_idx))
    np.testing.assert_array_equal(got_in, np.asarray(o_in))
    assert not got_in[2].any() and (got_idx[2] == np.arange(K)).all()


@pytest.mark.parametrize("filler", ["repeat", "index"])
@pytest.mark.parametrize("K", [48, 64])
def test_ball_query_past_32_matches_jax(K, filler):
    """The K the CUDA path sends to the two-level kernel: the plain version
    against the JAX function, both fillers."""
    pts = _tie_cloud(66, 2, 300)
    cents = pts[:, :50]
    set_filler_mode(filler)
    try:
        want_idx, want_in = jops.ball_query(jnp.asarray(cents), jnp.asarray(pts), 0.4, K)
    finally:
        set_filler_mode(None)
    idx, in_ball = tops.ball_query(_t(cents), _t(pts), 0.4, K, filler=filler)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in))
    assert 0 < np.asarray(want_in).mean() < 1


def _three_nn_case(name):
    """(tgt, src, src_mask) of one edge cloud, in the unit cube: distances
    agree with XLA's fused sums to 1e-6 there."""
    tgt = _cloud(60, 2, 48)
    if name == "ties":
        return tgt, _tie_cloud(61, 2, 40, scale=(1, 1, 1)), None
    if name == "M = 3":
        return tgt, _cloud(62, 2, 3), None
    if name == "all but two masked":
        mask = np.zeros((2, 37), bool)
        mask[:, [5, 30]] = True
        return tgt, _tie_cloud(63, 2, 37, scale=(1, 1, 1)), mask
    if name == "masked, ragged M":
        mask = np.random.default_rng(65).random((2, 45)) > 0.4
        return tgt, _tie_cloud(64, 2, 45, scale=(1, 1, 1)), mask
    raise ValueError(name)


THREE_NN_CASES = ["ties", "M = 3", "all but two masked", "masked, ragged M"]


@pytest.mark.parametrize("width", [1, 8, 32, 64])
@pytest.mark.parametrize("case", THREE_NN_CASES)
def test_three_nn_model_matches_plain_and_jax(case, width):
    tgt, src, mask = _three_nn_case(case)
    got_d, got_i = _three_nn_model(tgt, src, width, mask)
    want_d, want_i = tops.three_nn(_t(tgt), _t(src), src_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_d, want_d.numpy())
    j_d, j_i = jops.three_nn(jnp.asarray(tgt), jnp.asarray(src),
                             src_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got_i, np.asarray(j_i))
    np.testing.assert_allclose(got_d, np.asarray(j_d), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("case", THREE_NN_CASES)
def test_three_nn_plain_matches_jax_and_pallas_on_edge_clouds(case):
    """`three_nn` (the plain version on the CPU) against the JAX function
    and, where there is no mask, the Pallas kernel in interpret mode: a
    target with fewer than three valid sources takes the lowest-index
    masked ones after them, at +inf."""
    tgt, src, mask = _three_nn_case(case)
    d2, idx = tops.three_nn(_t(tgt), _t(src), src_mask=None if mask is None else _t(mask))
    j_d, j_i = jops.three_nn(jnp.asarray(tgt), jnp.asarray(src),
                             src_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d), rtol=RTOL, atol=1e-6)
    if mask is None:
        with pltpu.force_tpu_interpret_mode():
            p_d, p_i = three_nn_pallas(jnp.asarray(tgt), jnp.asarray(src))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(p_i))
        np.testing.assert_allclose(d2.numpy(), np.asarray(p_d), rtol=RTOL, atol=1e-6)
    else:
        few = mask.sum(1) < 3
        if few.any():  # the third slot is the lowest-index masked source, at +inf
            assert np.isinf(d2.numpy()[few][..., 2]).all()
            first_masked = np.argmin(mask, axis=1)[few]
            assert (idx.numpy()[few][..., 2] == first_masked[:, None]).all()


# --------------------------------------------------------------- gather


def test_gather_rows_and_gradient_match_jax():
    rng = np.random.default_rng(27)
    table = rng.normal(size=(2, 20, 5)).astype(np.float32)
    idx = rng.integers(0, 20, size=(2, 6, 4)).astype(np.int32)  # repeats rows
    weight = rng.normal(size=(2, 6, 4, 5)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jax_gather_rows(t, jnp.asarray(idx)) * weight)

    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(table)))

    tt = _t(table).requires_grad_(True)
    got = tops.gather_rows(tt, _t(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * _t(weight)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want_grad, rtol=RTOL, atol=1e-6)


def test_gather_rows_with_coords_matches_jax_and_detaches_coords():
    rng = np.random.default_rng(28)
    feats = rng.normal(size=(2, 25, 4)).astype(np.float32)
    coords = _cloud(28, 2, 25)
    idx = rng.integers(0, 25, size=(2, 7, 3)).astype(np.int32)
    wf, wc = jax_gather_rows_with_coords(jnp.asarray(feats), jnp.asarray(coords),
                                         jnp.asarray(idx))
    tf = _t(feats).requires_grad_(True)
    tc = _t(coords).requires_grad_(True)
    gf, gc = tops.gather_rows_with_coords(tf, tc, _t(idx))
    np.testing.assert_array_equal(gf.detach().numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gc.detach().numpy(), np.asarray(wc))
    (gf.sum() + gc.sum()).backward()
    assert tc.grad is None and tf.grad is not None


@pytest.mark.parametrize("how", ["grad", "no_grad", "frozen", "bf16 features"])
def test_gather_rows_with_coords_plain_gives_contiguous_outputs_and_no_coord_grad(how):
    """Two gathers on the CPU, each output contiguous, with or without an
    autograd node; the coordinates never get a gradient, the features get
    the scatter-add of autograd through `torch.gather`."""
    rng = np.random.default_rng(31)
    feats = rng.normal(size=(2, 30, 6)).astype(np.float32)
    coords = _cloud(31, 2, 30)
    idx = _t(rng.integers(0, 30, size=(2, 8, 5)).astype(np.int32))
    tf = _t(feats).to(torch.bfloat16 if how == "bf16 features" else torch.float32)
    tf.requires_grad_(how != "frozen")
    tc = _t(coords).requires_grad_(True)
    with torch.set_grad_enabled(how != "no_grad"):
        gf, gc = tops.gather_rows_with_coords(tf, tc, idx)
    assert gf.shape == (2, 8, 5, 6) and gc.shape == (2, 8, 5, 3)
    assert gf.is_contiguous() and gc.is_contiguous() and not gc.requires_grad
    assert gf.dtype == tf.dtype and gc.dtype == torch.float32
    assert torch.equal(gf, gather_rows_plain(tf.detach(), idx))
    assert torch.equal(gc, gather_rows_plain(tc.detach(), idx))
    assert gf.requires_grad == (how in ("grad", "bf16 features"))
    if gf.requires_grad:
        weight = torch.from_numpy(rng.normal(size=(2, 8, 5, 6)).astype(np.float32))
        (gf.float() * weight).sum().backward()
        ref = tf.detach().clone().requires_grad_(True)
        flat = idx.reshape(2, -1).long()[..., None].expand(-1, -1, 6)
        (torch.gather(ref, 1, flat).reshape(2, 8, 5, 6).float() * weight).sum().backward()
        torch.testing.assert_close(tf.grad, ref.grad, rtol=1e-4, atol=1e-4)
    assert tc.grad is None


# -------------------------------------------------------------- pooling


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_reduce_and_gradient_match_jax(kind):
    rng = np.random.default_rng(29)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    x[:, :, 3] = x[:, :, 0]  # tied maxima, as repeated filler rows make
    w = rng.normal(size=(2, 5, 3)).astype(np.float32)
    want = np.asarray(jops.reduce(jnp.asarray(x), kind, axis=2))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(jops.reduce(v, kind, axis=2) * w))(jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    got = tops.reduce(tx, kind, dim=2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_grad, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_masked_reduce_matches_jax(kind):
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    mask = rng.random((2, 5, 6)) > 0.4
    mask[0, 0] = False  # an empty region pools to 0
    want = np.asarray(jops.masked_reduce(jnp.asarray(x), jnp.asarray(mask), kind, axis=2))
    got = tops.masked_reduce(_t(x), _t(mask), kind, dim=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    assert (got[0, 0] == 0).all()
