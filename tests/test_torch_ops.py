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
        tops.ball_query(pts, pts, 0.2, 21)
    with pytest.raises(ValueError, match="select"):
        tops.ball_query(pts, pts, 0.2, 4, select="strided")


# (seed, C, radius, K): N = 256 in two 128-column segments, what the Pallas
# two-level kernel needs; sparse balls (fillers in most rows), dense balls
# and centroids == coords (every ball holds its own centre at d² = 0)
BQ2L_CASES = [(40, 32, 0.15, 8), (41, 64, 0.3, 16), (42, 16, 0.6, 32), (43, 256, 0.1, 32)]


@pytest.mark.parametrize("seed,C,r,K", BQ2L_CASES)
def test_ball_query_two_level_matches_pallas_2l_and_flat(seed, C, r, K):
    """`select="two_level"` against the Pallas two-level kernel in
    interpret mode and against `select="flat"`: indices and `in_ball`
    exact, raw and under both fillers."""
    pts = _cloud(seed, 2, 256)
    cents = pts[:, :C]
    with pltpu.force_tpu_interpret_mode():
        p_idx, p_in = ball_query_pallas_2l(jnp.asarray(cents), jnp.asarray(pts), r, K, seg=128)
    p_idx, p_in = np.asarray(p_idx), np.asarray(p_in)
    idx, in_ball = tops.ball_query_raw(_t(cents), _t(pts), r, K, select="two_level")
    flat_idx, flat_in = tops.ball_query_raw(_t(cents), _t(pts), r, K, select="flat")
    assert 0 < in_ball.float().mean() < 1  # both members and fillers occur
    np.testing.assert_array_equal(idx.numpy(), p_idx)
    np.testing.assert_array_equal(in_ball.numpy(), p_in)
    np.testing.assert_array_equal(idx.numpy(), flat_idx.numpy())
    np.testing.assert_array_equal(in_ball.numpy(), flat_in.numpy())
    for filler in ("repeat", "index"):
        want = np.where(p_in, p_idx, p_idx[..., :1]) if filler == "repeat" else p_idx
        for select in ("two_level", "flat"):
            got, got_in = tops.ball_query(_t(cents), _t(pts), r, K, filler=filler, select=select)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{filler} {select}")
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
    for select in ("two_level", "flat"):
        idx, in_ball = tops.ball_query(_t(cents), _t(pts), 0.25, 16, mask=_t(mask),
                                       filler=filler, select=select)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx), err_msg=select)
        np.testing.assert_array_equal(in_ball.numpy(), np.asarray(want_in), err_msg=select)


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
    got = tops.group(_t(pts[:, :30]), _t(pts), _t(feats), 0.2, 8, filler="index",
                     select="two_level")
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
