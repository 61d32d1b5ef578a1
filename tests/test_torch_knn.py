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


@pytest.mark.parametrize("select", ["flat", "two_level"])
def test_knn_matches_pallas_kernels_in_interpret_mode(select):
    x = _activations(1, 2, 256, 8)
    with pltpu.force_tpu_interpret_mode():
        if select == "flat":
            want = knn_indices_pallas(jnp.asarray(x), 6, tile=64)
        else:
            want = knn_indices_pallas_2l(jnp.asarray(x), 6, tile=128, seg=128)
    # on a CPU tensor both selects are the one plain version
    got = tops.knn_indices(torch.from_numpy(x), 6, select=select)
    _assert_same_neighbours(x, got.numpy(), want)


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
    with pytest.raises(ValueError, match="select"):
        tops.knn_indices(x, 4, select="sorted")
    with pytest.raises(ValueError, match="k <= N"):
        tops.knn_indices(x, 33)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        tops.knn_indices(torch.empty((1, 32, 3), device="meta"), 4)
    tops.knn_indices(x, 4, select="two_level")
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
