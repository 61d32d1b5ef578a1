"""`scan_epoch`, `train_epoch(scan_steps, accum_steps)` and
`train_step_accum` of the port, on the CPU.

`scan_epoch` has the JAX package's contract (`tests/test_scan_steps.py`):
the same batch sequence and random streams as iterating the loader and
calling `train_step`, the remainder of the epoch included. On the CPU
both ways run the same kernels in the same order, so they agree far
inside the JAX test's bounds (losses rtol 1e-5, parameters rtol 2e-5 /
atol 1e-6), which are the ones stated here.

`train_step_accum` goes against the JAX package's with the same weights
(`from_jax_variables`), dropout 0 and every FPS started at index 0: the
loss to rtol 1e-5 (accuracy and mIoU, which count argmax decisions, to
1e-3 absolute), the averaged gradients by the rule of
`tests/test_torch_model.py` (each leaf within 8x its own float32 noise or
2e-3 (1 + |g|), cosine above 0.995), the threaded running statistics to
rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import PointNetPP as JaxPointNetPP
from pointseg.train.state import TrainState as JaxTrainState
from pointseg.train.state import train_step_accum as jax_train_step_accum
from pointseg_torch.data.device import CompactDeviceStore, DeviceBlockStore, DeviceEpochLoader
from pointseg_torch.models import create_model
from pointseg_torch.train.loop import to_device, train_epoch
from pointseg_torch.train.loss import masked_onehot_cross_entropy
from pointseg_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    train_step,
    train_step_accum,
)
from test_torch_device_data import _canonical_blocks
from test_torch_model import (  # noqa: F401  (jax_variables and batch are fixtures)
    LR,
    N,
    _assert_same_selections,
    _grads_as_flax,
    _port_model,
    batch,
    jax_variables,
)

torch.set_num_threads(2)

C = 4


def _fresh_state(seed=0):
    """A small DGCNN (dropout on: its masks come from torch's default
    generator, which each run seeds alike)."""
    torch.manual_seed(seed)
    model = create_model("DGCNN", num_classes=C, k=4, emb_dims=16)
    return create_train_state(model, device="cpu", learning_rate=1e-3, seed=seed)


def _toy_store(num_blocks=7, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(80, 300, size=num_blocks)
    pts = rng.normal(size=(int(counts.sum()), 9)).astype(np.float32)
    labs = rng.integers(0, C, size=pts.shape[0]).astype(np.uint8)
    return DeviceBlockStore(pts, labs, counts, num_classes=C, device="cpu")


def _assert_states_close(a: TrainState, b: TrainState, **kw):
    assert a.step == b.step
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=name, **kw)


@pytest.mark.parametrize("scan_steps", [3, 4, 1])
def test_scan_epoch_matches_sequential_device_loop(scan_steps):
    """7 blocks at batch 2 are 4 steps (the last with a fill row): with
    scan_steps=3 a remainder of 1 is left over and still runs."""
    store = _toy_store()
    seq = _fresh_state()
    torch.manual_seed(11)
    losses = [train_step(seq, *b)["loss"] for b in DeviceEpochLoader(store, 2, 64, seed=9)]

    scan_loader = DeviceEpochLoader(store, 2, 64, seed=9)
    fused = _fresh_state()
    torch.manual_seed(11)
    fused, ms = scan_loader.scan_epoch(fused, scan_steps)
    assert fused.step == len(losses) == 4
    assert set(ms) == {"loss", "accuracy", "miou"} and ms["loss"].shape == (4,)
    np.testing.assert_allclose(ms["loss"].numpy(), torch.stack(losses).numpy(), rtol=1e-5)
    _assert_states_close(fused, seq, rtol=2e-5, atol=1e-6)
    # the next epoch advances the loader's epoch counter and still runs
    fused, ms2 = scan_loader.scan_epoch(fused, 4)
    assert ms2["loss"].shape == (4,) and fused.step == 8
    with pytest.raises(ValueError, match="scan_steps"):
        scan_loader.scan_epoch(fused, 0)


def test_scan_epoch_runs_over_the_compact_store():
    pts, labs, counts = _canonical_blocks(num_blocks=5, seed=8)
    store = CompactDeviceStore(pts, labs, counts, num_classes=14, device="cpu")
    states = []
    for scan in (False, True):
        torch.manual_seed(3)
        model = create_model("DGCNN", num_classes=14, k=4, emb_dims=16)
        state = create_train_state(model, device="cpu", seed=0)
        loader = DeviceEpochLoader(store, 2, 64, seed=9)
        if scan:
            state, ms = loader.scan_epoch(state, 2)
            np.testing.assert_allclose(ms["loss"].numpy(), np.asarray(losses), rtol=1e-5)
        else:
            losses = [float(train_step(state, *b)["loss"]) for b in loader]
        states.append(state)
    _assert_states_close(states[1], states[0], rtol=2e-5, atol=1e-6)


class _Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step, value))


def test_train_epoch_scan_path_equals_sequential_path():
    store = _toy_store(seed=3)
    runs = []
    for scan_steps in (1, 2):
        state, logger = _fresh_state(), _Recorder()
        torch.manual_seed(5)
        state, loss, global_step = train_epoch(
            state, DeviceEpochLoader(store, 2, 64, seed=4), logger, log_interval=3,
            global_step=10, scan_steps=scan_steps)
        runs.append((state, loss, global_step, logger.scalars))
    (a, loss_a, gs_a, log_a), (b, loss_b, gs_b, log_b) = runs
    assert gs_a == gs_b == 14
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-5)
    _assert_states_close(b, a, rtol=2e-5, atol=1e-6)
    # interval logging from the stacked metrics: the same tags at the same steps
    assert [(t, s) for t, s, _ in log_b] == [(t, s) for t, s, _ in log_a]
    assert sorted({s for _, s, _ in log_b}) == [10, 13]
    np.testing.assert_allclose([v for *_, v in log_b], [v for *_, v in log_a], rtol=1e-5)


def test_train_epoch_scan_steps_leaves_a_host_loader_alone():
    rng = np.random.default_rng(2)
    batches = _host_batches(rng, 2)
    state = _fresh_state()
    state, _, global_step = train_epoch(state, batches, None, 10, 0, scan_steps=4)
    assert global_step == 2 and state.step == 2


def test_to_device_passes_device_tensors_through_untouched():
    store = _toy_store()
    device_batch = next(iter(DeviceEpochLoader(store, 2, 16, seed=0)))
    moved = to_device(device_batch, torch.device("cpu"))
    assert all(a is b for a, b in zip(moved, device_batch))
    host = to_device(tuple(t.numpy() for t in device_batch), torch.device("cpu"))
    assert all(isinstance(t, torch.Tensor) and torch.equal(t, d)
               for t, d in zip(host, device_batch))


def _host_batches(rng, k, b=2, n=64):
    out = []
    for _ in range(k):
        pts = rng.normal(size=(b, n, 9)).astype(np.float32)
        onehot = np.eye(C, dtype=np.uint8)[rng.integers(0, C, size=(b, n))]
        out.append((pts, onehot, np.full((b,), n, np.int32)))
    return out


def test_train_epoch_accum_groups_and_counts_optimizer_steps():
    """5 loader batches at accum_steps=2 are 3 optimizer updates (2 + 2
    + 1: the short trailing group still accumulates), equal to direct
    `train_step_accum` calls on the same groups."""
    batches = _host_batches(np.random.default_rng(4), 5)
    state = _fresh_state(seed=1)
    torch.manual_seed(7)
    state, loss, global_step = train_epoch(state, batches, None, 10, 0, accum_steps=2)
    assert global_step == 3 and state.step == 3 and np.isfinite(loss)

    direct = _fresh_state(seed=1)
    torch.manual_seed(7)
    for group in (batches[:2], batches[2:4], batches[4:]):
        stacked = tuple(torch.from_numpy(np.stack(parts)) for parts in zip(*group))
        metrics = train_step_accum(direct, *stacked)
    assert set(metrics) == {"loss", "accuracy", "miou"}
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    _assert_states_close(state, direct, rtol=2e-5, atol=1e-6)


def test_accum_of_one_micro_batch_is_the_plain_train_step():
    (pts, onehot, lengths), = _host_batches(np.random.default_rng(1), 1)
    plain, accum = _fresh_state(seed=2), _fresh_state(seed=2)
    torch.manual_seed(9)
    want = train_step(plain, *(torch.from_numpy(a) for a in (pts, onehot, lengths)))
    torch.manual_seed(9)
    got = train_step_accum(accum, *(torch.from_numpy(a[None]) for a in (pts, onehot, lengths)))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)
    _assert_states_close(accum, plain, rtol=1e-6, atol=1e-7)


def test_accum_averages_gradients_at_the_same_parameters():
    """Against a loop written out here: per-micro-batch gradients at the
    parameters before the update, their mean, one SGD update (linear in
    the gradient, so the comparison stays at rounding scale)."""
    batches = _host_batches(np.random.default_rng(6), 3)
    stacked = tuple(torch.from_numpy(np.stack(parts)) for parts in zip(*batches))

    def sgd_state():
        torch.manual_seed(0)
        model = create_model("DGCNN", num_classes=C, k=4, emb_dims=16, dropout=0.0)
        return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1), generator=None)

    ref = sgd_state()
    ref.model.train()
    params = list(ref.model.parameters())
    total = [torch.zeros_like(p) for p in params]
    for pts, onehot, lengths in zip(*stacked):
        loss = masked_onehot_cross_entropy(ref.model(pts), onehot, lengths)
        for acc, g in zip(total, torch.autograd.grad(loss, params)):
            acc += g
    with torch.no_grad():
        for p, g in zip(params, total):
            p -= 0.1 * g / 3

    state = sgd_state()
    train_step_accum(state, *stacked)
    assert state.step == 1  # one OPTIMIZER step, not 3
    ref.step = 1
    _assert_states_close(state, ref, rtol=2e-5, atol=1e-6)


def test_accum_and_scan_errors():
    state, store = _fresh_state(), _toy_store(num_blocks=3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_epoch(state, [], None, 1, 0, scan_steps=2, accum_steps=2)
    with pytest.raises(ValueError, match="host loader"):
        train_epoch(state, DeviceEpochLoader(store, 2, 64), None, 20, 0, accum_steps=2)
    assert state.step == 0


def test_train_step_accum_matches_jax(batch, jax_variables):  # noqa: F811
    """Two micro-batches through both packages from the same weights."""
    x1, y1, l1 = batch
    rng = np.random.default_rng(7)  # a second draw whose selections agree too (see `batch`)
    x2 = np.zeros_like(x1)
    x2[..., :3] = rng.random((2, N, 3)) * np.array([1.0, 1.0, 0.3])
    x2[..., 3:] = rng.random((2, N, 6))
    y2 = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (2, N))]
    l2 = np.array([N - 7, N], np.int32)
    for x in (x1, x2):
        _assert_same_selections(x)
    pts, labels, lengths = np.stack([x1, x2]), np.stack([y1, y2]), np.stack([l1, l2])

    # JAX: `optax.trace(decay=0)` keeps the averaged gradients in its state;
    # the "fps" stream is withheld, so every FPS starts at index 0
    jm = JaxPointNetPP(num_classes=14, dropout=0.0)

    def apply_fn(variables, x, train, rngs, mutable):
        return jm.apply(variables, x, train=train, rngs={"dropout": rngs["dropout"]},
                        mutable=mutable)

    tx = optax.trace(decay=0.0)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax_variables["params"],
                           batch_stats=jax_variables["batch_stats"],
                           opt_state=tx.init(jax_variables["params"]), apply_fn=apply_fn, tx=tx)
    jstate, jmetrics = jax_train_step_accum(jstate, jnp.asarray(pts), jnp.asarray(labels),
                                            jnp.asarray(lengths), jax.random.key(0))
    grads_j = flatten_dict(jax.tree.map(np.asarray, jstate.opt_state.trace), sep="/")
    stats_j = flatten_dict(jax.tree.map(np.asarray, jstate.batch_stats), sep="/")

    model = _port_model(jax_variables)
    state = TrainState(model, make_optimizer(model.parameters(), LR), generator=None)
    captured = {}
    state.optimizer.register_step_pre_hook(
        lambda *_: captured.update(_grads_as_flax(model, jax_variables)))
    tensors = tuple(torch.from_numpy(a) for a in (pts, labels, lengths))
    metrics = train_step_accum(state, *tensors)
    assert state.step == 1 and int(jstate.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5,
                               atol=1e-6)
    # counts of argmax decisions: a near-tie between two logits may flip a
    # point or two of the 4,096, each worth 1.2e-4 of the accuracy
    for key in ("accuracy", "miou"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=0,
                                   atol=1e-3, err_msg=key)

    # the port's own float32 noise: the same accumulation in float64
    model64 = _port_model(jax_variables).double().train()
    for i in range(2):
        (masked_onehot_cross_entropy(model64(tensors[0][i].double()), tensors[1][i],
                                     tensors[2][i]) / 2).backward()
    grads_64 = _grads_as_flax(model64.float(), jax_variables)

    dots = norm_t = norm_j = 0.0
    for k, want in grads_j.items():
        got = captured[k]
        cross = np.linalg.norm(got - want)
        noise = np.linalg.norm(got - grads_64[k])
        floor = 2e-3 * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * noise, floor), (k, cross, noise, floor)
        dots += float(got.ravel() @ want.ravel())
        norm_t += float((got ** 2).sum())
        norm_j += float((want ** 2).sum())
    assert dots / np.sqrt(norm_t * norm_j) > 0.995

    # running statistics after BOTH forwards, threaded in order
    stats_t = flatten_dict(from_torch_state_dict(
        "PointNet++", model.state_dict(), jax_variables)["batch_stats"], sep="/")
    for k, want in stats_j.items():
        np.testing.assert_allclose(stats_t[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
