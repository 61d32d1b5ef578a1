"""Tensor parallelism, the point-sharded forward, the row-sharded device
store and the hybrid mesh of pointseg_torch (`pointseg_torch/parallel/`)
on four gloo ranks on the CPU, against one process and against the JAX
package on a mesh of as many devices.

The ranks start once for the module (`parallel.spawn`, one join deadline)
and run every job of `torch_tp_ranks.suite`; each test reads its job's
results. Meshes: (data, model) = (2, 2) for the train steps; (4, 1) and
a (data, points) = (2, 2) mesh split over 'points' for the point-sharded
forward (4 and 2 ranks); the store over all four ranks (the flat mesh)
and over the data axis of the (2, 2) mesh (2 ranks). Tolerances:

- float64, 2 x 2 against one process from the same weights, batch and
  seeds (dropout on, FPS starts drawn), one SGD step: every parameter and
  buffer within 1e-12, the loss within 1e-6 relative (float32 logits);
  FPS picks equal;
- against the JAX package's 2 x 2 step (`create_mesh(jax.devices()[:4],
  ("data", "model"), (2, 2))`, `shard_state_tp`), PointNet, Adam 1e-3:
  loss within 1e-4 and parameters within 1e-5, the bounds of
  `tests/test_parallel.py::test_tp_matches_replicated`, which holds the
  first leaf; here every leaf where the two gradients agree in sign away
  from 0 (elsewhere Adam's first step is +-lr either way) and the first
  leaf whole;
- bf16 compute, 2 x 2 against one process: the loss within 2e-2 (the JAX
  package's bf16 bound);
- global-norm clipping (a limit below the gradients' norm), float64: the
  clipped gradients and the parameters after Adam within 1e-12 of one
  process;
- a checkpoint of a 2 x 2 run holds the ranks' whole tensors bit for bit
  and restores in one process bit for bit; a one-process checkpoint
  restores into the 2 x 2 state bit for bit;
- the point-sharded forward: logits within 2e-4 of the port's unsharded
  forward and (PointNet, PointNet++) of the JAX package's, with every FPS,
  ball-query, 3-NN and kNN selection equal to the unsharded forward's;
- the sharded stores: batches bit-equal to the unsharded store's and to
  the JAX package's store sharded over as many devices, given JAX's order
  and uniforms, and each rank's resident bytes 1/n of the table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

import pointseg.data.device as jdev
import torch_tp_ranks as tp_ranks
from pointseg.models import PointNetPP as JaxPointNetPP
from pointseg.models import PointNetSeg as JaxPointNetSeg
from pointseg.ops.dispatch import set_use_pallas
from pointseg.parallel import create_mesh as jax_create_mesh
from pointseg.parallel import shard_batch as jax_shard_batch
from pointseg.parallel import shard_state_tp as jax_shard_state_tp
from pointseg.train.state import create_train_state as jax_train_state
from pointseg.train.state import train_step as jax_train_step
from pointseg_torch import parallel
from pointseg_torch.io import from_jax_variables
from pointseg_torch.io.checkpoint import (latest_checkpoint, load_checkpoint,
                                          restore_train_state, save_checkpoint)
from pointseg_torch.models import create_model
from pointseg_torch.parallel import Mesh
from pointseg_torch.train.state import create_train_state, train_step
from torch_tp_ranks import blocks

torch.set_num_threads(2)
WORLD = 4
RANK_TIMEOUT = 400  # seconds for the module's one run of the ranks
SHAPE = (2, 2)
MODELS = {  # name -> (model kwargs, B, N) of the float64 steps
    "PointNet++": ({}, 4, 256),
    "PointNet": ({}, 8, 64),
    "PointNeXt": ({}, 4, 256),
    "DeepGraphCnn": ({"k": 8, "emb_dims": 64}, 4, 256),
}
POINT_MESHES = {  # ranks splitting the points -> (mesh axes, shape, split axis)
    4: (("data", "model"), (4, 1), "data"),
    2: (("data", "points"), (2, 2), "points"),
}
POINT_MODELS = {"PointNet": {}, "PointNet++": {}, "PointNeXt": {},
                "DeepGraphCnn": {"k": 8, "emb_dims": 64}}


def _train_spec(name, **extra):
    kwargs, B, N = MODELS[name]
    spec = dict(model=name, model_kwargs=kwargs, seed=3, shape=SHAPE, batch=blocks(B, N),
                optimizer="sgd", lr=1e-3, steps=1)
    spec.update(extra)
    return spec


# --- the JAX package's weights ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pointnet():
    """JAX's PointNet 2 x 2 case (`test_tp_matches_replicated`): its train
    state from seed 0 and a batch of 8 x 64."""
    x, y, lengths = blocks(8, 64, seed=5)
    state = jax_train_state(JaxPointNetSeg(num_classes=14), jnp.zeros((8, 64, 9)), seed=0)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    return (x, y, lengths), state, jax.tree.map(np.asarray, variables)


def _cloud(seed=0, n=512):
    return np.random.default_rng(seed).normal(size=(1, n, 9)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward_case(name):
    """(JAX variables, JAX eval logits) of the point tests' cloud."""
    jm = {"PointNet": JaxPointNetSeg, "PointNet++": JaxPointNetPP}[name](num_classes=14)
    x = jnp.asarray(_cloud())
    variables = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(1), x)
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    return jax.tree.map(np.asarray, variables), np.asarray(logits)


def _canonical_store_case():
    from test_torch_device_data import _canonical_blocks

    pts, labs, counts = _canonical_blocks(num_blocks=8, seed=12)
    pad = (-int(counts.sum())) % 4  # rows divisible by four ranks
    counts = counts.copy()
    counts[-1] += pad
    if pad:
        extra, extra_labs, _ = _canonical_blocks(num_blocks=1, seed=13, counts=[pad])
        pts, labs = np.concatenate([pts, extra]), np.concatenate([labs, extra_labs])
    return pts, labs, counts


@functools.lru_cache(maxsize=None)
def _jax_store_draws():
    """JAX's epoch order and uniforms of two batches of 4 x 64, and its
    batches from the store sharded over 4 and over 2 devices."""
    pts, labs, counts = _canonical_store_case()
    order = jdev.DeviceBlockStore(pts, labs, counts, 14).epoch_order(jax.random.key(3), 4)
    draws, key = [], jax.random.key(9)
    for s in range(2):
        _, sub = jax.random.split(key)
        draws.append((np.array(order)[4 * s:4 * s + 4].astype(np.int64),
                      np.array(jax.random.uniform(sub, (4, 64)))))
        key = jax.random.split(key)[0]
    batches = {}
    for layout, cls in (("flat", jdev.DeviceBlockStore), ("compact", jdev.CompactDeviceStore)):
        for n in (4, 2):
            mesh = jax_create_mesh(jax.devices()[:n])
            store = cls(pts, labs, counts, 14, sharding=NamedSharding(mesh, P("data")))
            step, k, out = jnp.zeros((), jnp.int32), jax.random.key(9), []
            for _ in range(2):
                *batch, step, k = store.sample(order, step, k, 4, 64)
                out.append(tuple(np.asarray(b) for b in batch))
            batches[layout, n] = out
    return draws, batches


# --- the one run of the ranks ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """(the directory the ranks write to, a one-process PointNet checkpoint
    they restore: one Adam step from seed 1)."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    torch.manual_seed(1)
    state = create_train_state(create_model("PointNet", num_classes=14), device="cpu", seed=1)
    train_step(state, *(torch.from_numpy(a) for a in blocks(8, 64, seed=7)))
    save_checkpoint(str(root / "one_process"), state)
    return root / "from_ranks", root / "one_process"


def _jobs(ckpt_dirs):
    jobs = {f"f64 {name}": ("train", _train_spec(name, dtype=torch.float64))
            for name in MODELS}
    batch, _, variables = _jax_pointnet()
    jobs["jax PointNet"] = ("train", dict(
        model="PointNet", seed=0, shape=SHAPE, batch=batch, optimizer="adam", lr=1e-3,
        state_dict=from_jax_variables("PointNet", variables), fps_random=False, grads=True))
    jobs["bf16 PointNet"] = ("train", _train_spec("PointNet", compute=torch.bfloat16))
    jobs["clip PointNet"] = ("train", _train_spec("PointNet", dtype=torch.float64,
                                                  optimizer="adam", grad_clip=0.05, grads=True))
    write_to, read_from = ckpt_dirs
    jobs["checkpoint"] = ("checkpoint", dict(model="PointNet", seed=2, shape=SHAPE,
                                             batch=blocks(8, 64, seed=8), optimizer="adam",
                                             write_to=str(write_to), read_from=str(read_from)))
    for ranks, (axes, shape, axis) in POINT_MESHES.items():
        for name, kwargs in POINT_MODELS.items():
            jobs[f"points {ranks} {name}"] = ("points", _points_spec(name, kwargs, axes, shape,
                                                                     axis))
    pts, labs, counts = _canonical_store_case()
    draws, _ = _jax_store_draws()
    for layout in ("flat", "compact"):
        for n in (4, 2):
            jobs[f"store {layout} {n}"] = ("store", dict(
                layout=layout, points=pts, labels=labs, counts=counts, num_classes=14,
                draws=draws, seed=4, batch_size=4, npoints=64, steps=2,
                shape=None if n == WORLD else SHAPE))
    jobs["hybrid"] = ("hybrid", dict(axes=("data", "model"), process_count=2,
                                     local_device_count=2))
    jobs["block"] = ("block", _block_spec())
    return jobs


def _points_spec(name, kwargs, axes, shape, axis):
    state_dict = None
    if name in ("PointNet", "PointNet++"):
        state_dict = from_jax_variables(name, _jax_forward_case(name)[0])
    return dict(model=name, model_kwargs=kwargs, seed=3, state_dict=state_dict,
                points=_cloud(), axes=axes, shape=shape, axis=axis)


def _block_spec():
    rng = np.random.default_rng(6)
    coords = rng.random((2, 96, 3))
    return dict(in_features=128, widths=[64, 128], radius=0.3, K=8, seed=4, shape=SHAPE,
                centroids=coords[:, :24].copy(), coords=coords,
                features=rng.normal(size=(2, 96, 128)),
                weights=rng.normal(size=(2, 24, 8, 128)))


@pytest.fixture(scope="module")
def jobs(ckpt_dirs):
    set_use_pallas(False)  # the JAX side through its plain versions
    try:
        return _jobs(ckpt_dirs)
    finally:
        set_use_pallas(None)


@pytest.fixture(scope="module")
def four_ranks(jobs):
    """Each rank's results of every job, from one run of four ranks."""
    results = parallel.spawn(tp_ranks.suite, WORLD, (jobs,), timeout=RANK_TIMEOUT, threads=1)
    assert [r["f64 PointNet"]["rank"] for r in results] == list(range(WORLD))
    return results


_ONE_PROCESS: dict = {}


def one_process(jobs, name):
    """The job on a mesh of one rank in this process, once a module."""
    if name not in _ONE_PROCESS:
        task, spec = jobs[name]
        _ONE_PROCESS[name] = tp_ranks.TASKS[task](Mesh(), spec)
    return _ONE_PROCESS[name]


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# --- train steps ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_two_by_two_is_the_one_process_step_in_float64(name, jobs, four_ranks):
    one = one_process(jobs, f"f64 {name}")
    for r in (r[f"f64 {name}"] for r in four_ranks):
        assert abs(r["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
        assert r["state"].keys() == one["state"].keys()
        for k, want in one["state"].items():
            assert _max_abs(r["state"][k], want) <= 1e-12, (k, _max_abs(r["state"][k], want))
        assert len(r["fps"]) == len(one["fps"])
    r0 = four_ranks[0][f"f64 {name}"]
    assert r0["placed"] and r0["fraction"] == one["fraction"] > 0.9
    # a data rank's FPS picks are its rows of the one-process picks
    for i, want in enumerate(one["fps"]):
        got = torch.cat([four_ranks[0][f"f64 {name}"]["fps"][i],
                         four_ranks[2][f"f64 {name}"]["fps"][i]])
        assert torch.equal(got, want), i


def test_two_by_two_pointnet_matches_jax_two_by_two_step(jobs, four_ranks):
    batch, state, _ = _jax_pointnet()
    mesh = jax_create_mesh(jax.devices()[:4], axes=("data", "model"), shape=SHAPE)
    new_state, metrics = jax_train_step(jax_shard_state_tp(mesh, state),
                                        *jax_shard_batch(mesh, batch), jax.random.key(0))
    new = jax.tree.map(np.asarray, {"params": new_state.params,
                                    "batch_stats": new_state.batch_stats})
    want = from_jax_variables("PointNet", new)
    r0 = four_ranks[0]["jax PointNet"]
    assert abs(r0["loss"] - float(metrics["loss"])) < 1e-4
    # the leaf the JAX test holds, whole: its first, conv4's bias
    assert next(iter(flatten_dict(new["params"]))) == ("conv4", "bias")
    np.testing.assert_allclose(r0["state"]["conv4.bias"].numpy(), want["conv4.bias"].numpy(),
                               rtol=0, atol=1e-5)
    old = from_jax_variables("PointNet", _jax_pointnet()[2])
    for k, w in want.items():
        if "running" in k or not w.is_floating_point():
            continue
        got, g, moved = r0["state"][k].double(), r0["grads"][k].double(), (w - old[k]).double()
        # both full Adam steps of one sign: the gradients agree away from 0
        sure = (g * -moved > 0) & (g.abs() > 1e-5) & (moved.abs() > 0.99e-3)
        assert _max_abs(got[sure], w[sure]) <= 1e-5, k
        assert _max_abs(got, old[k]) <= 1e-3 * (1 + 1e-5) + 1e-6, k  # |Adam's first step| <= lr
    for k in want:  # the running statistics (flax momentum 0.9 = the port's 0.1)
        if "running" in k:
            np.testing.assert_allclose(r0["state"][k].numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_two_by_two_bf16_step_matches_one_process(jobs, four_ranks):
    one = one_process(jobs, "bf16 PointNet")
    for r in four_ranks:
        assert abs(r["bf16 PointNet"]["loss"] - one["loss"]) <= 2e-2
        assert np.isfinite(r["bf16 PointNet"]["loss"])


def test_global_norm_clipping_counts_each_element_once(jobs, four_ranks):
    one = one_process(jobs, "clip PointNet")
    r0 = four_ranks[0]["clip PointNet"]
    norm = float(torch.stack([g.double().square().sum() for g in one["grads"].values()])
                 .sum().sqrt())
    assert abs(norm - 0.05) <= 1e-12  # the limit was below the norm: the step clipped
    assert r0["grads"].keys() == one["grads"].keys()
    for k, want in one["grads"].items():
        assert _max_abs(r0["grads"][k], want) <= 1e-12, k
    for k, want in one["state"].items():
        assert _max_abs(r0["state"][k], want) <= 1e-12, k


def test_checkpoint_of_two_by_two_restores_in_one_process_and_back(ckpt_dirs, four_ranks):
    write_to, read_from = ckpt_dirs
    r = [x["checkpoint"] for x in four_ranks]
    path = latest_checkpoint(str(write_to))
    saved = load_checkpoint(path)["model"]
    for k, v in saved.items():
        assert torch.equal(v, r[0]["written"][k]), k
    torch.manual_seed(9)
    state = create_train_state(create_model("PointNet", num_classes=14), device="cpu", seed=9)
    restore_train_state(path, state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert state.step == 1 and load_checkpoint(path)["step"] == 1
    # a one-process checkpoint into the placed state, on every rank
    want = load_checkpoint(latest_checkpoint(str(read_from)))["model"]
    for x in r:
        for k, v in want.items():
            assert torch.equal(x["restored"][k], v), k
        assert x["step"] == 2 and np.isfinite(x["resumed_loss"])


# --- the point-sharded forward ------------------------------------------------------------

@pytest.mark.parametrize("ranks", list(POINT_MESHES))
@pytest.mark.parametrize("name", list(POINT_MODELS))
def test_point_sharded_forward_matches_unsharded(name, ranks, jobs, four_ranks):
    job = f"points {ranks} {name}"
    one = one_process(jobs, job)
    rs = [r[job] for r in four_ranks]
    split = sorted({r["index"]: r for r in rs}.values(), key=lambda r: r["index"])
    assert len(split) == ranks
    got = torch.cat([r["logits"] for r in split], 1)
    assert _max_abs(got, one["logits"]) <= 2e-4
    for kind, calls in one["picks"].items():
        for i, want in enumerate(calls):
            if kind in ("fps", "knn"):  # on the whole level, on every rank
                assert all(torch.equal(r["picks"][kind][i], want) for r in rs), (kind, i)
            else:  # each rank's own centroids or targets
                assert torch.equal(torch.cat([r["picks"][kind][i] for r in split], 1), want), (
                    kind, i)
    if name in ("PointNet", "PointNet++"):
        assert float(np.abs(got.numpy() - _jax_forward_case(name)[1]).max()) <= 2e-4
    if name != "PointNet":
        assert one["picks"], name


# --- the row-sharded device store ---------------------------------------------------------

@pytest.mark.parametrize("ranks", [4, 2])
@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_sharded_store_samples_the_unsharded_and_jax_batches(layout, ranks, jobs, four_ranks):
    job = f"store {layout} {ranks}"
    one = one_process(jobs, job)
    _, jax_batches = _jax_store_draws()
    pts, _, _ = _canonical_store_case()
    for r in (x[job] for x in four_ranks):
        for got, want, jax_want in zip(r["given"], one["given"], jax_batches[layout, ranks]):
            for g, w, j in zip(got, want, jax_want):
                assert torch.equal(g, w)
                np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                              np.ascontiguousarray(j).view(np.uint8))
        for got, want in zip(r["drawn"], one["drawn"]):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        # each rank holds 1/n of the table; the per-block tables are whole
        table = pts.shape[0] * (9 * 4 + 1 if layout == "flat" else 16)
        assert r["nbytes"] == table // ranks + one["nbytes"] - table
        assert r["launches"]["gather_rows_flat"] == 0  # the CPU: the plain version


# --- the hybrid mesh and a GroupedFirstLayer with a row-parallel w_feat ------------------

def test_hybrid_mesh_of_two_nodes_on_ranks(four_ranks):
    for rank, r in enumerate(x["hybrid"] for x in four_ranks):
        np.testing.assert_array_equal(r["grid"], [[0, 1], [2, 3]])
        node, local = divmod(rank, 2)
        assert r["index"] == {"data": node, "model": local}
        assert r["members"] == {"data": (local, 2 + local), "model": (2 * node, 2 * node + 1)}
        assert r["sums"] == {"data": 2.0 + 2 * local, "model": 4.0 * node + 1}


def test_grouped_first_layer_with_row_parallel_features_matches_one_process(jobs, four_ranks):
    one = one_process(jobs, "block")
    for r in (x["block"] for x in four_ranks):
        assert r["modes"]["conv.0"] == "features_row" and r["modes"]["conv.1"] == "column"
        assert _max_abs(r["out"], one["out"]) <= 1e-12
        assert _max_abs(r["dfeatures"], one["dfeatures"]) <= 1e-12
        for k, want in one["grads"].items():
            assert _max_abs(r["grads"][k], want) <= 1e-12, k
