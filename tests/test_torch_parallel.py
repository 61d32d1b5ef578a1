"""`train --data-parallel` of pointseg_torch (`pointseg_torch/parallel/`) on
the CPU: two gloo ranks, joined through a `FileStore`, against one
process and against the JAX package on a two-device mesh.

The ranks start once for the whole module (`parallel.spawn`, one join
deadline) and run every job of `torch_parallel_ranks.suite`; each test
reads its job's results. Tolerances:

- float64, two ranks against one process from the same weights, batch
  and seeds, dropout on: the same function up to reassociation. Loss
  within 1e-6 (relative: the models return float32 logits, so the loss
  is float32 in both), gradients and parameters after one SGD step
  within 1e-9, running statistics within rtol 1e-8, FPS picks and the
  FPS generator equal.
- float32, the JAX package's bounds (`tests/test_parallel.py`, which
  holds the first parameter leaf): loss within 5e-4, each parameter
  after one SGD step (lr 1e-3) within 2e-5. At these sizes the port's
  own one-process float32 step lies up to 3.1e-4 from its float64 step
  in PointNeXt's parameters (2.5e-5 in PointNet++'s: BatchNorm over
  small batches magnifies rounding), so a leaf beyond 2e-5 passes only
  where that distance exceeds 1e-5 and the two ranks' step lies no
  farther from the float64 step than 1.5 times it: as accurate as one
  process. Running statistics within rtol 1e-5 and atol 1e-7 (means
  near 0) plus twice their own float32-to-float64 distance. FPS picks
  equal.
- After three Adam steps the ranks' parameters are bit-equal.
- Against the JAX package's two-device mesh (`create_mesh`,
  `shard_state`, `shard_batch`), dropout 0, FPS from 0, the JAX weights
  carried over by `from_jax_variables`: the criteria of the one-process
  port-against-JAX train-step tests, `tests/test_torch_model.py` and
  `tests/test_torch_dgcnn.py`: loss rtol 1e-5 / atol 1e-6; each
  gradient leaf within 8x the port's own float32 noise (its float64
  step) or 2e-3 (1 + |g|) (PointNet++, against the JAX float64
  gradients) / 2e-2 (1 + |g|) (DGCNN, against the JAX float32 ones),
  global cosine above 0.995 / 0.999; running statistics rtol 1e-4 and
  atol 1e-5 / 1e-4.
- BatchNorm statistics on the F6 input: the bounds that
  `tests/test_torch_eval.py::test_batch_norm_with_gradient_takes_accurate_statistics`
  and `tests/test_torch_bf16.py::test_edgeconv_bf16_statistics_against_float64`
  hold one process to, against float64.
- Sharded window groups: predictions equal, confidences within 1e-5.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import torch_parallel_ranks as ranks
from torch_parallel_ranks import MODELS, room_run, train_run
from torch_parallel_ranks import blocks as _blocks
from torch_parallel_ranks import train_spec as _train_spec
from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import create_model as jax_create_model
from pointseg.ops.dispatch import set_use_pallas
from pointseg.parallel import create_mesh as jax_create_mesh
from pointseg.parallel import shard_batch as jax_shard_batch
from pointseg.parallel import shard_state as jax_shard_state
from pointseg.train.loss import masked_onehot_cross_entropy as jax_ce
from pointseg_torch import parallel
from pointseg_torch.io import from_jax_variables
from pointseg_torch.io.checkpoint import restore_train_state, save_checkpoint
from pointseg_torch.models import create_model
from pointseg_torch.parallel import Mesh
from pointseg_torch.train.state import create_train_state, train_step

torch.set_num_threads(2)
WORLD = 2
RANK_TIMEOUT = 400  # seconds for the module's one run of the ranks
DGCNN_KW = {"k": 8, "emb_dims": 64}


# --- the JAX package's weights and batches (as in the one-process tests) ---------------

def _randomized_stats(variables, seed, flip_edge_scales=False):
    """BatchNorm moved off its init (`tests/test_torch_model.py`,
    `tests/test_torch_dgcnn.py`)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree.map(np.asarray, tree))
        for path, leaf in flat.items():
            is_bn = path[-2] == "bn" or path[-2].startswith("BatchNorm")
            if path[-1] in ("scale", "var"):
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
                if flip_edge_scales and path[-1] == "scale" and path[-2] == "bn":
                    leaf[::5] *= -1.0
            elif path[-1] == "mean" or (path[-1] == "bias" and is_bn):
                leaf = rng.normal(0, 0.1, leaf.shape)
            flat[path] = np.asarray(leaf, np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _pointnetpp_case():
    """`tests/test_torch_model.py`'s batch (seed 2, pinned where every
    selection agrees between the packages) and weights."""
    B, N = 2, 1024
    rng = np.random.default_rng(2)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N, N - 100], np.int32)
    jm = jax_create_model("PointNet++", num_classes=14, dropout=0.0)
    v = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(0), jnp.asarray(x))
    return (x, y, lengths), _randomized_stats(v, 4), {}


def _dgcnn_case():
    """`tests/test_torch_dgcnn.py`'s batch (seed 5, pinned where the four
    graphs agree between the packages) and weights."""
    B, N = 2, 256
    rng = np.random.default_rng(5)
    x = np.zeros((B, N, 9), np.float32)
    x[..., :3] = rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N, N - 40], np.int32)
    jm = jax_create_model("DeepGraphCnn", num_classes=14, **DGCNN_KW)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    return (x, y, lengths), _randomized_stats(v, 4, flip_edge_scales=True), DGCNN_KW


JAX_CASES = {"PointNet++": _pointnetpp_case, "DeepGraphCnn": _dgcnn_case}


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    batch, variables, kwargs = JAX_CASES[name]()
    state_dict = from_jax_variables(name, variables)
    spec = dict(model=name, model_kwargs=dict(kwargs, dropout=0.0), seed=0,
                state_dict=state_dict, batch=batch, optimizer="sgd", lr=1e-3, steps=1,
                fps_random=False)
    return batch, variables, spec


# --- the F6 input -----------------------------------------------------------------------

def _batch_norm_f6_spec():
    from pointseg_torch.nn.mlp import BatchNorm

    rng = np.random.default_rng(0)
    x = (3.0 + 0.01 * rng.normal(size=(65536, 8))).astype(np.float32)
    dy = rng.normal(size=(65536, 8)).astype(np.float32)
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 8)))
        bn.running_var.zero_()  # so the update is 0.1 x the batch's statistics
    return {"x": x, "dy": dy, "state": bn.state_dict()}


def _edgeconv_f6_spec(dtype):
    from pointseg_torch.nn import EdgeConv

    rng = np.random.default_rng(5)
    x = (8.0 + rng.normal(size=(4, 512, 8))).astype(np.float32)
    idx = rng.integers(0, 512, (4, 512, 16)).astype(np.int32)
    block = EdgeConv(8, 16, 16, dtype=dtype)
    with torch.no_grad():
        block.w_edge.weight.copy_(torch.from_numpy(rng.normal(0, 0.4, (16, 8))))
        block.w_center.weight.copy_(torch.from_numpy(rng.normal(0, 0.4, (16, 8))))
        block.bn.running_var.zero_()
    return {"x": x, "idx": idx, "out": 16, "dtype": dtype, "state": block.state_dict()}


def _room_spec(bn_stats):
    rng = np.random.default_rng(0)
    points = np.concatenate([rng.random((900, 3)) * np.array([3.0, 3.0, 1.0]),
                             rng.random((900, 3))], axis=1).astype(np.float32)
    return dict(model="PointNet", seed=1, points=points, window_size=64, overlap=16,
                bn_stats=bn_stats)


# --- the one run of the ranks -------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """(the directory the ranks write to, a one-process checkpoint they
    resume from: one DGCNN step from seed 1)."""
    root = tmp_path_factory.mktemp("dp_ckpt")
    torch.manual_seed(1)
    state = create_train_state(create_model("DeepGraphCnn", num_classes=14, **DGCNN_KW),
                               device="cpu", seed=1)
    train_step(state, *(torch.from_numpy(a) for a in _blocks(4, 256, seed=7)))
    save_checkpoint(str(root / "one_process"), state)
    return root / "from_ranks", root / "one_process"


def _jobs(ckpt_dirs):
    jobs = {}
    for name in MODELS:
        jobs[f"f32 {name}"] = ("train", _train_spec(name))
        jobs[f"f64 {name}"] = ("train", _train_spec(name, dtype=torch.float64))
        jobs[f"adam {name}"] = ("train", _train_spec(name, optimizer="adam", steps=3))
    for name in JAX_CASES:
        jobs[f"jax {name}"] = ("train", _jax_case(name)[2])
    padded = _blocks(4, 256, lengths=[256, 200, 0, 0])
    jobs["padding rank"] = ("train", _train_spec("DeepGraphCnn", batch=padded,
                                                 dtype=torch.float64))
    empty = _blocks(4, 256, lengths=[0, 0, 0, 0])
    jobs["padding all"] = ("train", _train_spec("DeepGraphCnn", batch=empty))
    micro = tuple(np.stack(parts) for parts in zip(_blocks(4, 256, seed=1),
                                                   _blocks(4, 256, seed=2)))
    jobs["accum"] = ("train", _train_spec("PointNet++", batch=micro, accum=2,
                                          dtype=torch.float64))
    jobs["bn f6"] = ("batch_norm_f6", _batch_norm_f6_spec())
    jobs["edgeconv f6 bf16"] = ("edgeconv_f6", _edgeconv_f6_spec(torch.bfloat16))
    for mode in ("running", "batch"):
        jobs[f"room {mode}"] = ("room", _room_spec(mode))
    write_to, read_from = ckpt_dirs
    jobs["checkpoints"] = ("checkpoints", dict(
        model="DeepGraphCnn", model_kwargs=DGCNN_KW, seed=2, batch=_blocks(4, 256, seed=8),
        write_to=str(write_to), read_from=str(read_from)))
    return jobs


@pytest.fixture(scope="module")
def jobs(ckpt_dirs):
    return _jobs(ckpt_dirs)


@pytest.fixture(scope="module")
def two_ranks(jobs):
    """Each rank's results of every job, from one run of two ranks."""
    results = parallel.spawn(ranks.suite, WORLD, (jobs,), timeout=RANK_TIMEOUT, threads=2)
    assert [r["f32 PointNet"]["rank"] for r in results] == [0, 1]
    return results


_ONE_PROCESS: dict = {}


def one_process(jobs, name):
    """The job on a mesh of one rank in this process, the one-process code
    (run once a module)."""
    if name not in _ONE_PROCESS:
        task, spec = jobs[name]
        _ONE_PROCESS[name] = ranks.TASKS[task](Mesh(), spec)
    return _ONE_PROCESS[name]


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _assert_same_fps(one, ranks_out):
    assert len(one["fps"]) == len(ranks_out[0]["fps"])
    for i, want in enumerate(one["fps"]):
        got = torch.cat([r["fps"][i] for r in ranks_out])
        assert torch.equal(got, want), f"FPS call {i}"


# --- two ranks against one process ---------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_two_ranks_are_the_one_process_step_in_float64(name, jobs, two_ranks):
    one = one_process(jobs, f"f64 {name}")
    r0, r1 = (r[f"f64 {name}"] for r in two_ranks)
    for r in (r0, r1):  # the loss is float32 (the models return float32 logits)
        assert abs(r["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
        assert abs(r["accuracy"] - one["accuracy"]) <= 1e-12
        assert abs(r["miou"] - one["miou"]) <= 1e-12
    assert one["grads"].keys() == r0["grads"].keys()
    for k, want in one["grads"].items():
        assert _max_abs(r0["grads"][k], want) <= 1e-9, k
    for k, want in one["params"].items():
        assert _max_abs(r0["params"][k], want) <= 1e-9, k
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for k, want in one["buffers"].items():
        np.testing.assert_allclose(r0["buffers"][k].numpy(), want.numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    _assert_same_fps(one, (r0, r1))
    if one["generator"] is not None:
        assert torch.equal(r0["generator"], one["generator"])


@pytest.mark.parametrize("name", list(MODELS))
def test_two_ranks_match_one_process_in_float32(name, jobs, two_ranks):
    """Each parameter within 2e-5 of the one-process step, or, for a leaf
    whose one-process float32 step lies more than 1e-5 from its float64
    step, no farther from the float64 step than 1.5 times that distance
    (`PYTHONPATH=. python tests/torch_parallel_ranks.py` prints these
    leaves)."""
    one = one_process(jobs, f"f32 {name}")
    one64 = one_process(jobs, f"f64 {name}")
    r0 = two_ranks[0][f"f32 {name}"]
    assert abs(r0["loss"] - one["loss"]) < 5e-4
    for k, want in one["params"].items():
        gap = _max_abs(r0["params"][k], want)
        if gap <= 2e-5:
            continue
        own = _max_abs(want, one64["params"][k])
        near = _max_abs(r0["params"][k], one64["params"][k])
        assert own > 1e-5 and near <= 1.5 * own, (k, gap, own, near)
    for k, want in one["buffers"].items():
        if want.is_floating_point():
            noise = _max_abs(want, one64["buffers"][k])
            np.testing.assert_allclose(r0["buffers"][k].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7 + 2.0 * noise, err_msg=k)
        else:
            assert torch.equal(r0["buffers"][k], want), k
    _assert_same_fps(one, [r[f"f32 {name}"] for r in two_ranks])


@pytest.mark.parametrize("name", list(MODELS))
def test_ranks_are_bit_equal_after_three_adam_steps(name, two_ranks):
    r0, r1 = (r[f"adam {name}"] for r in two_ranks)
    assert r0["losses"] == r1["losses"] and all(math.isfinite(v) for v in r0["losses"])
    for k, p in r0["final_params"].items():
        assert torch.equal(p, r1["final_params"][k]), k


def test_rank_of_padding_rows_adds_nothing_and_all_padding_gives_zero(jobs, two_ranks):
    """Rank 1's rows are all padding: its loss share is 0 and the step is
    the one-process step (float64). A global batch of padding only gives
    loss 0 on both, as the JAX loss does."""
    one = one_process(jobs, "padding rank")
    r0 = two_ranks[0]["padding rank"]
    assert abs(r0["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    for k, want in one["params"].items():
        assert _max_abs(r0["params"][k], want) <= 1e-9, k
    assert one_process(jobs, "padding all")["loss"] == 0.0
    assert [r["padding all"]["loss"] for r in two_ranks] == [0.0, 0.0]


def test_accumulated_steps_reduce_once_and_match_one_process(jobs, two_ranks):
    """`train_step_accum` with K = 2 micro-batches (float64)."""
    one = one_process(jobs, "accum")
    r0, r1 = (r["accum"] for r in two_ranks)
    assert abs(r0["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    for k, want in one["params"].items():
        assert _max_abs(r0["params"][k], want) <= 1e-9, k
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    _assert_same_fps(one, (r0, r1))  # both micro-batches' picks


# --- the JAX package on a two-device mesh ---------------------------------------------------

@pytest.fixture(autouse=True)
def _jax_oracle():
    set_use_pallas(False)
    yield
    set_use_pallas(None)


def _flax_grads(name, out, template):
    """A train run's gradients (0 where a parameter has none) in the JAX
    layout."""
    from test_torch_dgcnn import to_reference_state_dict

    sd = {k: out["grads"].get(k, torch.zeros_like(p)).float()
          for k, p in out["params"].items()}
    sd.update(out["buffers"])
    if name == "DeepGraphCnn":
        sd = to_reference_state_dict(name, sd)
    return flatten_dict(from_torch_state_dict(name, sd, template)["params"], sep="/")


def _jax_mesh_step(name, batch, variables, dtype):
    """(loss, gradients, updated batch statistics) of the JAX model's
    train-mode step on a two-device mesh, the batch sharded."""
    kwargs = DGCNN_KW if name == "DeepGraphCnn" else {}
    jm = jax_create_model(name, num_classes=14, dropout=0.0, dtype=dtype, **kwargs)
    mesh = jax_create_mesh(jax.devices()[:2])
    v = jax_shard_state(mesh, jax.tree.map(lambda a: jnp.asarray(a, dtype), variables))
    x, y, lengths = jax_shard_batch(mesh, (batch[0].astype(dtype), *batch[1:]))

    def loss_fn(params, x, y, lengths):
        logits, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                               train=True, mutable=["batch_stats"])
        return jax_ce(logits, y, lengths), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], x, y, lengths)
    return (float(loss), flatten_dict(jax.tree.map(np.asarray, grads), sep="/"),
            flatten_dict(jax.tree.map(np.asarray, stats), sep="/"))


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_two_ranks_match_jax_two_device_mesh(name, two_ranks):
    batch, variables, spec = _jax_case(name)
    r0 = two_ranks[0][f"jax {name}"]
    grads_t = _flax_grads(name, r0, variables)
    grads_64 = _flax_grads(name, train_run(Mesh(), dict(spec, dtype=torch.float64)), variables)
    loss_j, grads_j, stats_j = _jax_mesh_step(name, batch, variables, jnp.float32)
    np.testing.assert_allclose(r0["loss"], loss_j, rtol=1e-5, atol=1e-6)
    if name == "PointNet++":  # against the JAX float64 step (module docstring)
        with jax.enable_x64():
            _, grads_j, _ = _jax_mesh_step(name, batch, variables, jnp.float64)
        floor_scale, cosine, stats_atol = 2e-3, 0.995, 1e-5
    else:
        floor_scale, cosine, stats_atol = 2e-2, 0.999, 1e-4
    dots = norm_t = norm_j = 0.0
    assert grads_t.keys() == grads_j.keys()
    for k, want in grads_j.items():
        got = grads_t[k]
        cross = np.linalg.norm(got - want)
        noise = np.linalg.norm(got - grads_64[k])
        floor = floor_scale * (1.0 + np.linalg.norm(want))
        assert cross <= max(8.0 * noise, floor), (k, cross, noise, floor)
        dots += float(got.ravel() @ want.ravel())
        norm_t += float((got ** 2).sum())
        norm_j += float((want ** 2).sum())
    assert dots / np.sqrt(norm_t * norm_j) > cosine
    sd = {k: v for k, v in r0["buffers"].items()}
    sd.update(r0["params"])
    if name == "DeepGraphCnn":
        from test_torch_dgcnn import to_reference_state_dict

        sd = to_reference_state_dict(name, sd)
    flat_t = flatten_dict(from_torch_state_dict(name, sd, variables)["batch_stats"], sep="/")
    for k, want in stats_j.items():
        np.testing.assert_allclose(flat_t[k], want, rtol=1e-4, atol=stats_atol, err_msg=k)


# --- BatchNorm statistics of the global batch on the F6 input ------------------------------

def test_global_batch_norm_statistics_against_float64(jobs, two_ranks):
    """Two ranks' training BatchNorm on 65,536 rows whose mean is 300 times
    their spread, held to the one-process bounds: running statistics
    within 1e-5 (relative) of float64's batch statistics, the output
    within 1e-4, the gradients within 1e-4 of the largest."""
    from pointseg_torch.nn.mlp import BatchNorm

    spec = jobs["bn f6"][1]
    bn64 = BatchNorm(8).double().train()
    bn64.load_state_dict(spec["state"])
    x64 = torch.from_numpy(spec["x"]).double().requires_grad_(True)
    y64 = bn64(x64)
    (y64 * torch.from_numpy(spec["dy"]).double()).sum().backward()
    var64, mean64 = torch.var_mean(x64.detach(), dim=0, correction=0)
    out = [r["bn f6"] for r in two_ranks]
    for r in out:
        for got, want in ((r["running_mean"] / 0.1, mean64), (r["running_var"] / 0.1, var64)):
            assert float(((got.double() - want) / want).abs().max()) < 1e-5
    y = torch.cat([r["y"] for r in out])
    assert float((y.double() - y64.detach()).abs().max()) < 1e-4
    dx = torch.cat([r["dx"] for r in out])
    for got, want in ((dx, x64.grad), (out[0]["dweight"], bn64.weight.grad),
                      (out[0]["dbias"], bn64.bias.grad)):
        assert float((got.double() - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_global_edgeconv_statistics_against_float64(jobs, two_ranks):
    """Two ranks' fused EdgeConv in bf16 at activations whose mean is 8
    times their spread: the batch variance within 2e-2 of float64's
    (relative, per channel), the one-process bound."""
    spec = jobs["edgeconv f6 bf16"][1]
    xb = torch.from_numpy(spec["x"]).to(torch.bfloat16).double().numpy()
    we = spec["state"]["w_edge.weight"].double().numpy().T
    wc = spec["state"]["w_center.weight"].double().numpy().T
    p, d = xb @ we, xb @ (wc - we)
    idx = spec["idx"]
    edges = p[np.arange(4)[:, None, None], idx] + d[:, :, None, :]
    want_var = edges.reshape(-1, 16).var(axis=0)
    one = ranks.edgeconv_f6(Mesh(), spec)
    for r in [one] + [r["edgeconv f6 bf16"] for r in two_ranks]:
        got = r["running_var"].double().numpy() / 0.1
        assert float((np.abs(got - want_var) / want_var).max()) < 2e-2


# --- whole rooms, window groups sharded ----------------------------------------------------

@pytest.mark.parametrize("mode", ["running", "batch"])
def test_window_groups_sharded_match_unsharded(mode, jobs, two_ranks):
    """Predictions equal, confidences within 1e-5, as
    `tests/test_parallel.py` holds the JAX package's `mesh=`; with batch
    statistics every group's BatchNorm (the TNets' FC BatchNorm over the
    8 windows, 4 a rank) takes the whole group's."""
    want = room_run(Mesh(), jobs[f"room {mode}"][1])
    for r in two_ranks:
        got = r[f"room {mode}"]
        np.testing.assert_array_equal(got["preds"], want["preds"])
        np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5)


# --- checkpoints ----------------------------------------------------------------------------

def test_checkpoint_of_two_ranks_resumes_in_one_process(ckpt_dirs, two_ranks):
    """Rank 0 wrote the unwrapped model (one-process keys): a one-process
    state restores it bit for bit, with its step and FPS generator."""
    write_to, _ = ckpt_dirs
    written = two_ranks[0]["checkpoints"]["written"]
    torch.manual_seed(5)
    state = create_train_state(create_model("DeepGraphCnn", num_classes=14, **DGCNN_KW),
                               device="cpu", seed=5)
    restore_train_state(str(write_to), state)
    assert state.step == 1
    got = state.model.state_dict()
    assert got.keys() == written.keys()
    for k, want in written.items():
        assert torch.equal(got[k], want), k
    assert sorted(os.listdir(write_to)) == ["checkpoint_1.pt"]


def test_checkpoint_of_one_process_resumes_on_two_ranks(ckpt_dirs, jobs, two_ranks):
    """Every rank restores the one-process checkpoint bit for bit and the
    step it takes from there is the one-process step's (loss within 5e-4;
    the two ranks bit-equal)."""
    _, read_from = ckpt_dirs
    torch.manual_seed(1)  # the ranks' dropout generator (a checkpoint holds the FPS one only)
    state = create_train_state(create_model("DeepGraphCnn", num_classes=14, **DGCNN_KW),
                               device="cpu", seed=1)
    restore_train_state(str(read_from), state)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    gen = state.generator.get_state()
    loss = float(train_step(state, *(torch.from_numpy(a) for a in
                                     jobs["checkpoints"][1]["batch"]))["loss"])
    r0, r1 = (r["checkpoints"] for r in two_ranks)
    for r in (r0, r1):
        assert r["restored"]["step"] == 1 and torch.equal(r["restored"]["generator"], gen)
        for k, v in want.items():
            assert torch.equal(r["restored"]["model"][k], v), k
        assert abs(r["resumed_loss"] - loss) < 5e-4
    for k, p in r0["resumed_params"].items():
        assert torch.equal(p, r1["resumed_params"][k]), k
