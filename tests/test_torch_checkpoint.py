"""Checkpoints, rate schedules and gradient clipping of the port, on the
CPU.

- `pointseg_torch.io.checkpoint`: save, latest, pruning to `keep`, no
  `.tmp` left, the sidecar, `weights_only` loading, the refusals (no
  checkpoint, another architecture, a JAX checkpoint), and a restore
  that continues bit for bit: one more `train_step` after a restore gives
  the loss, parameters, Adam state and generator state of the unbroken
  run's next step (the CPU's `index_add_` is deterministic).
- `make_optimizer`: the rate of each update against optax's schedules,
  to float32 precision (two roundings of the peak rate: the port computes
  the cosine with numpy, XLA with its own); clipping against
  `optax.clip_by_global_norm` to 1e-6.
- Five PointNet++ steps with `warmup_cosine` and clipping against the
  JAX TrainState of `pointseg/train/state.py::make_optimizer` from the
  same weights (dropout 0, every FPS started at index 0), by the rules
  of `tests/test_torch_model.py`: (a) on the port's own gradients each
  update equals optax's to rtol 2.5e-7 / atol 1e-5 * lr; (b) each step's
  loss and the five steps' parameter updates of the two packages agree
  within 8x the port's own float32 noise (the same run in float64), or
  the loss to rtol 1e-5. At Adam's 1e-3 a step moves an element by about
  the rate whatever its gradient, so elements whose gradient is float
  noise move either way in either package, and five steps spread that
  into the loss.
- The CLI: `train --model-dir D` and then `--resume` end at twice the
  steps of an epoch.
"""

import json
import os
import sys

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
from pointseg.train.state import make_optimizer as jax_make_optimizer
from pointseg.train.state import train_step as jax_train_step
from pointseg_torch import cli
from pointseg_torch.data import synthetic
from pointseg_torch.io.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_config,
    restore_train_state,
    save_checkpoint,
)
from pointseg_torch.models import create_model
from pointseg_torch.train.state import (
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    make_optimizer,
    train_step,
)
from test_torch_model import (  # noqa: F401  (batch and jax_variables are fixtures)
    LR,
    _port_model,
    batch,
    jax_variables,
)

torch.set_num_threads(2)

F32_EPS = float(np.finfo(np.float32).eps)


def _small_state(emb=16, seed=0):
    """A small DGCNN with Adam: the checkpoint's mechanics, quickly."""
    torch.manual_seed(seed)
    model = create_model("DGCNN", num_classes=4, k=4, emb_dims=emb)
    return create_train_state(model, device="cpu", seed=seed)


def _small_batch(seed=0, B=2, N=64):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32))
    y = torch.from_numpy(np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, N))])
    return x, y, torch.full((B,), N, dtype=torch.int32)


def test_save_latest_prune_and_sidecar(tmp_path):
    state = _small_state()
    batch = _small_batch()
    paths = []
    for _ in range(7):
        train_step(state, *batch)
        paths.append(save_checkpoint(str(tmp_path), state, config={"model": "DGCNN"}, keep=3))
    assert [os.path.basename(p) for p in paths] == [f"checkpoint_{i}.pt" for i in range(1, 8)]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_5.pt", "checkpoint_6.pt",
                                            "checkpoint_7.pt", "config.json"]
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_7.pt")
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    assert load_config(str(tmp_path)) == {"model": "DGCNN"}
    assert load_config(str(tmp_path / "absent")) is None
    # an explicit step names the file; keep=0 prunes nothing
    save_checkpoint(str(tmp_path), state, step=2, keep=0)
    assert (tmp_path / "checkpoint_2.pt").exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_loads_with_weights_only_and_holds_no_class(tmp_path):
    state = _small_state()
    train_step(state, *_small_batch())
    path = save_checkpoint(str(tmp_path), state)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"step", "model", "optimizer", "generator", "generator_device"}
    assert payload["generator_device"] == "cpu"
    assert payload["step"] == 1
    assert payload["model"].keys() == state.model.state_dict().keys()
    assert "conv1.bn.running_var" in payload["model"]  # BatchNorm buffers too
    assert payload["optimizer"]["state"][0]["exp_avg"].shape == \
        next(state.model.parameters()).shape
    assert torch.equal(payload["generator"], state.generator.get_state())
    assert load_checkpoint(path).keys() == payload.keys()


def test_restore_refuses_missing_wrong_and_jax_checkpoints(tmp_path):
    state = _small_state(emb=16)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path), state)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "checkpoint_3.pt"), state)
    save_checkpoint(str(tmp_path / "small"), state)
    other = _small_state(emb=32)
    with pytest.raises(ValueError, match=r"conv5\.conv\.0\.weight: \(16, 320\) vs model "
                                         r"\(32, 320\)"):
        restore_train_state(str(tmp_path / "small"), other)
    assert other.step == 0  # nothing loaded
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "checkpoint_10.msgpack").write_bytes(b"")
    for given in (tmp_path / "jax", tmp_path / "jax" / "checkpoint_10.msgpack"):
        with pytest.raises(ValueError, match=r"JAX checkpoint \(\.msgpack\).*import-torch.*"
                                             r"from_jax_variables"):
            restore_train_state(str(given), state)


def test_restore_then_a_step_equals_the_unbroken_run_bit_for_bit(batch, tmp_path):  # noqa: F811
    """PointNet++ with dropout, random FPS starts, a schedule and a clip."""
    tensors = tuple(torch.from_numpy(a) for a in batch)
    opts = dict(schedule="warmup_cosine", total_steps=6, warmup_steps=2, grad_clip=0.5)

    torch.manual_seed(0)
    state = create_train_state(create_model("PointNet++"), device="cpu", seed=3, **opts)
    for _ in range(2):
        train_step(state, *tensors)
    save_checkpoint(str(tmp_path), state)
    torch.manual_seed(11)  # the dropout masks of the next step
    want = train_step(state, *tensors)

    torch.manual_seed(1)
    resumed = create_train_state(create_model("PointNet++"), device="cpu", seed=4, **opts)
    restore_train_state(str(tmp_path), resumed)
    assert resumed.step == 2
    torch.manual_seed(11)
    got = train_step(resumed, *tensors)

    assert resumed.step == state.step == 3
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for (name, a), (_, b) in zip(resumed.model.state_dict().items(),
                                 state.model.state_dict().items()):
        assert torch.equal(a, b), name
    sa, sb = resumed.optimizer.state_dict(), state.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, moments in sb["state"].items():
        for name, value in moments.items():
            assert torch.equal(sa["state"][i][name], value), (i, name)
    assert torch.equal(resumed.generator.get_state(), state.generator.get_state())


def test_restore_keeps_a_generator_of_another_device_type(tmp_path):
    """A CUDA generator's state (16 bytes) does not fit a CPU generator
    (5,056): everything else is restored, the generator keeps its seed."""
    state = _small_state()
    train_step(state, *_small_batch())
    path = save_checkpoint(str(tmp_path), state)
    payload = torch.load(path, weights_only=True)
    payload.update(generator=torch.zeros(16, dtype=torch.uint8), generator_device="cuda")
    torch.save(payload, path)
    other = _small_state(seed=5)
    own = other.generator.get_state()
    with pytest.warns(UserWarning, match="cuda generator"):
        restore_train_state(path, other)
    assert other.step == 1 and torch.equal(other.generator.get_state(), own)
    for (name, a), (_, b) in zip(other.model.state_dict().items(),
                                 state.model.state_dict().items()):
        assert torch.equal(a, b), name


SCHEDULES = [
    ("cosine", 100, 0, optax.cosine_decay_schedule(1e-3, 100)),
    ("cosine", 12, 0, optax.cosine_decay_schedule(1e-3, 12)),
    ("warmup_cosine", 100, 0, optax.warmup_cosine_decay_schedule(0.0, 1e-3, 0, 100)),
    ("warmup_cosine", 12, 4, optax.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 12)),
    ("warmup_cosine", 1000, 37, optax.warmup_cosine_decay_schedule(0.0, 1e-3, 37, 1000)),
]


@pytest.mark.parametrize("schedule,total,warmup,optax_schedule", SCHEDULES,
                         ids=[f"{s}-{t}-{w}" for s, t, w, _ in SCHEDULES])
def test_rate_of_each_update_is_optax_schedule(schedule, total, warmup, optax_schedule):
    """optax's count is the number of updates before this one."""
    opt = make_optimizer([torch.zeros(1, requires_grad=True)], 1e-3, schedule, total, warmup)
    counts = np.arange(0, total + 5)
    want = np.asarray(jax.vmap(jax.jit(optax_schedule))(jnp.asarray(counts, jnp.int32)))
    got = np.array([opt.rate(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * F32_EPS * 1e-3)
    assert got[-1] == 0.0 and (warmup == 0 or got[0] == 0.0)
    opt.set_rate_and_clip(7)
    assert opt.param_groups[0]["lr"] == got[7]


def test_constant_rate_and_bad_options():
    opt = make_optimizer([torch.zeros(1, requires_grad=True)], 3e-4)
    assert opt.rate(0) == opt.rate(10 ** 6) == 3e-4 and opt.grad_clip is None
    with pytest.raises(ValueError, match="needs total_steps"):
        make_optimizer([torch.zeros(1, requires_grad=True)], 1e-3, "cosine")
    with pytest.raises(ValueError, match="unknown schedule"):
        make_optimizer([torch.zeros(1, requires_grad=True)], 1e-3, "linear", 10)


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["above", "below"])
def test_clip_is_optax_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((32, 9), (32,), (4, 4, 3))]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    assert (norm > max_norm) == (max_norm == 0.5)
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if max_norm == 50.0:
        for g, raw in zip(got, grads):
            assert np.array_equal(g.numpy(), raw)  # kept as they are


def _port_steps(jax_variables, tensors, dtype, steps, opts):  # noqa: F811
    """The port's `train_step` `steps` times; returns (losses, parameter
    leaves in flax layout, the gradients each update saw before its
    clip, the parameters before each update)."""
    model = _port_model(jax_variables).to(dtype)
    state = TrainState(model, make_optimizer(model.parameters(), LR, **opts), generator=None)
    raw, before = [], []
    set_rate_and_clip = state.optimizer.set_rate_and_clip

    def record(count):
        raw.append({k: p.grad.double().numpy().copy() for k, p in model.named_parameters()})
        before.append({k: p.detach().double().numpy().copy()
                       for k, p in model.named_parameters()})
        set_rate_and_clip(count)

    state.optimizer.set_rate_and_clip = record
    losses = [float(train_step(state, tensors[0].to(dtype), *tensors[1:])["loss"])
              for _ in range(steps)]
    sd = {k: v.float() for k, v in model.state_dict().items()}
    params = flatten_dict(from_torch_state_dict("PointNet++", sd, jax_variables)["params"],
                          sep="/")
    return np.array(losses), params, raw, before, model


def test_five_scheduled_clipped_steps_match_jax(batch, jax_variables):  # noqa: F811
    # one cloud of the pinned draw, whose selections agree between the
    # packages (tests/test_torch_model.py checks them on the same batch)
    batch = tuple(a[:1] for a in batch)
    x, y, lengths = batch
    steps, opts = 5, dict(schedule="warmup_cosine", total_steps=5, warmup_steps=2,
                          grad_clip=1.0)

    jm = JaxPointNetPP(num_classes=14, dropout=0.0)

    def apply_fn(variables, x, train, rngs, mutable):  # the "fps" stream withheld: starts at 0
        return jm.apply(variables, x, train=train, rngs={"dropout": rngs["dropout"]},
                        mutable=mutable)

    tx = jax_make_optimizer(LR, opts["schedule"], opts["total_steps"], opts["warmup_steps"],
                            opts["grad_clip"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax_variables["params"],
                           batch_stats=jax_variables["batch_stats"],
                           opt_state=tx.init(jax_variables["params"]), apply_fn=apply_fn,
                           tx=tx)
    jax_losses = []
    for _ in range(steps):
        jstate, m = jax_train_step(jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths),
                                   jax.random.key(0))
        jax_losses.append(float(m["loss"]))
    jax_params = flatten_dict(jax.tree.map(np.asarray, jstate.params), sep="/")
    p0 = flatten_dict(jax.tree.map(np.asarray, jax_variables["params"]), sep="/")

    tensors = tuple(torch.from_numpy(a) for a in batch)
    losses, params, raw, before, model = _port_steps(jax_variables, tensors, torch.float32,
                                                     steps, opts)
    losses64, params64, *_ = _port_steps(jax_variables, tensors, torch.float64, steps, opts)

    # (a) every update of the port is optax's chain on the same gradients
    def as_flax(leaves):
        sd = {k: torch.from_numpy(v).float() for k, v in leaves.items()}
        sd.update({k: b for k, b in model.named_buffers()})
        return from_torch_state_dict("PointNet++", sd, jax_variables)["params"]

    opt_state = tx.init(jax_variables["params"])
    update = jax.jit(tx.update)
    clipped = 0
    for t in range(steps):
        grads = as_flax(raw[t])
        norm = float(jax.jit(optax.global_norm)(grads))
        clipped += norm >= opts["grad_clip"]
        updates, opt_state = update(grads, opt_state, as_flax(before[t]))
        after = flatten_dict(jax.tree.map(np.asarray, as_flax(
            before[t + 1] if t + 1 < steps else {k: p.detach().double().numpy()
                                                 for k, p in model.named_parameters()})),
            sep="/")
        start = flatten_dict(jax.tree.map(np.asarray, as_flax(before[t])), sep="/")
        for k, u in flatten_dict(jax.tree.map(np.asarray, updates), sep="/").items():
            np.testing.assert_allclose(after[k], start[k] + u, rtol=2.5e-7, atol=1e-5 * LR,
                                       err_msg=f"update {t}: {k}")
    assert 0 < clipped, "the clip never acted: raise the test's gradients or lower grad_clip"

    # (b) the two packages' runs, within the port's own float32 noise
    noise = np.abs(losses - losses64)
    cross = np.abs(losses - np.array(jax_losses))
    assert np.all(cross <= np.maximum(8 * noise, 1e-5 * np.abs(jax_losses))), (cross, noise)
    for k, want in jax_params.items():
        d_t, d_j, d_64 = params[k] - p0[k], want - p0[k], params64[k] - p0[k]
        assert np.linalg.norm(d_t - d_j) <= 8 * np.linalg.norm(d_t - d_64), k


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each: 45 train blocks."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


def test_cli_trains_with_checkpoints_and_resumes(tiny_blocks, tmp_path, capsys, monkeypatch):
    # the metrics logger runs without TensorBoard (whose import alone takes 15 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def run(model_dir, *flags):
        args = cli.build_parser().parse_args(
            ["train", "DGCNN", "--data-dir", tiny_blocks, "--device", "cpu", "--epochs", "1",
             "--train-sampling", "256", "--test-sampling", "256", "--num-workers", "0",
             "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / model_dir),
             "--lr-schedule", "warmup_cosine", "--warmup-steps", "2", "--grad-clip", "1.0",
             *flags])
        return cli.train_from_args(args)

    first, _ = run("first")
    (run_dir,) = (tmp_path / "first" / "DGCNN").iterdir()
    assert sorted(os.listdir(run_dir)) == ["checkpoint_6.pt", "config.json"]
    config = json.loads((run_dir / "config.json").read_text())
    assert config["model"] == "DGCNN" and config["static_graph"] is False
    assert config["lr_schedule"] == "warmup_cosine" and config["grad_clip"] == 1.0
    assert config["filler"] is None  # a DGCNN queries no ball
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"Model checkpoints saved to: {run_dir}."

    resumed, _ = run("second", "--resume", str(run_dir))
    assert f"Resumed from step {first.step}." in capsys.readouterr().out
    assert resumed.step == 2 * first.step == 12
    (second_dir,) = (tmp_path / "second" / "DGCNN").iterdir()
    assert load_checkpoint(latest_checkpoint(str(second_dir)))["step"] == 12
