"""`pointseg_torch/io/export_aot.py`, the kernels' operators
(`pointseg_torch/ops/library.py`) and the `export` subcommand on the CPU,
after `tests/test_export.py`.

- The artifact's forward equals the eager eval-mode forward bit for bit
  (`assert_array_equal`): the exported graph runs the same aten ops and,
  through the operators, the same plain versions, in the same order.
- Weights are runtime arguments: a second state_dict through the same
  artifact gives that model's logits; the artifact holds no tensor.
- A wrong input shape is refused by the program's guards.
- The graph names the port's operators and has no FPS loop.
- The port's artifact and the JAX package's `export_forward` artifact
  agree at rtol/atol 1e-4 on the same weights and points (PointNet++ on
  `tests/test_torch_model.py`'s pinned input, where every selection of
  the two packages agrees).
- The eager paths never go through the operators: a dispatch mode sees
  no `pointseg_torch` operator in a train step or an eval forward.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

from pointseg.io import export_aot as jax_export_aot
from pointseg.models import create_model as jax_create_model
from pointseg_torch import cli, ops
from pointseg_torch.data import synthetic
from pointseg_torch.io import export_aot, from_jax_variables
from pointseg_torch.models import create_model
from pointseg_torch.train.state import create_train_state, train_step

torch.set_num_threads(2)

SHAPES = {"PointNet": (2, 64), "PointNet++": (1, 1024), "DeepGraphCnn": (2, 256)}
OPERATORS = {
    "PointNet": set(),
    "PointNet++": {"fps", "ball_query", "three_nn", "gather_rows"},
    "DeepGraphCnn": {"knn", "gather_rows"},
}


def _points(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((*shape, 9)).astype(np.float32))


def _model(name, seed, **kwargs):
    torch.manual_seed(seed)
    model = create_model(name, **kwargs).eval()
    with torch.no_grad():  # BatchNorm off its init, so running statistics matter
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return model


def _graph_operators(blob):
    graph = str(torch.export.load(io.BytesIO(blob)).graph)
    return {name for name in ("fps", "ball_query", "ball_query_2l", "three_nn", "knn", "knn_2l",
                              "gather_rows") if f"pointseg_torch.{name}.default" in graph}, graph


@pytest.fixture(scope="module")
def artifacts():
    return {name: export_aot.export_forward(_model(name, 0), _points(shape, 0))
            for name, shape in SHAPES.items()}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_round_trip_equals_the_eager_forward(name, artifacts):
    model = _model(name, 0)
    x = _points(SHAPES[name], 1)
    got = export_aot.load_forward(artifacts[name])(model.state_dict(), x)
    with torch.no_grad():
        want = model(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_weights_are_runtime_arguments(name, artifacts):
    """The artifact traced from model 0 runs model 1's weights, and is
    smaller than half of their bytes: it holds none of them."""
    other = _model(name, 1)
    x = _points(SHAPES[name], 2)
    forward = export_aot.load_forward(artifacts[name])
    got = forward(other.state_dict(), x)
    with torch.no_grad():
        want = other(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not np.array_equal(got.numpy(), forward(_model(name, 0).state_dict(), x).numpy())
    weights = sum(t.numel() * t.element_size() for t in other.state_dict().values())
    assert len(artifacts[name]) < weights / 2


def test_wrong_shapes_are_refused(artifacts):
    forward = export_aot.load_forward(artifacts["PointNet++"])
    state = _model("PointNet++", 0).state_dict()
    with pytest.raises(Exception, match="shape|size"):
        forward(state, _points((1, 2048), 0))
    smaller = _model("PointNet++", 0, num_classes=13).state_dict()
    with pytest.raises(Exception, match="shape|size"):
        forward(smaller, _points(SHAPES["PointNet++"], 0))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_graph_holds_the_operators_and_no_fps_loop(name, artifacts):
    found, graph = _graph_operators(artifacts[name])
    assert found == OPERATORS[name]
    assert graph.count("pointseg_torch.fps.default") == (4 if name == "PointNet++" else 0)
    assert "aten.argmax" not in graph  # the plain FPS's loop is not in the graph


def test_two_level_switch_is_frozen_into_the_graph():
    """Past the flat kNN kernel's k = 32 (the enhanced trainer's k = 40)
    the shape rule picks kernel 5, and the graph holds its operator; the
    artifact equals the eager forward."""
    model = _model("DeepGraphCnn", 0, k=40)
    x = _points((1, 128), 0)
    blob = export_aot.export_forward(model, x)
    found, _ = _graph_operators(blob)
    assert found == {"knn_2l", "gather_rows"}
    got = export_aot.load_forward(blob)(model.state_dict(), x)
    with torch.no_grad():
        want = model(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_port_artifact_agrees_with_the_jax_artifact():
    # tests/test_torch_model.py's pinned input: a 1 m x 1 m x 0.3 m slab
    rng = np.random.default_rng(2)
    x = np.zeros((2, 1024, 9), np.float32)
    x[..., :3] = rng.random((2, 1024, 3)) * np.array([1.0, 1.0, 0.3])
    x[..., 3:] = rng.random((2, 1024, 6))
    jax_model = jax_create_model("PointNet++", num_classes=14, dropout=0.0)
    variables = jax.jit(lambda k, x: jax_model.init({"params": k}, x, train=False))(
        jax.random.key(0), jnp.asarray(x))
    stats = np.random.default_rng(4)
    flat = flatten_dict(jax.tree.map(np.asarray, variables["batch_stats"]))
    flat = {k: (stats.uniform(0.5, 1.5, v.shape) if k[-1] == "var"
                else stats.normal(0, 0.1, v.shape)).astype(np.float32) for k, v in flat.items()}
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": unflatten_dict(flat)}
    want = jax_export_aot.load_forward(jax_export_aot.export_forward(
        jax_model, variables, jnp.asarray(x), platforms=("cpu",)))(variables, jnp.asarray(x))

    model = create_model("PointNet++")
    model.load_state_dict(from_jax_variables("PointNet++", variables))
    got = export_aot.load_forward(export_aot.export_forward(model, torch.from_numpy(x)))(
        model.state_dict(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


class _SeenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.namespaces = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.namespaces.add(func.namespace)
        return func(*args, **(kwargs or {}))


def test_eager_paths_do_not_go_through_the_operators():
    x = _points((2, 1024), 3)
    labels = torch.nn.functional.one_hot(torch.randint(0, 14, (2, 1024)), 14)
    lengths = torch.tensor([1024, 900], dtype=torch.int32)
    for name in ("PointNet++", "DeepGraphCnn"):
        state = create_train_state(_model(name, 0), device="cpu")
        with _SeenOps() as seen:
            train_step(state, x, labels, lengths)
            with torch.no_grad():
                state.model.eval()(x)
        assert "aten" in seen.namespaces and "pointseg_torch" not in seen.namespaces, name
    with _SeenOps() as seen:  # the control: a call of an operator is seen
        torch.ops.pointseg_torch.fps(x[..., :3].contiguous(), torch.zeros(2, dtype=torch.int32),
                                     None, 8)
    assert "pointseg_torch" in seen.namespaces
    assert ops.farthest_point_sampling(x[..., :3], 8).shape == (2, 8)


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """A checkpoint of `train PointNet --bf16 --device cpu`, one epoch."""
    root = tmp_path_factory.mktemp("export_cli")
    data = synthetic.make_block_dataset(str(root / "blocks"), rooms_per_area=1,
                                        points_per_room=1500, seed=0, rgb_u8=True)
    cli.main(["train", "PointNet", "--data-dir", data, "--device", "cpu", "--epochs", "1",
              "--train-batch-size", "8", "--train-sampling", "64", "--test-sampling", "64",
              "--num-workers", "0", "--bf16", "--log-dir", str(root / "logs"),
              "--model-dir", str(root / "models")])
    (sidecar,) = list((root / "models").rglob("config.json"))
    return sidecar.parent


def test_export_subcommand_takes_bf16_from_the_sidecar(bf16_run, tmp_path, capsys):
    assert json.loads((bf16_run / "config.json").read_text())["bf16"] is True
    out = tmp_path / "pointnet.pt2"
    blob = cli.export_from_args(cli.build_parser().parse_args(
        ["export", str(bf16_run), "--out", str(out), "--npoints", "128", "--batch-size", "2",
         "--platforms", "cpu"]))
    said = capsys.readouterr().out
    assert f"Exported PointNet (B=2, N=128, platforms=cpu, bf16) -> {out} (" in said
    assert out.read_bytes() == blob
    state, _, use_bf16 = cli._model_from_sidecar(str(bf16_run), None, 14, False,
                                                 torch.device("cpu"))
    assert use_bf16 and state.model.conv1.dtype == torch.bfloat16
    x = _points((2, 128), 5)
    got = export_aot.load_forward(blob)(state.model.state_dict(), x)
    with torch.no_grad():
        want = state.model.eval()(x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("platforms,said", [
    ("cuda,cpu", "one device"), ("tpu", "JAX package"), ("cpu,tpu", "one device"),
])
def test_export_subcommand_refuses_other_platforms(bf16_run, tmp_path, platforms, said):
    with pytest.raises(SystemExit, match=said):
        cli.main(["export", str(bf16_run), "--out", str(tmp_path / "x.pt2"),
                  "--platforms", platforms])
    assert not (tmp_path / "x.pt2").exists()


def test_export_subcommand_needs_a_card_for_cuda(bf16_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["export", str(bf16_run), "--out", str(tmp_path / "x.pt2")])
