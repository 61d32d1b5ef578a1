"""The port's CLI reads the JAX package's two environment switches,
POINTSEG_SELECT2L (the two-level kNN and ball-query kernels) and
POINTSEG_BQ_FILLER (the ball-query filler), as `pointseg` reads them,
and hands them to the model it builds.

`train_from_args` runs with `--epochs 0` on a tiny synthetic dataset:
it builds the data, the model and the train state and trains nothing.
Under POINTSEG_BQ_FILLER=index the PointNeXt it builds gives the JAX
model's eval logits under the same variable, from the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointnext import MODELS, _assert_same_selections, _batch

from pointseg.io.torch_import import from_torch_state_dict
from pointseg.models import create_model as jax_create_model
from pointseg_torch import cli
from pointseg_torch.data import synthetic
from pointseg_torch.models import create_model
from pointseg_torch.nn.blocks import EdgeConv, GroupedFirstLayer

torch.set_num_threads(2)

SWITCHES = ("POINTSEG_SELECT2L", "POINTSEG_BQ_FILLER")


@pytest.fixture(scope="module")
def tiny_blocks(tmp_path_factory):
    """Six areas of one small synthetic room each."""
    return synthetic.make_block_dataset(
        str(tmp_path_factory.mktemp("blocks")), rooms_per_area=1,
        points_per_room=1500, seed=0, rgb_u8=True)


def _build(model, tiny_blocks, tmp_path, monkeypatch, env):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = cli.build_parser().parse_args(
        ["train", model, "--data-dir", tiny_blocks, "--device", "cpu", "--epochs", "0",
         "--train-sampling", "1024", "--test-sampling", "1024", "--num-workers", "0",
         "--log-dir", str(tmp_path / "logs")])
    state, _ = cli.train_from_args(args)
    return state.model


@pytest.mark.parametrize("model,env,select,filler", [
    ("PointNeXt", {"POINTSEG_SELECT2L": "1"}, "two_level", "repeat"),
    ("PointNet++MSG", {"POINTSEG_BQ_FILLER": "index"}, "flat", "index"),
    ("PointNet++", {"POINTSEG_SELECT2L": "true", "POINTSEG_BQ_FILLER": "index"},
     "two_level", "index"),
    ("PointNet++", {"POINTSEG_SELECT2L": "False", "POINTSEG_BQ_FILLER": "repeat"},
     "flat", "repeat"),
    ("PointNeXt-L", {}, "flat", "repeat"),
])
def test_train_builds_ball_query_models_with_the_switches(tiny_blocks, tmp_path, monkeypatch,
                                                          model, env, select, filler):
    built = _build(model, tiny_blocks, tmp_path, monkeypatch, env)
    grouped = [m for m in built.modules() if isinstance(m, GroupedFirstLayer)]
    assert grouped
    assert all(m.ball_select == select and m.filler == filler for m in grouped)


@pytest.mark.parametrize("model,env,select", [
    ("DeepGraphCnn", {"POINTSEG_SELECT2L": "1"}, "two_level"),
    ("DGCNN", {"POINTSEG_SELECT2L": "0", "POINTSEG_BQ_FILLER": "index"}, "flat"),
])
def test_train_builds_dgcnns_with_the_switch(tiny_blocks, tmp_path, monkeypatch, model, env,
                                             select):
    built = _build(model, tiny_blocks, tmp_path, monkeypatch, env)
    convs = [m for m in built.modules() if isinstance(m, EdgeConv)]
    assert len(convs) == 4 and built.knn_select == select
    assert all(m.knn_select == select for m in convs)


def test_train_refuses_a_filler_the_jax_package_does_not_know(tiny_blocks, tmp_path,
                                                             monkeypatch):
    with pytest.raises(SystemExit, match="POINTSEG_BQ_FILLER"):
        _build("PointNeXt", tiny_blocks, tmp_path, monkeypatch,
               {"POINTSEG_BQ_FILLER": "nearest"})


def test_index_filler_from_the_environment_gives_the_jax_models_logits(tiny_blocks, tmp_path,
                                                                       monkeypatch):
    """The PointNeXt that `train` builds under POINTSEG_BQ_FILLER=index,
    its weights carried into the JAX model, against that model run under
    the same variable; with the repeat filler the same weights give logits
    outside the tolerance on this slab, whose sparse balls hold fillers."""
    model = _build("PointNeXt", tiny_blocks, tmp_path, monkeypatch,
                   {"POINTSEG_BQ_FILLER": "index"}).eval()
    x = _batch(MODELS["PointNeXt"][1])[0][:1]
    with monkeypatch.context() as default_filler:  # the replay compares raw picks
        default_filler.delenv("POINTSEG_BQ_FILLER")
        _assert_same_selections("PointNeXt", x)
    jm = jax_create_model("PointNeXt", num_classes=14)
    template = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(0), jnp.asarray(x))
    variables = from_torch_state_dict("PointNeXt", model.state_dict(), template)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x)))
    repeat = create_model("PointNeXt").eval()
    repeat.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_repeat = repeat(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the comparison tells the fillers apart at these fresh weights
    assert not np.allclose(got_repeat.numpy(), want, rtol=1e-4, atol=1e-4)
