"""The port's CLI reads the JAX package's filler switch,
POINTSEG_BQ_FILLER, as `pointseg` reads it, and hands it to the model it
builds. The JAX package's other switch, POINTSEG_SELECT2L (its two-level
kNN and ball-query kernels), changes nothing here: each op picks its CUDA
kernel from the call's shape, so the model built is the same whatever
the variable says.

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
    """The model `train` builds (its seed fixed) with only `env` set."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = cli.build_parser().parse_args(
        ["train", model, "--data-dir", tiny_blocks, "--device", "cpu", "--epochs", "0",
         "--train-sampling", "1024", "--test-sampling", "1024", "--num-workers", "0",
         "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / "models")])
    state, _ = cli.train_from_args(args)
    return state.model


def _assert_select2l_changes_nothing(built, model, tiny_blocks, tmp_path, monkeypatch, env):
    """`built`, made under `env`, equals the model made without
    POINTSEG_SELECT2L: the same modules and the same weights."""
    if "POINTSEG_SELECT2L" not in env:
        return
    rest = {k: v for k, v in env.items() if k != "POINTSEG_SELECT2L"}
    plain = _build(model, tiny_blocks, tmp_path, monkeypatch, rest)
    assert repr(built) == repr(plain)
    want = plain.state_dict()
    got = built.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ids: the model, the case, what POINTSEG_SELECT2L asks for, the filler
@pytest.mark.parametrize("model,env,filler", [
    ("PointNeXt", {"POINTSEG_SELECT2L": "1"}, "repeat"),
    ("PointNet++MSG", {"POINTSEG_BQ_FILLER": "index"}, "index"),
    ("PointNet++", {"POINTSEG_SELECT2L": "true", "POINTSEG_BQ_FILLER": "index"}, "index"),
    ("PointNet++", {"POINTSEG_SELECT2L": "False", "POINTSEG_BQ_FILLER": "repeat"}, "repeat"),
    ("PointNeXt-L", {}, "repeat"),
], ids=["PointNeXt-env0-two_level-repeat", "PointNet++MSG-env1-flat-index",
        "PointNet++-env2-two_level-index", "PointNet++-env3-flat-repeat",
        "PointNeXt-L-env4-flat-repeat"])
def test_train_builds_ball_query_models_with_the_switches(tiny_blocks, tmp_path, monkeypatch,
                                                          model, env, filler):
    """The filler from the environment, and the same model whatever
    POINTSEG_SELECT2L says."""
    built = _build(model, tiny_blocks, tmp_path, monkeypatch, env)
    grouped = [m for m in built.modules() if isinstance(m, GroupedFirstLayer)]
    assert grouped
    assert all(m.filler == filler for m in grouped)
    assert not any(hasattr(m, "ball_select") for m in built.modules())
    _assert_select2l_changes_nothing(built, model, tiny_blocks, tmp_path, monkeypatch, env)


@pytest.mark.parametrize("model,env", [
    ("DeepGraphCnn", {"POINTSEG_SELECT2L": "1"}),
    ("DGCNN", {"POINTSEG_SELECT2L": "0", "POINTSEG_BQ_FILLER": "index"}),
], ids=["DeepGraphCnn-env0-two_level", "DGCNN-env1-flat"])
def test_train_builds_dgcnns_with_the_switch(tiny_blocks, tmp_path, monkeypatch, model, env):
    """No filler (a DGCNN queries no ball), and the same model whatever
    POINTSEG_SELECT2L says."""
    built = _build(model, tiny_blocks, tmp_path, monkeypatch, env)
    convs = [m for m in built.modules() if isinstance(m, EdgeConv)]
    assert len(convs) == 4
    assert not any(hasattr(m, "knn_select") or hasattr(m, "filler") for m in built.modules())
    _assert_select2l_changes_nothing(built, model, tiny_blocks, tmp_path, monkeypatch, env)


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
