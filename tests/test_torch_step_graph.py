"""When `train_step` replays a CUDA graph and when it runs eagerly
(`pointseg_torch/train/state.py::_graph_blocked`), on the CPU.

A step is graphed only where nothing it can see makes a replay wrong;
each condition below alone makes it eager, and a real step under it (on
the CPU) is counted as eager in `STEP_GRAPHS`. The card's side, graphed
steps against eager ones, is `tests/test_torch_step_graph_cuda.py`.
"""

import copy
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointseg_torch.models import create_model
from pointseg_torch.parallel.mesh import Mesh
from pointseg_torch.train import state as S
from pointseg_torch.train.loop import train_epoch

torch.set_num_threads(2)

C = 4
N = 256
CARD = types.SimpleNamespace(is_cuda=True)  # what `_graph_blocked` reads of a card batch


def _batch(seed, b=2):
    g = torch.Generator().manual_seed(seed)
    points = torch.randn(b, N, 9, generator=g)
    labels = torch.nn.functional.one_hot(torch.randint(0, C, (b, N), generator=g), C)
    lengths = torch.full((b,), N, dtype=torch.int32)
    lengths[-1] = N - 17
    return points, labels.to(torch.uint8), lengths


def _state(**opts):
    torch.manual_seed(0)
    return S.create_train_state(create_model("DGCNN", num_classes=C, k=4, emb_dims=16),
                                device="cpu", seed=0, **opts)


@pytest.fixture
def stepped(monkeypatch):
    """A state after one step (Adam's moments made), in a process that has
    stepped on the card: every condition of a replay met but the device."""
    state = _state()
    S.train_step(state, *_batch(0))
    monkeypatch.setattr(S, "_warm", True)
    return state


def _hook(kind):
    def add(state):
        module = state.model.conv2
        if kind == "forward":
            return module.register_forward_hook(lambda *a: None)
        if kind == "forward_pre":
            return module.register_forward_pre_hook(lambda *a: None)
        if kind == "backward":
            return module.register_full_backward_hook(lambda *a: None)
        if kind == "backward_pre":
            return module.register_full_backward_pre_hook(lambda *a: None)
        if kind == "optimizer_pre":
            return state.optimizer.register_step_pre_hook(lambda *a: None)
        return torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
    return add


BLOCKERS = {
    "forward_hook": _hook("forward"),
    "forward_pre_hook": _hook("forward_pre"),
    "backward_hook": _hook("backward"),
    "backward_pre_hook": _hook("backward_pre"),
    "global_forward_hook": _hook("global"),
    "optimizer_step_pre_hook": _hook("optimizer_pre"),
}


def test_a_card_batch_with_nothing_in_the_way_is_graphed(stepped):
    assert not S._graph_blocked(stepped, CARD)


def test_cpu_tensors_run_eagerly_and_are_counted(stepped):
    assert S._graph_blocked(stepped, _batch(1)[0])
    before = dict(S.STEP_GRAPHS)
    S.train_step(stepped, *_batch(1))
    assert {k: S.STEP_GRAPHS[k] - before[k] for k in before} == {
        "captured": 0, "replayed": 0, "eager": 1}


@pytest.mark.parametrize("name", sorted(BLOCKERS))
def test_a_hook_makes_the_step_eager(stepped, name):
    handle = BLOCKERS[name](stepped)
    try:
        assert S._graph_blocked(stepped, CARD)
        before = S.STEP_GRAPHS["eager"]
        S.train_step(stepped, *_batch(1))
        assert S.STEP_GRAPHS["eager"] == before + 1
    finally:
        handle.remove()
    assert not S._graph_blocked(stepped, CARD)


def test_a_mesh_makes_the_step_eager(stepped):
    stepped.mesh = Mesh()
    assert S._graph_blocked(stepped, CARD)
    before = S.STEP_GRAPHS["eager"]
    S.train_step(stepped, *_batch(1))
    assert S.STEP_GRAPHS["eager"] == before + 1


def test_a_recording_profiler_makes_the_step_eager(stepped):
    with profile(activities=[ProfilerActivity.CPU]):
        assert S._graph_blocked(stepped, CARD)
        before = S.STEP_GRAPHS["eager"]
        S.train_step(stepped, *_batch(1))
        assert S.STEP_GRAPHS["eager"] == before + 1
    assert not S._graph_blocked(stepped, CARD)


def test_no_capture_before_the_first_eager_step_or_update(monkeypatch):
    state = _state()
    monkeypatch.setattr(S, "_warm", True)
    assert S._graph_blocked(state, CARD)  # no Adam moments yet: they would be made in the graph
    S.train_step(state, *_batch(0))
    assert not S._graph_blocked(state, CARD)
    monkeypatch.setattr(S, "_warm", False)
    assert S._graph_blocked(state, CARD)


def test_an_optimizer_that_is_not_make_optimizers_runs_eagerly(stepped):
    stepped.optimizer = torch.optim.SGD(stepped.model.parameters(), lr=1e-3)
    assert S._graph_blocked(stepped, CARD)


def test_graphs_are_dropped_when_the_state_they_captured_changes(stepped):
    graphs = stepped.graphs
    graphs.refresh(stepped)
    graphs.by_key["shape"] = "a graph"
    graphs.refresh(stepped)
    assert graphs.by_key  # nothing changed
    stepped.optimizer.load_state_dict(copy.deepcopy(stepped.optimizer.state_dict()))
    graphs.refresh(stepped)
    assert not graphs.by_key  # the moments are new tensors
    graphs.by_key["shape"] = "a graph"
    weight = next(stepped.model.parameters())
    weight.data = weight.data.clone()
    graphs.refresh(stepped)
    assert not graphs.by_key  # a parameter moved


def test_set_rate_keeps_cpu_groups_plain_after_a_card_checkpoint():
    """A state dict saved on the card holds each group's rate as a tensor,
    fused and capturable; restored on the CPU, the rate is a float again
    and the update runs torch's plain Adam."""
    state = _state(schedule="cosine", total_steps=10)
    S.train_step(state, *_batch(0))
    saved = copy.deepcopy(state.optimizer.state_dict())
    for group in saved["param_groups"]:
        group.update(lr=torch.tensor(group["lr"]), capturable=True, fused=True)
    state.optimizer.load_state_dict(saved)
    S.train_step(state, *_batch(1))
    (group,) = state.optimizer.param_groups
    assert group["lr"] == state.optimizer.rate(1) and isinstance(group["lr"], float)
    assert group["capturable"] is False and group["fused"] is False


class _LossLog:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Train/Loss":
            self.losses.append(float(value))


def test_epoch_loss_is_the_mean_of_the_step_losses():
    log = _LossLog()
    state = _state()
    _, mean, steps = train_epoch(state, [_batch(s) for s in range(4)], log, 1, 0)
    assert steps == 4 and len(set(log.losses)) == 4
    assert abs(mean - float(torch.tensor(log.losses).mean())) <= 1e-6 * abs(mean)
