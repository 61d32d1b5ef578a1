"""`train_step` replayed from its CUDA graph against `train_step` run
eagerly, on the card (`pointseg_torch/train/state.py`).

Every test here needs a CUDA device and skips without one. The file
imports no JAX; run it on the card with the other kernel tests:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph_cuda.py

Each comparison starts from copies of one warmed state (its Adam moments
made by one eager step) with equal FPS and dropout generator states, on
the same batches: three copies step eagerly (a forward hook on the model
keeps a step eager), one through the graph.

PointNet launches none of the port's kernels and its step adds with no
atomics, so its graphed steps must equal its eager ones bit for bit:
losses, parameters, BatchNorm statistics, Adam's moments, the generator.
In the other models the first step's forward has no atomics either, so
its loss and logits must be bit-equal. The backward's `index_add_` and
`edge_reduce` atomics add in another order on every run, so each first
gradient is held to the eager runs' spread: within twice the largest gap
between the first eager run and the other two, or within 1e-5 of its norm
where those gaps are smaller. Adam turns that rounding into steps of the
full rate wherever a gradient is rounding alone (a bias before a
BatchNorm), and the next forwards carry it on: at these sizes (B 2 x
1,024) the eager runs part by up to 31% (PointNet++) and 54%
(PointNeXt-XL) of a single leaf's change after three steps and by 3.8e-4
of a loss, and two eager runs of DGCNN part by 7e-7 in one process and by
8e-3 in another. So after the first step the comparison is of the whole
change of the parameters over the steps (the leaves whose first gradient
is at least 1e-3 of the median leaf's, as the benchmark's `update_gap`
takes them) within twice the eager runs' spread or 1e-2 of its norm, and
of each loss within twice their spread or 1e-3 of it. A replay that
skipped an update, read a stale rate or left `.grad` stale would move
that change by its whole size.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from pointseg_torch.models import create_model
from pointseg_torch.ops import _kernels
from pointseg_torch.train.loop import train_epoch
from pointseg_torch.train.state import STEP_GRAPHS, create_train_state, make_optimizer, train_step

pytestmark = pytest.mark.cuda

C = 14
K = 3  # steps compared
GRAD_FLOOR = 1e-5  # of the eager run's first gradient, leaf by leaf
LOSS_FLOOR = 1e-3  # of the eager run's loss
UPDATE_FLOOR = 1e-2  # of the eager run's change of the parameters over the steps
MODELS = ["PointNet++", "DGCNN", "PointNeXt-XL"]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    return torch.device("cuda")


def _batch(seed, device, b=2, n=1024):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, n, 9, generator=g)
    x[..., 3:6] *= 255
    labels = F.one_hot(torch.randint(0, C, (b, n), generator=g), C).to(torch.uint8)
    lengths = torch.full((b,), n, dtype=torch.int32)
    lengths[-1] = n - 100
    return tuple(t.to(device) for t in (x, labels, lengths))


def _warm_state(name, device, **opts):
    """A state of `name` after one eager step (Adam's moments made)."""
    torch.manual_seed(0)
    state = create_train_state(create_model(name, num_classes=C), device=device, seed=3,
                               **opts)
    hook = state.model.register_forward_hook(lambda *a: None)
    train_step(state, *_batch(100, device))
    hook.remove()
    return state


def _copy(state, opts):
    """A copy of `state` sharing no tensor with it."""
    model = copy.deepcopy(state.model)
    optimizer = make_optimizer(model.parameters(), 1e-3, **opts)
    optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    out = create_train_state(model, device=state.device, seed=0, **opts)
    out.optimizer = optimizer
    out.generator.set_state(state.generator.get_state())
    out.step = state.step
    return out


def _run(state, batches, rng, eager):
    """Steps `state` over `batches` from the dropout generator state `rng`;
    returns {losses, logits (the first step's), grads (after the first
    step), params (after the last), counts (STEP_GRAPHS added)}."""
    logits = []
    hook = (state.model.register_forward_hook(lambda m, a, out: logits.append(out.detach()))
            if eager else None)
    torch.cuda.set_rng_state(rng)
    before = dict(STEP_GRAPHS)
    losses, grads = [], None
    for i, batch in enumerate(batches):
        losses.append(train_step(state, *batch)["loss"])
        if i == 0:
            grads = [p.grad.clone() for p in state.model.parameters()]
            if not eager:
                logits.append(next(iter(state.graphs.by_key.values())).logits.clone())
    if hook is not None:
        hook.remove()
    torch.cuda.synchronize()
    return {"losses": list(torch.stack(losses)), "logits": logits[0], "grads": grads,
            "params": [p.detach().clone() for p in state.model.parameters()],
            "counts": {k: STEP_GRAPHS[k] - before[k] for k in STEP_GRAPHS}}


def _near(got, want, others, floor, what):
    gap = max(float((o - want).norm()) for o in others)
    dist, norm = float((got - want).norm()), float(want.norm())
    assert dist <= max(2 * gap, floor * norm), (what, dist, gap, norm)


def _within_eager_spread(key, graphed, eagers, floor):
    """Each of `graphed[key]` (losses, first gradients) within twice the
    largest gap between the first eager run and the others, or within
    `floor` of the first eager run's."""
    for i, got in enumerate(graphed[key]):
        _near(got.double(), eagers[0][key][i].double(),
              [run[key][i].double() for run in eagers[1:]], floor, (key, i))


def _change_within_eager_spread(graphed, eagers, base):
    """The change of the parameters from `base` over the steps, the leaves
    whose first gradient is not rounding alone, as one vector."""
    norms = [float(g.norm()) for g in eagers[0]["grads"]]
    median = sorted(norms)[len(norms) // 2]
    kept = [i for i, n in enumerate(norms) if n >= 1e-3 * median]

    def change(run):
        return torch.cat([(run["params"][i].double() - base[i].double()).flatten()
                          for i in kept])
    _near(change(graphed), change(eagers[0]), [change(run) for run in eagers[1:]],
          UPDATE_FLOOR, "change of the parameters")


def _compare(name, device, opts, batches):
    """(state before the steps, three eager runs, the graphed run, its state)."""
    base = _warm_state(name, device, **opts)
    rng = torch.cuda.get_rng_state()
    eagers = [_run(_copy(base, opts), batches, rng, eager=True) for _ in range(3)]
    state = _copy(base, opts)
    graphed = _run(state, batches, rng, eager=False)
    assert all(e["counts"] == {"captured": 0, "replayed": 0, "eager": len(batches)}
               for e in eagers)
    return base, eagers, graphed, state


@pytest.mark.parametrize("name", MODELS)
def test_graphed_steps_equal_eager_steps(device, name):
    """K steps through the graph against K eager steps: the first step's
    loss and logits bit-equal, its gradients, the later losses and the
    parameters' changes within the eager runs' spread."""
    batches = [_batch(s, device) for s in range(K)]
    base, eagers, graphed, _ = _compare(name, device, {}, batches)
    assert graphed["counts"] == {"captured": 1, "replayed": K - 1, "eager": 0}
    assert torch.equal(graphed["losses"][0], eagers[0]["losses"][0])
    assert torch.equal(graphed["logits"], eagers[0]["logits"])
    _within_eager_spread("losses", graphed, eagers, LOSS_FLOOR)
    _within_eager_spread("grads", graphed, eagers, GRAD_FLOOR)
    _change_within_eager_spread(graphed, eagers, [p.detach() for p in base.model.parameters()])


def test_pointnet_graphed_steps_are_bit_equal_to_eager_steps(device):
    """No atomics in PointNet's step: the replays leave every tensor of the
    state as the eager steps do, bit for bit, and the dropout generator
    where they leave it."""
    batches = [_batch(s, device) for s in range(K)]
    base = _warm_state("PointNet", device)
    rng = torch.cuda.get_rng_state()
    states, after = [], []
    for eager in (True, False):
        state = _copy(base, {})
        run = _run(state, batches, rng, eager)
        states.append((state, run))
        after.append(torch.cuda.get_rng_state())
    (es, e), (gs, g) = states
    assert g["counts"] == {"captured": 1, "replayed": K - 1, "eager": 0}
    assert torch.equal(after[0], after[1])
    assert all(torch.equal(a, b) for a, b in zip(g["losses"], e["losses"]))
    for (name, a), (_, b) in zip(gs.model.state_dict().items(), es.model.state_dict().items()):
        assert torch.equal(a, b), name
    for p, q in zip(gs.model.parameters(), es.model.parameters()):
        assert torch.equal(p.grad, q.grad)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(gs.optimizer.state[p][key], es.optimizer.state[q][key]), key


def test_cosine_schedule_with_a_clip_follows_the_step_count(device):
    """Warmup-cosine (the first rate 0) with a clip: every replay reads the
    rate of `TrainState.step`, as the eager steps do."""
    opts = dict(schedule="warmup_cosine", total_steps=K + 2, warmup_steps=2, grad_clip=0.5)
    batches = [_batch(s, device) for s in range(K)]
    base, eagers, graphed, state = _compare("PointNet++", device, opts, batches)
    assert graphed["counts"] == {"captured": 1, "replayed": K - 1, "eager": 0}
    assert state.step == base.step + K
    (lr,) = {float(g["lr"]) for g in state.optimizer.param_groups}
    assert lr == state.optimizer.rate(state.step - 1) and lr != state.optimizer.rate(0)
    _within_eager_spread("losses", graphed, eagers, LOSS_FLOOR)
    _change_within_eager_spread(graphed, eagers, [p.detach() for p in base.model.parameters()])


def test_a_partial_batch_captures_its_own_graph(device):
    """Full, partial, full: two graphs in one pool; the steps equal the
    eager ones within their spread, and `.grad` is the last step's."""
    full = [_batch(s, device, b=4) for s in range(2)]
    batches = [full[0], _batch(7, device, b=3), full[1]]
    base, eagers, graphed, state = _compare("PointNet++", device, {}, batches)
    assert graphed["counts"] == {"captured": 2, "replayed": 1, "eager": 0}
    assert len(state.graphs.by_key) == 2
    graph = next(iter(state.graphs.by_key.values()))
    assert all(p.grad is g for p, g in zip(graph.params, graph.grads))
    _within_eager_spread("losses", graphed, eagers, LOSS_FLOOR)
    _change_within_eager_spread(graphed, eagers, [p.detach() for p in base.model.parameters()])


def test_grad_after_a_replay_is_the_steps_gradient(device):
    """`.grad` after a replay holds the step's gradient, as after an eager
    step: the replayed gradient of one batch against the eager gradients
    of the same state and batch."""
    graphed = _copy(_warm_state("DGCNN", device), {})
    train_step(graphed, *_batch(1, device))  # the capture
    rng = torch.cuda.get_rng_state()
    runs = [_run(_copy(graphed, {}), [_batch(2, device)], rng, eager=True) for _ in range(3)]
    run = _run(graphed, [_batch(2, device)], rng, eager=False)
    assert run["counts"] == {"captured": 0, "replayed": 1, "eager": 0}
    _within_eager_spread("grads", run, runs, GRAD_FLOOR)


def test_epoch_loss_is_the_mean_of_distinct_step_losses(device):
    """`train_epoch` keeps each step's loss: the replays return copies,
    not the graph's buffer, so the epoch's mean is over distinct values."""

    class Log:
        def __init__(self):
            self.losses = []

        def add_scalar(self, tag, value, step):
            if tag == "Train/Loss":
                self.losses.append(float(value))

    state = _warm_state("PointNet++", device)
    log = Log()
    before = dict(STEP_GRAPHS)
    _, mean, _ = train_epoch(state, [_batch(s, device) for s in range(5)], log, 1, 0)
    assert STEP_GRAPHS["replayed"] - before["replayed"] == 4
    assert len(set(log.losses)) == 5
    want = float(torch.tensor(log.losses, dtype=torch.float32).mean())
    assert abs(mean - want) <= 1e-6 * abs(want)
