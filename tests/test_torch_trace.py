"""The program's profiler spans (`pointseg_torch/utils/trace.py`), on the CPU.

Under `torch.profiler` a train step is one `pointseg_torch.step#<n>` range
holding its forward, backward, update and metrics ranges in that order;
an epoch from the device store opens its seeding and each batch's
sampling, and the loop its host read at the epoch's close, on every
branch of `train_epoch`; the host loader's wait is on the consumer's
thread and its reads and collates on the reader threads; the
collectives and a rank's rows of a global batch are spans too. With no
profiler a span is one shared null context, and a step's outputs are
bit for bit those of a step under a profiler.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointseg_torch.data import synthetic
from pointseg_torch.data.datasets import BlockDataset, Loader
from pointseg_torch.data.device import DeviceBlockStore, DeviceEpochLoader
from pointseg_torch.models import create_model
from pointseg_torch.parallel import mesh as mesh_mod
from pointseg_torch.train.loop import train_epoch
from pointseg_torch.train.state import create_train_state, train_step, train_step_accum
from pointseg_torch.utils import trace

torch.set_num_threads(2)

C = 4
N = 256
STEP = "pointseg_torch.step"
PARTS = ("forward", "backward", "update", "metrics")


def _spans(prof, tmp_path):
    """[(name, start, end, thread)] of the program's spans, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("pointseg_torch.")), key=lambda s: s[1])


def _batch(seed, b=2, k=None):
    g = torch.Generator().manual_seed(seed)
    lead = (b,) if k is None else (k, b)
    points = torch.randn(*lead, N, 9, generator=g)
    labels = torch.nn.functional.one_hot(torch.randint(0, C, (*lead, N), generator=g), C)
    lengths = torch.full(lead, N, dtype=torch.int32)
    lengths[..., -1] = N - 17
    return points, labels.to(torch.uint8), lengths


def _pointnetpp_state(seed=0):
    torch.manual_seed(seed)
    return create_train_state(create_model("PointNet++", num_classes=C), device="cpu",
                              seed=seed)


def _nested_in_order(spans, step_name, parts):
    """The spans named `parts`, in that order, inside `step_name`'s."""
    (step,) = [s for s in spans if s[0] == step_name]
    inner = [s for s in spans if step[1] <= s[1] and s[2] <= step[2] and s is not step]
    assert [s[0] for s in inner] == [f"{STEP}.{p}" for p in parts]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # one after the other
    assert {s[3] for s in inner} == {step[3]}


def test_span_without_a_profiler_is_the_shared_null_context():
    assert trace.span("pointseg_torch.step.forward") is trace.NULL
    assert trace.span(STEP, 7) is trace.NULL
    with trace.span("pointseg_torch.step.forward") as inside:
        assert inside is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span(STEP, 7) is not trace.NULL
    assert trace.span(STEP, 7) is trace.NULL


def test_train_step_spans_nest_forward_backward_update_metrics(tmp_path):
    state = _pointnetpp_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, *_batch(0))
    spans = _spans(prof, tmp_path)
    _nested_in_order(spans, f"{STEP}#0", PARTS)
    assert {s[0] for s in spans} == {f"{STEP}#0"} | {f"{STEP}.{p}" for p in PARTS}


def test_train_step_accum_spans_a_forward_backward_metrics_per_micro_batch(tmp_path):
    state = _pointnetpp_state()
    state.step = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step_accum(state, *_batch(1, b=1, k=2))
    _nested_in_order(_spans(prof, tmp_path), f"{STEP}#5",
                     ("forward", "backward", "metrics") * 2 + ("update",))


def test_train_step_is_bit_equal_under_a_profiler():
    outs = []
    for profiled in (False, True):
        state = _pointnetpp_state(seed=3)
        batch = _batch(2)
        torch.manual_seed(11)  # dropout
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                out = train_step(state, *batch)
        else:
            out = train_step(state, *batch)
        outs.append((out, [p.detach().clone() for p in state.model.parameters()]))
    (a, pa), (b, pb) = outs
    assert all(torch.equal(a[k], b[k]) for k in ("loss", "accuracy", "miou"))
    assert len(pa) == len(pb) and all(torch.equal(x, y) for x, y in zip(pa, pb))


def _toy_store(num_blocks=5, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(50, 400, size=num_blocks)
    pts = rng.normal(size=(int(counts.sum()), 9)).astype(np.float32)
    labs = rng.integers(0, C, size=int(counts.sum())).astype(np.uint8)
    return DeviceBlockStore(pts, labs, counts, num_classes=C, device=torch.device("cpu"))


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_device_store_epoch_spans_its_start_samples_and_close(tmp_path, scan_steps):
    loader = DeviceEpochLoader(_toy_store(), batch_size=2, npoints=64, seed=1)
    state = create_train_state(create_model("DGCNN", num_classes=C, k=4, emb_dims=16),
                               device="cpu", seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_epoch(state, loader, None, 1, 0, scan_steps=scan_steps)
    spans = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    steps = len(loader)
    assert names.count("pointseg_torch.data.epoch_start") == 1
    assert names.count("pointseg_torch.data.sample") == steps
    assert names.count("pointseg_torch.loop.to_device") == (steps if scan_steps == 1 else 0)
    assert [n for n in names if n.startswith(f"{STEP}#")] == [f"{STEP}#{i}" for i in range(steps)]
    (start,) = [s for s in spans if s[0] == "pointseg_torch.data.epoch_start"]
    (close,) = [s for s in spans if s[0] == "pointseg_torch.loop.epoch_close"]
    assert start[2] <= min(s[1] for s in spans if s[0] == "pointseg_torch.data.sample")
    assert close[1] >= max(s[2] for s in spans if s[0].startswith(f"{STEP}#"))
    assert len({s[3] for s in spans}) == 1


def test_host_loader_waits_on_the_consumer_and_reads_on_the_readers(tmp_path):
    data = synthetic.make_block_dataset(str(tmp_path / "blocks"), rooms_per_area=1,
                                        points_per_room=1500, seed=0, rgb_u8=True)
    loader = Loader(BlockDataset(data, {1, 2}, 128, seed=0), batch_size=2, pad_to=128,
                    num_workers=2)
    every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        batches = list(loader)
    spans = _spans(prof, tmp_path)
    threads = {}
    for name, _, _, tid in spans:
        threads.setdefault(name.rsplit(".", 1)[1], set()).add(tid)
    assert len([s for s in spans if s[0].endswith("loader_collate")]) == len(batches)
    assert len([s for s in spans if s[0].endswith("loader_read")]) == len(loader.dataset)
    assert len([s for s in spans if s[0].endswith("loader_next")]) == len(batches) + 1
    (consumer,) = threads["loader_next"]
    assert consumer not in threads["loader_read"] | threads["loader_collate"]


@pytest.mark.parametrize("what", ["all_reduce", "broadcast", "shard"])
def test_collectives_and_shards_are_spans(tmp_path, monkeypatch, what):
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "all_reduce", lambda t, group=None: calls.append(t))
    monkeypatch.setattr(mesh_mod.dist, "broadcast",
                        lambda t, src, group=None: calls.append(t))
    two = mesh_mod.Mesh(rank=1, world_size=2)
    t = torch.ones(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if what == "all_reduce":
            mesh_mod.all_reduce_(t, two)
        elif what == "broadcast":
            mesh_mod.broadcast_(t, two)
        else:
            (rows,) = mesh_mod.ShardedLoader([(torch.arange(4),)], two)
    names = [s[0] for s in _spans(prof, tmp_path)]
    if what == "shard":
        assert names == ["pointseg_torch.data.shard"] and rows[0].tolist() == [2, 3]
    else:
        assert names == [f"pointseg_torch.collective.{what}"] and calls == [t]
