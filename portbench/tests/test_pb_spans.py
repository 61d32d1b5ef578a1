"""`portbench/spans.py` and the metrics that read the program's spans, on a
hand-made Chrome trace: a kernel launched from a second thread inside a
main-thread span counts and one launched after it does not, and an idle
gap inside the epoch's close counts toward `loop.epoch_idle_ms`."""

import json

import pytest

from portbench import harness, spans, tracefile, work

MAIN, AUTOGRAD = 1, 2
WINDOW = "portbench.window"


def _window(tmp_path, ranges, kernels):
    """`ranges`: (name, start, end) on the main thread; `kernels`: (launch
    time, launching thread, start, end[, name]) on the device."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0.0, "dur": 1000.0,
               "tid": MAIN}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
                "tid": MAIN} for n, a, b in ranges]
    for i, (launch, tid, a, b, *name) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 1.0, "tid": tid, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": name[0] if name else f"k{i}",
                       "ts": a, "dur": b - a, "tid": 7, "args": {"correlation": i}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracefile.Window(str(path), WINDOW)


def _readings(win, steps=2):
    return {"profile": {"host_window": win, "steps": steps}, "cuda": True}


def test_a_span_counts_what_any_thread_launched_inside_it(tmp_path):
    win = _window(tmp_path, [("pointseg_torch.step.backward", 100.0, 200.0)], [
        (150.0, AUTOGRAD, 300.0, 350.0),  # launched inside, by autograd's thread: counts
        (120.0, MAIN, 350.0, 370.0),      # launched inside, by the main thread: counts
        (250.0, AUTOGRAD, 400.0, 430.0),  # launched after the span: does not
    ])
    assert spans.launched_s(win, "pointseg_torch.step.backward") == pytest.approx(70e-6)
    # the main thread's launches alone, as `range_device_s` counts them
    assert win.range_device_s("pointseg_torch.step.")["pointseg_torch.step.backward"] == \
        pytest.approx(20e-6)
    read = harness.metric_reader("step.backward_ms").read
    assert read(_readings(win)) == pytest.approx(70e-6 / 2 * 1e3)
    assert harness.metric_reader("step.forward_ms").read(_readings(win)) is None
    assert read({**_readings(win), "cuda": False}) is None


def test_sampling_reads_the_sample_and_epoch_start_spans(tmp_path):
    win = _window(tmp_path, [("pointseg_torch.data.epoch_start", 10.0, 20.0),
                             ("pointseg_torch.data.sample", 30.0, 40.0)],
                  [(15.0, MAIN, 50.0, 60.0), (35.0, MAIN, 60.0, 64.0), (45.0, MAIN, 64.0, 99.0)])
    assert harness.metric_reader("data.sample_device_ms").read(_readings(win, 1)) == \
        pytest.approx(14e-3)


def test_an_idle_gap_inside_the_epoch_close_counts(tmp_path):
    win = _window(tmp_path, [("pointseg_torch.loop.epoch_close", 500.0, 560.0),
                             ("pointseg_torch.data.epoch_start", 600.0, 620.0)], [
        (400.0, MAIN, 480.0, 520.0),  # the queue drains into the close
        (610.0, MAIN, 640.0, 700.0),  # the next epoch's first work
        (700.0, MAIN, 750.0, 760.0),
    ])
    # idle from 520 (busy until then) to 640
    assert spans.epoch_idle_s(win) == pytest.approx(120e-6)
    assert harness.metric_reader("loop.epoch_idle_ms").read(_readings(win, 4)) == \
        pytest.approx(120e-6 / 4 * 1e3)


def test_a_program_without_spans_reads_nothing(tmp_path):
    win = _window(tmp_path, [("portbench.op#0.knn_indices", 10.0, 20.0)],
                  [(15.0, MAIN, 50.0, 60.0)])
    for name in ("step.forward_ms", "step.backward_ms", "step.update_ms", "step.metrics_ms",
                 "data.sample_device_ms", "loop.epoch_idle_ms"):
        assert harness.metric_reader(name).read(_readings(win)) is None


def test_an_op_reads_its_range_and_its_backward_kernel(tmp_path):
    """`edge_reduce`'s forward kernel inside its call's range and its backward
    kernel, launched by autograd's thread outside it, count toward
    `ops.edge_reduce_*`; `ops.device_ms` and `ops_roofline` read the kNN
    alone, as before the op was traced."""
    win = _window(tmp_path, [("portbench.op#0.knn_indices", 10.0, 20.0),
                             ("portbench.op#1.edge_reduce", 30.0, 40.0)], [
        (15.0, MAIN, 100.0, 130.0, "knn_flat_kernel<true, 8>"),
        (35.0, MAIN, 130.0, 170.0, "void edge_reduce_kernel<float, 4, unsigned char>"),
        (50.0, AUTOGRAD, 200.0, 260.0, "void edge_reduce_backward_kernel<float, 4>"),
        (60.0, AUTOGRAD, 260.0, 400.0, "sgemm"),  # the rest of the backward pass
    ])
    ranges = harness.loop_module("train").OpRanges()
    knn = [((32, 4096, 3), 4), 20]
    edge = [((32, 4096, 64), 4), ((32, 4096, 20), 4), True]
    ranges.calls = [("knn_indices", knn), ("edge_reduce", edge)]
    ranges.saved = {"knn_indices": None, "edge_reduce": None}
    r = {"profile": {"ops": ranges.readings(win), "steps": 2}, "cuda": True}
    assert r["profile"]["ops"]["edge_reduce"]["calls"] == 1
    op = harness.op_module("edge_reduce")
    bound = work.bound_seconds(*op.work(edge)) + work.bound_seconds(*op.backward_work(edge))
    assert harness.metric_reader("ops.edge_reduce_ms").read(r) == pytest.approx(100e-6 / 2 * 1e3)
    assert harness.metric_reader("ops.edge_reduce_roofline").read(r) == \
        pytest.approx(100.0 * bound / 100e-6)
    knn_bound = work.bound_seconds(*harness.op_module("knn_indices").work(knn))
    assert harness.metric_reader("ops.device_ms").read(r) == pytest.approx(30e-6 / 2 * 1e3)
    assert harness.metric_reader("ops_roofline").read(r) == pytest.approx(100.0 * knn_bound / 30e-6)
    # a cell whose model calls no edge_reduce, and a CPU run, read nothing
    r["profile"]["ops"].pop("edge_reduce")
    assert harness.metric_reader("ops.edge_reduce_ms").read(r) is None
    assert harness.metric_reader("ops.device_ms").read({**r, "cuda": False}) is None
