"""Closed-loop training of one cell: the program's own `train_epoch` ->
`to_device` -> `train_step` path, epoch after epoch, over a feed that
wraps the program's loader (the host `Loader`, or the device store's
`DeviceEpochLoader`).

A run, in order:

1. Set-up: the kernels built (or found in the checkout's build
   directory), the blocks made (or found in `portbench/.cache/data/`),
   the weights made on the card from the seed and loaded into the
   program's model, its train state and its loader.
2. The first steps, through `train_epoch` and the feed like every other:
   steps 1-3 record their batches, losses and first-step logits, the
   first gradient as Adam holds it, and the parameters after step 3;
   further steps warm up until `warmup_steps`. Set-up ends here.
3. The window: `--seconds` of steps with CUDA events at every hand-over
   of a batch and at the close, read after the window; the host's spans
   around the loader's `next()` and between hand-overs.
4. With `--trace 1`: two profiled stretches of `trace_steps` steps a few
   steps into a fresh epoch, each opened by a spin kernel: the device
   alone, then host and device with the port's public ops that have a
   work count (`portbench/opwork/`) wrapped in named ranges
   (`portbench.op#<call>.<op>`).
5. The program's state freed, then the reference's three steps on the
   recorded batches and the comparison (`portbench/check.py`).
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, harness, tracefile, work
from portbench.data import rooms
from portbench.reference.models import make_weights
from portbench.reference.train import reference_steps

WINDOW_RANGE = "portbench.window"
OP_PREFIX = "portbench.op#"
RECORDED_STEPS = 3
TRACE_SKIP = 5  # steps into the fresh epoch before the profiled stretch


def _seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit streams from the run's seed."""
    s = np.random.SeedSequence(seed).generate_state(4, np.uint64)
    return dict(zip(("weights", "fps", "dropout", "loader"), (int(x) >> 1 for x in s)))


class LossLog:
    """A `MetricsLogger` stand-in that keeps the train loss of each step."""

    def __init__(self):
        self.losses: list[float] = []

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if tag == "Train/Loss":
            self.losses.append(float(value))


class Feed:
    """The iterable handed to `train_epoch`: each pass walks one epoch of
    the program's loader and stops early where the phase ends.

    At every hand-over of a batch it counts the step and, while
    `recording`, records a CUDA event on the current stream (on the CPU,
    the host clock), the host time since the previous hand-over outside
    the loader, and the time inside the loader's `next()`."""

    def __init__(self, loader, device: torch.device):
        self.loader = loader
        self.cuda = device.type == "cuda"
        self.handed = 0
        self.reset(limit=None, deadline=None)

    def reset(self, limit, deadline, recording: bool = False, on_ask=None, on_batch=None,
              ranges: bool = False):
        self.limit, self.deadline, self.recording = limit, deadline, recording
        self.on_ask, self.on_batch, self.ranges = on_ask, on_batch, ranges
        self.steps = 0
        self.closed = False
        self.marks: list = []
        self.host_s: list[float] = []
        self.wait_s: list[float] = []
        self.lengths: list = []
        self._t_handed = None

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]

    def _done(self, now: float) -> bool:
        return ((self.limit is not None and self.steps >= self.limit)
                or (self.deadline is not None and now >= self.deadline))

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t_ask = time.perf_counter()
            if self.on_ask is not None:
                self.on_ask(self.steps)
            if self._done(t_ask):
                if self.recording and self._t_handed is not None:
                    self.host_s.append(t_ask - self._t_handed)
                    self._mark()
                self.closed = True
                return
            if self.ranges:
                with torch.profiler.record_function("portbench.data.next"):
                    batch = next(it, None)
            else:
                batch = next(it, None)
            if batch is None:
                return  # the epoch is over; `train_epoch` returns and the next begins
            t_got = time.perf_counter()
            if self.recording:
                if self._t_handed is not None:
                    self.host_s.append(t_ask - self._t_handed)
                self.wait_s.append(t_got - t_ask)
                self.lengths.append(batch[2])
                self._mark()
            if self.on_batch is not None:
                self.on_batch(self.steps, batch)
            self.steps += 1
            self.handed += 1
            self._t_handed = time.perf_counter()
            yield batch


class OpRanges:
    """Wraps the public functions of `pointseg_torch.ops` that the blocks
    call as `ops.<name>` and that have a work count, so that each forward
    call runs inside a named profiler range and its argument shapes are
    kept for the count."""

    def __init__(self):
        import pointseg_torch.ops as ops

        self.ops = ops
        self.calls: list = []
        self.saved = {}

    def __enter__(self):
        for name in harness.traced_ops():
            fn = getattr(self.ops, name, None)
            if fn is None:  # an op the program does not have: nothing to read
                continue
            self.saved[name] = fn
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        calls = self.calls

        def wrapped(*args, **kwargs):
            shapes = [(tuple(a.shape), a.element_size()) if isinstance(a, torch.Tensor) else a
                      for a in args if isinstance(a, (torch.Tensor, int))]
            i = len(calls)
            calls.append((name, shapes))
            with torch.profiler.record_function(f"{OP_PREFIX}{i}.{name}"):
                return fn(*args, **kwargs)

        return wrapped

    def readings(self, win) -> dict:
        """{op: {"calls", "device_s", "bound_s"}} over the host-traced
        window `win`: the device time of what each forward call launched
        inside its range, plus the kernels of the op's `BACKWARD_KERNELS`
        wherever launched, and the bound times of the calls that ran on
        the device (and of their backward passes, for such an op)."""
        per_range = win.range_device_s(OP_PREFIX)
        modules = {name: harness.op_module(name) for name in self.saved}
        out = {}
        for i, (name, args) in enumerate(self.calls):
            r = out.setdefault(name, {"calls": 0, "device_s": 0.0, "bound_s": 0.0})
            r["calls"] += 1
            t = per_range.get(f"{OP_PREFIX}{i}.{name}", 0.0)
            if t > 0:
                r["device_s"] += t
                r["bound_s"] += work.bound_seconds(*modules[name].work(args))
                if hasattr(modules[name], "backward_work"):
                    r["bound_s"] += work.bound_seconds(*modules[name].backward_work(args))
        for name, r in out.items():
            kernels = getattr(modules[name], "BACKWARD_KERNELS", ())
            if kernels and r["device_s"] > 0:
                r["device_s"] += win.kernel_s(*kernels)
        return out


class TrainRun:
    """One run of a training cell (module docstring)."""

    def __init__(self, config: dict, traffic: dict, data_params: dict, seed: int,
                 device: torch.device, log, program_dtype: str | None = None,
                 tf32: bool | None = None):
        for key in ("ranks", "scan_steps", "accum_steps"):
            if traffic.get(key, 1) != 1:  # each needs its own timing and reference steps
                raise ValueError(f"the train loop runs {key} = 1 only, not {traffic[key]}")
        self.config, self.traffic, self.data_params = config, traffic, data_params
        self.seeds = _seeds(seed)
        self.device = device
        self.log = log
        self.dtype = program_dtype or traffic.get("dtype", config["dtype"])
        self.tf32 = traffic.get("tf32", config["tf32"]) if tf32 is None else tf32
        self.arch = config["arch"]
        self.B, self.N = traffic["batch"], traffic["points"]
        self.rec = {"losses": [], "batches": [], "logits": None, "grads": None,
                    "params": None}

    # -- set-up ---------------------------------------------------------------------------
    def setup(self) -> None:
        from pointseg_torch.ops import _kernels

        if self.device.type == "cuda":
            t = time.perf_counter()
            torch.empty(1, device=self.device)
            self.log(f"setup: CUDA context, {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            built = set(Path(_kernels.BUILD_ROOT).glob("*/libpointseg_kernels.so"))
            lib = _kernels.build()  # the build directory is keyed by the sources' digest
            _kernels.library()
            self.log(f"setup: kernel build {'hit' if lib in built else 'miss'} ({lib}), "
                     f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self.data_dir, self.manifest = rooms.ensure_dataset(self.data_params, log=self.log)
        self.log(f"setup: data {len(self.manifest['blocks'])} blocks, "
                 f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self._make_model()
        self.log(f"setup: model {self.config['model']} ({self.dtype}), "
                 f"{time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self._make_loader()
        self.log(f"setup: {self.traffic['feed']} feed, {time.perf_counter() - t:.3f} s")

    def _make_model(self) -> None:
        from pointseg_torch.models import create_model
        from pointseg_torch.train.state import create_train_state

        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        specs = harness.arch_module(self.arch).specs(**self.config.get("arch_kwargs", {}))
        self.weights = make_weights(specs, self.seeds["weights"], self.device)
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]
        model = create_model(self.config["model"], num_classes=self.config["num_classes"],
                             dtype=dtype, in_dim=self.config["in_dim"],
                             **self.config.get("model_kwargs", {}))
        params = dict(model.named_parameters())
        if set(params) != set(self.weights):
            raise RuntimeError("the program's parameters are not the reference's: "
                               f"{sorted(set(params) ^ set(self.weights))}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(self.weights[name])
        self.state = create_train_state(model, device=self.device,
                                        learning_rate=self.config["learning_rate"],
                                        seed=self.seeds["fps"])
        self.weights = {n: w.detach().cpu() for n, w in self.weights.items()}

    def _make_loader(self) -> None:
        feed = self.traffic["feed"]
        train_areas = set(self.data_params["areas"])
        seed = self.seeds["loader"]
        if feed == "loader":
            from pointseg_torch.data.datasets import BlockDataset, Loader

            ds = BlockDataset(str(self.data_dir), train_areas, self.N, seed)
            loader = Loader(ds, self.B, shuffle=True, drop_last=False, pad_to=self.N, seed=seed,
                            num_workers=self.traffic["workers"])
        elif feed == "store":
            from pointseg_torch.data.datasets import BlockDataset
            from pointseg_torch.data.device import device_store_or_host_loader

            ds = BlockDataset(str(self.data_dir), train_areas, sampling=None, seed=seed)
            pack = Path(__file__).resolve().parent.parent / ".cache" / "pack"
            loader, mode = device_store_or_host_loader(
                ds, self.B, self.N, seed=seed, device=self.device,
                num_workers=max(self.traffic["workers"], 4),
                layout=self.traffic["store_layout"], pack_cache=str(pack))
            if mode != self.traffic["store_layout"].replace("flat", "device"):
                raise RuntimeError(f"the device store fell back to '{mode}': "
                                   f"{loader.policy_reason}")
            self.log(f"setup: store {mode}, {loader.store.nbytes} bytes resident "
                     f"({loader.policy_reason})")
        else:
            raise ValueError(f"unknown feed {feed!r}")
        self.feed = Feed(loader, self.device)

    # -- the program's steps ---------------------------------------------------------------
    def _epochs(self, logger=None) -> None:
        from pointseg_torch.train.loop import train_epoch

        while not self.feed.closed:
            self.state, _, _ = train_epoch(self.state, self.feed, logger, 1, self.state.step)

    def first_steps(self) -> None:
        """Steps 1-3 recorded, then warm-up to `warmup_steps` (set-up)."""
        rec, model, opt = self.rec, self.state.model, self.state.optimizer
        names = [n for n, _ in model.named_parameters()]

        def on_ask(step):
            if step == 1:  # after step 1: Adam's first moment is (1 - beta1) * g1
                beta1 = opt.param_groups[0]["betas"][0]
                rec["grads"] = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).detach().cpu()
                                for n, p in model.named_parameters() if p in opt.state}
            if step == RECORDED_STEPS:
                rec["params"] = {n: p.detach().cpu().clone() for n, p in
                                 model.named_parameters()}

        def on_batch(step, batch):
            if step < RECORDED_STEPS:
                rec["batches"].append(tuple(
                    a.detach().cpu().clone() if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.array(a)) for a in batch))

        def keep_logits(module, inputs, output):
            if rec["logits"] is None:
                rec["logits"] = output.detach().float().cpu()

        hook = model.register_forward_hook(keep_logits)
        log = LossLog()
        torch.manual_seed(self.seeds["dropout"])
        self.feed.reset(limit=RECORDED_STEPS, deadline=None, on_ask=on_ask,
                        on_batch=on_batch)
        try:
            self._epochs(logger=log)
        finally:
            hook.remove()
        rec["losses"] = log.losses[:RECORDED_STEPS]
        if rec["grads"] is not None and set(rec["grads"]) != set(names):
            rec["grads"] = {}  # a leaf Adam never saw: compared as missing
        warm = self.traffic["warmup_steps"] - self.feed.handed
        if warm > 0:
            self.feed.reset(limit=warm, deadline=None)
            self._epochs()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        self._sync()
        cuda = self.device.type == "cuda"
        if cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t_open = time.perf_counter()
        self.feed.reset(limit=None, deadline=t_open + seconds, recording=True)
        self._epochs()
        self._sync()
        t_close = time.perf_counter()
        step_ms = self.feed.step_ms()
        points = sum(int(torch.as_tensor(n).sum()) for n in self.feed.lengths)
        w = {"seconds": t_close - t_open, "steps": len(step_ms), "step_ms": step_ms,
             "points": points, "host_s": list(self.feed.host_s),
             "wait_s": list(self.feed.wait_s)}
        w["peak_bytes"] = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        return w

    def profiled(self) -> dict:
        """Two profiled stretches of `trace_steps` steps each, a few steps
        into a fresh epoch: the first traces the device alone (its cost
        to the host is small, so its busy share is the window's), the
        second the host too, with the port's ops in named ranges, for the
        ops' device time and what the host did in the device's gaps."""
        from pointseg_torch.ops import _kernels
        from torch.profiler import ProfilerActivity, profile, record_function

        steps = self.traffic["trace_steps"]
        cuda = self.device.type == "cuda"
        device_only = profile(activities=[ProfilerActivity.CUDA] if cuda
                              else [ProfilerActivity.CPU])
        with_host = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        box = {}

        def open_(prof):
            self._sync()
            prof.start()
            if cuda:
                torch.cuda._sleep(1000)  # the profiler drops a window's first device event

        def on_ask(step):
            if step == TRACE_SKIP:
                box["launches"] = sum(_kernels.LAUNCHES.values())
                open_(device_only)
            elif step == TRACE_SKIP + steps:
                self._sync()
                device_only.stop()
                box["launches"] = sum(_kernels.LAUNCHES.values()) - box["launches"]
                box["device"] = self._read_trace(device_only, None)  # before the next profiler starts
                open_(with_host)
                box["ops"] = OpRanges().__enter__()
                box["range"] = record_function(WINDOW_RANGE)
                box["range"].__enter__()
                self.feed.ranges = True
            elif step == TRACE_SKIP + 2 * steps:
                self._sync()
                box["range"].__exit__(None, None, None)
                box["ops"].__exit__(None, None, None)
                self.feed.ranges = False
                with_host.stop()

        self.feed.reset(limit=TRACE_SKIP + 2 * steps, deadline=None, on_ask=on_ask)
        self._epochs()
        device_win = box["device"]
        host_win = self._read_trace(with_host, WINDOW_RANGE)
        ops = box["ops"]
        return {"window": device_win, "host_window": host_win, "steps": steps,
                "launches": box["launches"], "op_calls": len(ops.calls),
                "ops": ops.readings(host_win)}

    @staticmethod
    def _read_trace(prof, name):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return tracefile.Window(path, name)
        finally:
            os.unlink(path)

    # -- the comparison --------------------------------------------------------------------
    def free_program(self) -> None:
        del self.state, self.feed
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, index: check.BlockIndex) -> dict[str, float]:
        rec = self.rec
        rows_off = sum(index.rows_off(p.numpy(), y.numpy(), n.numpy())
                       for p, y, n in rec["batches"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = reference_steps(self.arch, self.weights, rec["batches"],
                              fps_seed=self.seeds["fps"], dropout_seed=self.seeds["dropout"],
                              lr=self.config["learning_rate"], device=self.device,
                              model_kwargs=self.config.get("arch_forward_kwargs", {}))
        prog = {"losses": rec["losses"], "logits": rec["logits"],
                "grads": rec["grads"] or {}, "params": rec["params"] or {}}
        self.compared = (prog, ref)  # kept for a look at single leaves
        return check.numbers(prog, ref, self.weights, rows_off)


def end_to_end(w: dict, setup_s: float) -> dict[str, float]:
    """The cell's end-to-end readings from its window."""
    return {
        "train_points_per_s": w["points"] / w["seconds"],
        "step_ms_p95": (statistics.quantiles(w["step_ms"], n=20, method="inclusive")[-1]
                        if len(w["step_ms"]) >= 2 else math.nan),
        "peak_mib": w["peak_bytes"] / 2**20,
        "setup_s": setup_s,
    }
