#!/usr/bin/env python3
"""Smoke run of pointseg_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device must be present; prints the torch and CUDA
   versions and `nvidia-smi --query-gpu=name,power.limit`.
2. Build: compiles the CUDA kernels from `pointseg_torch/csrc/`.
3. Kernels: FPS, ball query and 3-NN against their plain PyTorch
   versions on the card, at the PointNet++ training shapes (B=8,
   N=4096 -> 1024 -> 256 -> 64 -> 16), a ragged shape with repeated
   points and a large evaluation shape. Indices and `in_ball` must be
   equal and 3-NN distances equal to rtol 1e-5 / atol 1e-6; an index may
   differ only where the float64 squared distances of the two picks
   differ by less than 1e-6 m^2 (counted and printed). Each version is
   timed with CUDA events, in the order plain, kernel, kernel, plain.
4. Trainer: `train PointNet++` through `pointseg_torch.cli` at the
   reference configuration (batch 8 x 4096 points x 9 features, 14
   classes, Adam 1e-3) on a synthetic S3DIS-shaped block dataset: one
   epoch (12 steps) and its evaluation pass, with the launch counters
   set to 0 just before and read just after. Then the steady-state step
   time (CUDA events), points/s, peak memory and a profile of the step.
5. Output: the trained model's eval logits on the card must match the
   same model's on the CPU (plain versions) to rtol/atol 1e-4.

The next-to-last line of output is the kernels' JSON record; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SLICE_FPS = [(8, 4096, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16)]
RADII = {4096: 0.1, 1024: 0.2, 256: 0.4, 64: 0.8}
TIE_M2 = 1e-6  # an index may differ where the two picks' d^2 differ by less


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel_fn, plain_fn, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    kernel_fn(), plain_fn()  # warm-up
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def block_cloud(rng, B: int, N: int, repeat_from: int | None = None) -> np.ndarray:
    """B clouds in a 1 m x 1 m x 3 m column (an S3DIS block); with
    `repeat_from`, the points from there on repeat the first ones, as
    eval padding does."""
    pts = (rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])).astype(np.float32)
    if repeat_from is not None:
        pts[:, repeat_from:] = pts[:, : N - repeat_from]
    return pts


def sqd64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.double() - b.double()) ** 2).sum(-1)


def rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, 3) rows at idx (B, ...) -> (B, ..., 3)."""
    B = t.shape[0]
    flat = idx.reshape(B, -1).long()
    return torch.gather(t, 1, flat[..., None].expand(-1, -1, 3)).reshape(*idx.shape, 3)


def check_fps(pts, got, want) -> tuple[int, float]:
    """(tie flips, max |d^2| gap) between two FPS sequences. After a flip
    the sequences legitimately diverge, so a cloud is compared up to its
    first differing step."""
    flips, gap = 0, 0.0
    for b in torch.nonzero((got != want).any(dim=1)).flatten().tolist():
        i = int(torch.nonzero(got[b] != want[b])[0])
        prefix = pts[b, want[b, :i].long()]  # (i, 3) common picks
        d_got = sqd64(pts[b, got[b, i].long()][None], prefix).min()
        d_want = sqd64(pts[b, want[b, i].long()][None], prefix).min()
        gap = max(gap, float((d_got - d_want).abs()))
        if gap >= TIE_M2:
            raise AssertionError(f"FPS cloud {b} step {i}: picks {int(got[b, i])} vs "
                                 f"{int(want[b, i])} are not a tie (gap {gap:.3g} m^2)")
        flips += 1
    return flips, gap


def check_picks(query, pts, got, want) -> tuple[int, float]:
    """(tie flips, max |d^2| gap) for ball-query / 3-NN index outputs."""
    d_got = sqd64(query[:, :, None, :], rows(pts, got))
    d_want = sqd64(query[:, :, None, :], rows(pts, want))
    gap = float((d_got - d_want).abs().max()) if got.numel() else 0.0
    flips = int((got != want).sum())
    if flips and float((d_got - d_want)[got != want].abs().max()) >= TIE_M2:
        raise AssertionError(f"{flips} differing picks, not all ties (gap {gap:.3g} m^2)")
    return flips, gap


def kernels_phase(device) -> dict:
    from pointseg_torch.ops.ballquery import ball_query_plain, ball_query_raw
    from pointseg_torch.ops.fps import farthest_point_sampling, farthest_point_sampling_plain
    from pointseg_torch.ops.interpolate import three_nn, three_nn_plain

    rng = np.random.default_rng(0)
    record = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "flips": 0}
              for name in ("fps", "ball_query", "three_nn")}

    def note(name, shape, ms, plain_ms, flips, err, on_path):
        r = record[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["flips"] += flips
        if on_path:  # the per-forward total sums the four training stages
            r["ms"] += ms
            r["plain_ms"] += plain_ms
        print(f"{name:10s} {str(shape):24s} kernel {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
              f"x{plain_ms / ms:7.2f}  tie flips {flips}  max |d2 gap| {err:.3g}", flush=True)

    # the training path's clouds: each stage's input is the last one's FPS picks
    levels = [torch.from_numpy(block_cloud(rng, 8, 4096)).to(device)]
    cases = [(B, N, C, None, True) for B, N, C in SLICE_FPS]
    cases += [(8, 3000, 1000, 2300, False), (2, 16384, 1024, 12000, False)]
    for B, N, C, repeat_from, on_path in cases:
        if on_path:
            pts = levels[-1]
        else:
            pts = torch.from_numpy(block_cloud(rng, B, N, repeat_from)).to(device)
        zero = torch.zeros(B, dtype=torch.int32, device=device)
        got = farthest_point_sampling(pts, C)
        want = farthest_point_sampling_plain(pts, C, zero)
        flips, err = check_fps(pts, got, want)
        reps = 20 if N <= 4096 else 5
        ms, plain_ms = timed_pair(lambda: farthest_point_sampling(pts, C),
                                  lambda: farthest_point_sampling_plain(pts, C, zero), reps)
        note("fps", (B, N, C), ms, plain_ms, flips, err, on_path)

        cents = rows(pts, want)
        r = RADII.get(N, 0.1)
        g_idx, g_in = ball_query_raw(cents, pts, r, 32)
        w_idx, w_in = ball_query_plain(cents, pts, r, 32)
        if not torch.equal(g_in, w_in):
            raise AssertionError(f"ball query {(B, C, N)}: in_ball differs")
        flips, err = check_picks(cents, pts, g_idx, w_idx)
        ms, plain_ms = timed_pair(lambda: ball_query_raw(cents, pts, r, 32),
                                  lambda: ball_query_plain(cents, pts, r, 32), 20)
        note("ball_query", (B, C, N, r), ms, plain_ms, flips, err, on_path)
        print(f"{'':10s} share of in-ball slots {float(g_in.float().mean()):.3f}")

        if N <= 4096:  # 3-NN upsamples each stage's centroids back onto its input
            g_d, g_i = three_nn(pts, cents)
            w_d, w_i = three_nn_plain(pts, cents)
            torch.testing.assert_close(g_d, w_d, rtol=1e-5, atol=1e-6)
            flips, _ = check_picks(pts, cents, g_i, w_i)
            err = float((g_d.double() - w_d.double()).abs().max())
            ms, plain_ms = timed_pair(lambda: three_nn(pts, cents),
                                      lambda: three_nn_plain(pts, cents), 20)
            note("three_nn", (B, N, C), ms, plain_ms, flips, err, on_path)
        if on_path:
            levels.append(cents.contiguous())
    return record


def trainer_phase(device, workdir: str):
    from pointseg.data.datasets import create_block_dataloaders
    from pointseg_torch import cli
    from pointseg_torch.ops import _kernels
    from pointseg_torch.train.loop import to_device
    from pointseg_torch.train.state import train_step

    argv = ["train", "PointNet++", "--synthetic", "--data-dir", f"{workdir}/data",
            "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "4096",
            "--device", "cuda", "--log-dir", f"{workdir}/logs"]
    args = cli.build_parser().parse_args(argv)
    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0
    t0 = time.time()
    state, records = cli.train_from_args(args)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f"trainer: {time.time() - t0:.1f} s for one epoch and its evaluation; "
          f"launches {launches}")
    if not all(math.isfinite(v) for v in records["train_loss"] + records["val_loss"]):
        raise AssertionError(f"non-finite loss: {records}")
    off_card = [k for k, p in state.model.named_parameters() if p.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"parameters off the card: {off_card}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the trainer: {missing}")

    # steady-state step time on one real batch
    train_loader, _ = create_block_dataloaders(f"{workdir}/data", {6}, 8, 2, 4096, seed=1)
    batch = to_device(next(iter(train_loader)), device)
    for _ in range(3):
        train_step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 20
    t0 = time.time()
    step_ms = cuda_ms(lambda: train_step(state, *batch), steps)
    host_ms = (time.time() - t0) * 1e3 / steps
    points = batch[0].shape[0] * batch[0].shape[1]
    peak = torch.cuda.max_memory_allocated()
    print(f"train step (B=8, N=4096): {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
          f"(host clock), {points / (step_ms / 1e3):.0f} points/s, "
          f"peak allocated {peak / 2**20:.1f} MiB")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            train_step(state, *batch)
        torch.cuda.synchronize()
    print("profile of 3 train steps, by device time:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                    max_name_column_width=60))
    return state, launches, {"step_ms": step_ms, "host_step_ms": host_ms,
                             "points_per_s": points / (step_ms / 1e3), "peak_bytes": peak,
                             "batch": batch}


def output_phase(state, batch) -> None:
    model = state.model.eval()
    x = batch[0][:2]
    with torch.no_grad():
        got = model(x).cpu()
        cpu_model = type(model)().eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        want = cpu_model(x.cpu())
    if got.shape != (2, 4096, 14) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits: shape {tuple(got.shape)}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"eval logits card vs CPU: max |diff| {float((got - want).abs().max()):.3g}")


def main() -> int:
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 2
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build")
    from pointseg_torch.ops import _kernels

    t0 = time.time()
    lib = _kernels.build()
    _kernels.library()
    print(f"built {lib} in {time.time() - t0:.1f} s")

    phase("3. kernels against their plain versions")
    record = kernels_phase(device)

    phase("4. trainer")
    workdir = tempfile.mkdtemp(prefix="pointseg_smoke_")
    try:
        state, launches, perf = trainer_phase(device, workdir)
        phase("5. output against the CPU")
        output_phase(state, perf.pop("batch"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    sources = {"fps": ("pointseg_torch/csrc/fps.cu", "pointseg/ops/pallas/fps.py:67"),
               "ball_query": ("pointseg_torch/csrc/ballquery.cu",
                              "pointseg/ops/pallas/ballquery.py:93"),
               "three_nn": ("pointseg_torch/csrc/threenn.cu",
                            "pointseg/ops/pallas/threenn.py:47")}
    kernels = [{"name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
               for name, r in record.items()]
    print(f"\nsummary: {smi}; step {perf['step_ms']:.3f} ms, "
          f"{perf['points_per_s']:.0f} points/s, peak {perf['peak_bytes'] / 2**20:.1f} MiB; "
          f"kernel ms are per forward pass (the four training stages summed); "
          f"tie flips {({k: r['flips'] for k, r in record.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
