#!/usr/bin/env python3
"""Smoke run of pointseg_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device must be present; prints the torch and CUDA
   versions and `nvidia-smi --query-gpu=name,power.limit`.
2. Build: compiles the CUDA kernels from `pointseg_torch/csrc/` (one
   nvcc per source, all at once).
3. Kernels, each against its plain PyTorch version on the card:
   - FPS, ball query and 3-NN at the PointNet++ training shapes (B=8,
     N=4096 -> 1024 -> 256 -> 64 -> 16), a ragged shape with repeated
     points and a large evaluation shape. Indices and `in_ball` must be
     equal and 3-NN distances equal to rtol 1e-5 / atol 1e-6. FPS also
     gives its device time a launch (profiler) and the kernel instance
     that ran at each shape; at the four SA stages the register path at
     each block size (128, 256, 512, 1024 threads), equal to the plain
     version, and the row's latency floor (every step of the four stages
     at the per-step time of the same kernel with one point a thread);
     at (2, 16384, 1024) the register path (16 points a thread) against
     the default kernel.
   - the two-level ball query against the plain version and against the
     flat kernel, index for index and `in_ball` for `in_ball`, at every
     ball-query shape of PointNeXt (four SA stages and five InvResMLP
     blocks, where the centroids are the cloud itself) and of PointNet++
     MSG (two radii per stage) at B=8, N=4096, at the ragged shape with
     repeated points (also with a mask and at stack depth 1, where every
     pick refills a lane) and at two evaluation shapes (N = 16384 and
     65536). Its bound is the flat kernel's at the same shape; the flat
     kernel is timed beside it in turns (flat, two-level, two-level, flat).
     Both kernels' device time per launch is also read from the profiler:
     at the small stages a loop of launches under CUDA events measures
     the host's call rate, not the kernel.
   - kNN, flat and two-level, at the DGCNN EdgeConv shapes (8, 4096, 3)
     and (8, 4096, 64) (LeakyReLU'd normal features), a cloud with
     repeated points and (2, 16384, 64); the two kernels must also equal
     each other. On the cloud with repeated points also with a mask,
     without the point itself, and both (ragged evaluation), where the
     kernels must equal the plain version slot for slot. Beside the
     CUDA-event time of each shape: both kernels' device time per launch
     from the profiler, and the flat kernel's floor (its arithmetic is
     exact, so a product costs two float32 instructions, not one fused
     one: twice the operation bound). Then 19 small shapes that the flat
     kernel's tiles can get wrong (N = 37, 4099, 1100; F = 1 to 132 on the
     16-byte and the 4-byte path; k = 1 and 32; one cloud; a view that is
     not 16-byte aligned), each with and without the mask and the point
     itself, flat and two-level equal to plain slot for slot.
   - the row gather at the EdgeConv shapes (8, 4096, 64 and 128) x
     81,920 rows and at the tables of a PointNet++ step (centroid
     coordinates, the FP interpolation sources, and the concatenated SA
     tables of odd width h + 3 that the JAX package gathers from):
     forward bit-equal to `torch.gather`; backward (`index_add_`) equal
     to autograd of the plain version to rtol/atol 1e-4 (both add with
     atomics). Its `max_abs_err` is the larger of the forward's (0 when
     bit-equal) and the backward's. Then SetAbstraction grouping at every
     SA table of PointNet++, MSG and PointNeXt in three forms (the
     concatenated table in one launch, two launches, the two-table
     kernel), rows bit-equal, forward and forward + backward, under CUDA
     events and on the device (profiler), with the two-table call beside
     two `torch.gather` calls.
   - the flat row gather (the device store's sampler) bit-equal to
     `index_select` for rows of 1, 16 and 36 bytes (uint8, int32 x 4,
     float32 x 9) and an odd width (float32 x 35), at 8 x 4096 rows and
     at a count that divides nothing, on a table of the synthetic
     dataset's size (240,000 rows) and at the size of all of S3DIS,
     273,000,000 rows made on the card from the seed (packed 4.4 GB,
     then nine floats 9.8 GB, then labels 0.27 GB, each freed before the
     next), with indices that include row 0 and the last row. Every timed
     launch gets fresh random rows, as every training step does. Its
     bound counts the 32-byte sectors these rows touch, not their bytes.
     Per case a line says whether the kernel's call or `index_select`'s
     is faster under CUDA events, timed in turns (the check never fails
     on a time).
   - the host time of one flat-gather call and of one batched-gather
     call, each split into its parts and into the steps it no longer
     takes, beside `index_select` or `torch.gather` and an empty Python
     function (microseconds a call over 10,000 calls, host clock, no
     synchronisation inside the loop).
   - the flat gather and the flat kNN on a stream that is not the default
     one (the input written behind a long wait on that stream) and inside
     a captured CUDA graph replayed twice on new input, equal to the
     plain versions: the launch path follows PyTorch's current stream
     and makes no call that capture forbids.
   An index may differ from the plain version's only where the float64
   squared distances of the two picks differ by less than 1e-6 (counted
   and printed as tie flips). Each version is timed with CUDA events, in
   the order plain, kernel, kernel, plain; then one PyTorch library
   formulation of the same function is timed as a yardstick (bmm + topk
   for 3-NN and kNN, `torch.gather` and `index_select` for the gathers;
   FPS and the ball queries have none). The port never calls these. Each kernel's bound is the
   least time the card could take: the larger of its bytes (inputs read
   once, outputs written once) over 3.35 TB/s and its float32
   operations over 67 TFLOP/s.
4. Trainers, through `pointseg_torch.cli` at the reference configuration
   (batch 8 x 4096 points x 9 features, 14 classes, Adam 1e-3) on a
   synthetic S3DIS-shaped block dataset, one epoch (12 steps) and its
   evaluation pass each, with the launch counters set to 0 just before
   and read just after: `train PointNet++` must launch fps, ball_query
   and three_nn; `train DeepGraphCnn` must launch knn (4 per step) and
   gather_rows; `train PointNeXt` must launch fps 4, ball_query 9 and
   three_nn 4 times per forward pass and `train PointNet++MSG` 4, 8 and
   4 times. For both of these, three steps with
   `ball_select="two_level"` and three with "flat" from the same weights,
   batch and seeds: ball_query_2l must launch (9 or 8 a step) and
   ball_query never, first losses equal to 1e-6 relative. Three steps of
   PointNeXt-L give its step time and peak memory. `train PointNeXt`
   and `train DeepGraphCnn` again with POINTSEG_SELECT2L=1 (the JAX
   package's switch, read by the port's CLI): ball_query_2l (9 a step)
   and knn_2l (4 a step) must launch and the flat kernels never; the
   kernel record's launches of the two-level kernels are these runs'.
   For DeepGraphCnn three steps of DeepGraphCnn with
   `knn_select="two_level"` and three with "flat", from the same weights,
   batch and dropout seed: knn_2l must launch, the first losses must
   agree to 1e-6 relative (same forward) and the later ones to 1e-3 (the
   gather's backward adds with atomics). For each model the steady-state
   step time (CUDA events), points/s, peak memory, a profile and the
   device time per step of each of the port's own kernels; for
   DeepGraphCnn also the step time and peak memory with
   `EdgeConv.remat`, which gathers again in the backward pass.
   Then the device-resident store, through the same CLI:
   `train PointNet++ --device-data --device-store flat` (mode must be
   "device", two flat-gather launches a step), twice
   `--device-store compact --pack-cache DIR` (mode "compact", one launch
   a step, the second start a cache hit that loads no raw block),
   `--device-store flat --scan-steps 4` (the same epoch loss as K = 1 to
   1e-1 relative, as the compact store's: a coarse check, because the
   runs see the same batches but the atomic adds of `index_add_` make two
   runs of one epoch drift apart, at Adam's 1e-3 by 2e-2 to 6e-2 in the
   twelfth loss on an H100), `--accum-steps 2` on the host loader (6
   updates from 12 batches) and `train DeepGraphCnn --device-data` (kNN,
   both gathers). The first batch of the two stores from one seed must be
   bit-identical, and `scan_epoch(4)` must see the same batches as
   iterating the loader. Its losses are compared at a learning rate of
   1e-5, where that drift stays near 1e-4 over the epoch: the first loss
   to 1e-6, each later one to 1e-3 or, where that is more, to four times
   the largest relative difference that two iterated runs of the same
   epoch have shown up to that step (measured in the run and printed).
   Printed, with no claim: the store's upload time and bytes,
   ms per sampled batch of both stores, and PointNet++'s step time and
   device-busy share fed by the host loader and by the device store, in
   turns within this one run.
5. Output: each trained model's eval logits on the card against the same
   weights on the CPU (plain versions), rtol/atol 1e-4 (PointNet++,
   PointNeXt, PointNet++MSG). For DGCNN that
   holds under `static_graph=True` and, with the dynamic graph, when the
   CPU model is given the four graphs the card built. Left to build its
   own, the CPU can flip a neighbour in conv2-4, which select on
   activations that its matmuls round another way, and a flip moves a
   point's logits far beyond any tolerance: the differing graph slots
   per layer and the points that moved beyond 1e-4 are counted and
   printed, not bounded.

The next-to-last line of output is the kernels' JSON record; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SLICE_FPS = [(8, 4096, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16)]
FPS_THREADS = (32, 64, 128, 256, 512, 1024)  # the register path's block sizes
RADII = {4096: 0.1, 1024: 0.2, 256: 0.4, 64: 0.8}
TIE_M2 = 1e-6  # an index may differ where the two picks' d^2 differ by less
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
K_NEIGHBOURS = 20  # DGCNN's k

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fps": ("pointseg_torch/csrc/fps.cu", "pointseg/ops/pallas/fps.py:67"),
    "ball_query": ("pointseg_torch/csrc/ballquery.cu", "pointseg/ops/pallas/ballquery.py:93"),
    "ball_query_2l": ("pointseg_torch/csrc/ballquery.cu",
                      "pointseg/ops/pallas/ballquery.py:146"),
    "three_nn": ("pointseg_torch/csrc/threenn.cu", "pointseg/ops/pallas/threenn.py:47"),
    "knn": ("pointseg_torch/csrc/knn.cu", "pointseg/ops/pallas/knn.py:142"),
    "knn_2l": ("pointseg_torch/csrc/knn.cu", "pointseg/ops/pallas/knn.py:101"),
    "gather_rows": ("pointseg_torch/csrc/gather.cu", "pointseg/ops/pallas/gather.py:111"),
    "gather_rows_flat": ("pointseg_torch/csrc/gather.cu", "pointseg/ops/pallas/gather.py:174"),
}
S3DIS_ROWS = 273_000_000  # points in all of S3DIS
SYNTHETIC_ROWS = 240_000  # points in the --synthetic dataset
SAMPLED_ROWS = 8 * 4096  # rows one training batch gathers


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


def timed_pair(kernel_fn, plain_fn, reps: int, plain_reps: int | None = None):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    plain_reps = plain_reps or reps
    kernel_fn(), plain_fn()  # warm-up
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, plain_reps)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timed(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    return cuda_ms(fn, reps)


def device_time_us(event) -> float:
    """Self device time of one profiler row (the attribute's name moved
    between PyTorch versions)."""
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


def profiled(fn, reps: int) -> list:
    """The profiler's rows (`key_averages()`) for `reps` calls of `fn`.
    The window opens with a short spin kernel, left out of the rows: the
    profiler on the card drops the first device event of a window, which
    would otherwise be the first call's first kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if "spin_kernel" not in e.key]


def kernel_device_us(fn, kernel: str, reps: int = 10) -> float:
    """Mean device microseconds per call of `fn` inside kernels whose name
    contains `kernel`, from the profiler: unlike CUDA events around a loop
    of launches it holds none of the host's gaps between them. A trace
    that comes back without the kernel, or with fewer launches of it than
    calls, is taken once more; NaN (printed as such, and so marking every
    sum it enters) if that one is short too."""
    fn()  # warm-up
    for _ in range(2):
        rows = [e for e in profiled(fn, reps) if kernel in e.key]
        # a trace can come back a launch short: then it is taken again
        if rows and sum(e.count for e in rows) % reps == 0:
            return sum(device_time_us(e) for e in rows) / reps
    return float("nan")


class Record:
    """Per kernel: times summed over the shapes of one forward pass of
    its training path, the bound for the same work, the worst error."""

    def __init__(self):
        self.rows = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "ops_ms": 0.0,
                            "bytes_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "flips": 0}
                     for name in KERNELS}

    def note(self, name, shape, ms, plain_ms, library_ms, flops, nbytes, flips, err,
             per_forward: int):
        """`per_forward`: how often one forward pass runs this shape (0:
        the shape is checked and printed only)."""
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        r = self.rows[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["flips"] += flips
        r["ms"] += per_forward * ms
        r["plain_ms"] += per_forward * plain_ms
        r["ops_ms"] += per_forward * ops_ms
        r["bytes_ms"] += per_forward * bytes_ms
        r["bound_ms"] += per_forward * max(ops_ms, bytes_ms)
        if library_ms is not None and per_forward:
            r["library_ms"] = (r["library_ms"] or 0.0) + per_forward * library_ms
        lib = "     none" if library_ms is None else f"{library_ms:9.4f}"
        print(f"{name:11s} {str(shape):34s} kernel {ms:9.4f} ms  plain {plain_ms:10.4f} ms  "
              f"library {lib} ms  bound {max(ops_ms, bytes_ms):8.5f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'})  x{per_forward} per forward  "
              f"tie flips {flips}  max |err| {err:.3g}", flush=True)


def block_cloud(rng, B: int, N: int, repeat_from: int | None = None) -> np.ndarray:
    """B clouds in a 1 m x 1 m x 3 m column (an S3DIS block); with
    `repeat_from`, the points from there on repeat the first ones, as
    eval padding does."""
    pts = (rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])).astype(np.float32)
    if repeat_from is not None:
        pts[:, repeat_from:] = pts[:, : N - repeat_from]
    return pts


def activations(rng, B: int, N: int, F: int, repeat_from: int | None = None) -> np.ndarray:
    """What conv2-4 select on: LeakyReLU(0.2) of normal draws."""
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    x = np.where(x > 0, x, np.float32(0.2) * x)
    if repeat_from is not None:
        x[:, repeat_from:] = x[:, : N - repeat_from]
    return x


def sqd64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.double() - b.double()) ** 2).sum(-1)


def rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, F) rows at idx (B, ...) -> (B, ..., F), by `torch.gather`."""
    B, _, F = t.shape
    flat = idx.reshape(B, -1).long()
    return torch.gather(t, 1, flat[..., None].expand(-1, -1, F)).reshape(*idx.shape, F)


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
    """(tie flips, max |d^2| gap) for ball-query / 3-NN / kNN index
    outputs; differing picks must be float64-verified ties."""
    flips = int((got != want).sum())
    if not flips:
        return 0, 0.0
    gap = 0.0
    for b in range(got.shape[0]):  # one cloud at a time: the gathered rows are large
        differs = got[b] != want[b]
        if not bool(differs.any()):
            continue
        q = query[b][:, None, :]
        d_got = sqd64(q, rows(pts[b:b + 1], got[b:b + 1])[0])
        d_want = sqd64(q, rows(pts[b:b + 1], want[b:b + 1])[0])
        gap = max(gap, float((d_got - d_want)[differs].abs().max()))
    if gap >= TIE_M2:
        raise AssertionError(f"{flips} differing picks, not all ties (gap {gap:.3g})")
    return flips, gap


def three_nn_library(tgt, src):
    t2, s2 = (tgt * tgt).sum(-1), (src * src).sum(-1)
    d2 = torch.baddbmm(s2[:, None, :], tgt, src.transpose(1, 2), alpha=-2.0) + t2[:, :, None]
    return torch.topk(d2, 3, dim=-1, largest=False)


def knn_library(x, k):
    x2 = (x * x).sum(-1)
    score = torch.baddbmm(x2[:, None, :], x, x.transpose(1, 2), beta=-1.0, alpha=2.0)
    return torch.topk(score - x2[:, :, None], k, dim=-1)[1]


def fps_device(fn, reps: int = 10) -> tuple[float, str]:
    """Device microseconds a call of `fn` in the FPS kernels and the
    instance that ran, from the profiler: `fps_register_kernel<threads,
    P>` or `fps_kernel` (the shared- and global-memory path)."""
    fn()  # warm-up
    for _ in range(2):
        rows = [e for e in profiled(fn, reps) if re.search(r"fps_(register_)?kernel", e.key)]
        names = sorted({m.group(0) for e in rows for m in [
            re.search(r"fps_register_kernel<\d+, \d+>|fps_kernel", e.key)] if m})
        if rows and sum(e.count for e in rows) % reps == 0:  # else taken again, once
            return sum(device_time_us(e) for e in rows) / reps, "/".join(names)
    return float("nan"), "/".join(names)


def fps_block_sizes(device, levels: list) -> None:
    """The register path at each block size (32 to 1024 threads) and the
    shared-memory kernel (`fps_kernel`, the one all clouds took before
    the register path) at the four SA stages, each equal to the plain
    version, device us a launch; the instance the default choice runs;
    the latency floor of the row: every step of the four stages at the
    per-step time of the same kernel with one point a thread (N =
    threads); and the register path against fps_kernel at N = 16384."""
    from pointseg_torch.ops.fps import (_fps_cuda, farthest_point_sampling,
                                        farthest_point_sampling_plain)

    per_step_us = {}
    for threads in FPS_THREADS:  # one point a thread: the cost of a step's argmax
        pts = levels[0][:, :threads].contiguous()
        zero = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
        us, _ = fps_device(lambda: _fps_cuda(pts, threads, zero, None, threads))
        per_step_us[threads] = us / threads
    print(f"{'':11s} fps per-step device time at one point a thread (N = threads = C, B = 8): "
          + ", ".join(f"{t} threads {us * 1e3:.1f} ns" for t, us in per_step_us.items()))
    total_us, floor_us = 0.0, 0.0
    for (B, N, C), pts in zip(SLICE_FPS, levels):
        zero = torch.zeros(B, dtype=torch.int32, device=device)
        want = farthest_point_sampling_plain(pts, C, zero)
        us, chosen = fps_device(lambda: farthest_point_sampling(pts, C))
        sweep = []
        for threads in (*FPS_THREADS, -1):
            try:
                got = _fps_cuda(pts, C, zero, None, threads)
            except torch.cuda.CudaError:  # the cloud is over this block size's register budget
                sweep.append(f"{threads}: does not fit")
                continue
            if not torch.equal(got, want):
                raise AssertionError(f"fps {(B, N, C)} at {threads} threads differs from plain")
            t_us, name = fps_device(lambda: _fps_cuda(pts, C, zero, None, threads))
            sweep.append(f"{threads if threads > 0 else 'shared-memory kernel'}: {t_us:.1f} us "
                         f"({name})")
        threads = int(re.search(r"<(\d+),", chosen).group(1)) if "<" in chosen else 0
        floor = C * per_step_us[threads] if threads else float("nan")
        total_us, floor_us = total_us + us, floor_us + floor
        print(f"{'':11s} fps {(B, N, C)}: default {chosen} {us:.1f} us a launch on the device "
              f"({us / C * 1e3:.1f} ns a step; latency floor {floor:.1f} us); forced block "
              f"sizes: " + "; ".join(sweep))
    print(f"{'':11s} fps, the four stages of a forward pass: {total_us / 1e3:.4f} ms on the "
          f"device, latency floor {floor_us / 1e3:.4f} ms ({total_us / floor_us:.2f}x)")
    pts = torch.from_numpy(block_cloud(np.random.default_rng(3), 2, 16384)).to(device)
    zero = torch.zeros(2, dtype=torch.int32, device=device)
    want = farthest_point_sampling_plain(pts, 1024, zero)
    if not torch.equal(_fps_cuda(pts, 1024, zero, None, 1024), want):
        raise AssertionError("fps (2, 16384, 1024) on the register path differs from plain")
    default_us, default_name = fps_device(lambda: farthest_point_sampling(pts, 1024), reps=5)
    reg_us, reg_name = fps_device(lambda: _fps_cuda(pts, 1024, zero, None, 1024), reps=5)
    print(f"{'':11s} fps (2, 16384, 1024): default {default_name} {default_us:.1f} us, "
          f"register path {reg_name} (16 points a thread, over its 64 registers) {reg_us:.1f} us")


def pointnetpp_kernels(device, record: Record) -> list:
    """FPS, ball query (flat) and 3-NN; returns the training path's five
    clouds (4096, 1024, 256, 64 and 16 points, each the last one's picks)."""
    from pointseg_torch.ops.ballquery import ball_query_plain, ball_query_raw
    from pointseg_torch.ops.fps import farthest_point_sampling, farthest_point_sampling_plain
    from pointseg_torch.ops.interpolate import three_nn, three_nn_plain

    rng = np.random.default_rng(0)
    # the training path's clouds: each stage's input is the last one's FPS picks
    levels = [torch.from_numpy(block_cloud(rng, 8, 4096)).to(device)]
    cases = [(B, N, C, None, 1) for B, N, C in SLICE_FPS]
    cases += [(8, 3000, 1000, 2300, 0), (2, 16384, 1024, 12000, 0)]
    for B, N, C, repeat_from, per_forward in cases:
        if per_forward:
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
        # C rounds of N distances (3 sub, 3 mul, 2 add) and a running min
        record.note("fps", (B, N, C), ms, plain_ms, None, 9.0 * B * C * N,
                    12 * B * N + 4 * B + 4 * B * C, flips, err, per_forward)
        us, name = fps_device(lambda: farthest_point_sampling(pts, C), reps=10 if N <= 4096 else 3)
        print(f"{'':11s} device time a launch (profiler): {us:.1f} us, {name}")

        cents = rows(pts, want)
        r = RADII.get(N, 0.1)
        g_idx, g_in = ball_query_raw(cents, pts, r, 32)
        w_idx, w_in = ball_query_plain(cents, pts, r, 32)
        if not torch.equal(g_in, w_in):
            raise AssertionError(f"ball query {(B, C, N)}: in_ball differs")
        flips, err = check_picks(cents, pts, g_idx, w_idx)
        ms, plain_ms = timed_pair(lambda: ball_query_raw(cents, pts, r, 32),
                                  lambda: ball_query_plain(cents, pts, r, 32), 20)
        # per pair: the Gram form (3 mul, 2 add, scale, sub, add, clamp) and the test
        record.note("ball_query", (B, C, N, r), ms, plain_ms, None, 10.0 * B * C * N,
                    12 * B * C + 12 * B * N + 5 * B * C * 32, flips, err, per_forward)
        print(f"{'':11s} share of in-ball slots {float(g_in.float().mean()):.3f}")

        if N <= 4096:  # 3-NN upsamples each stage's centroids back onto its input
            g_d, g_i = three_nn(pts, cents)
            w_d, w_i = three_nn_plain(pts, cents)
            torch.testing.assert_close(g_d, w_d, rtol=1e-5, atol=1e-6)
            flips, _ = check_picks(pts, cents, g_i, w_i)
            err = float((g_d.double() - w_d.double()).abs().max())
            ms, plain_ms = timed_pair(lambda: three_nn(pts, cents),
                                      lambda: three_nn_plain(pts, cents), 20)
            lib_ms = timed(lambda: three_nn_library(pts, cents), 20)
            record.note("three_nn", (B, N, C), ms, plain_ms, lib_ms, 10.0 * B * N * C,
                        12 * B * N + 12 * B * C + 24 * B * N, flips, err, per_forward)
        if per_forward:
            levels.append(cents.contiguous())
    fps_block_sizes(device, levels)
    return levels


# Ball queries of one forward pass at N = 4096, as (centroid level, cloud
# level, radius, K) over the clouds of 4096, 1024, 256, 64 and 16 points.
POINTNEXT_QUERIES = [(1, 0, 0.1, 32), (1, 1, 0.1, 32), (2, 1, 0.2, 32), (2, 2, 0.1, 32),
                     (2, 2, 0.2, 32), (3, 2, 0.4, 32), (3, 3, 0.4, 32), (4, 3, 0.8, 32),
                     (4, 4, 0.8, 16)]
MSG_QUERIES = [(1, 0, 0.05, 16), (1, 0, 0.1, 32), (2, 1, 0.1, 16), (2, 1, 0.2, 32),
               (3, 2, 0.2, 16), (3, 2, 0.4, 32), (4, 3, 0.4, 16), (4, 3, 0.8, 32)]


def ball_query_2l_kernels(device, record: Record, levels: list) -> None:
    """The two-level ball query against the plain version and the flat
    kernel. Its record sums PointNeXt's nine queries; the flat kernel's
    sum over the same nine and all four sums over MSG's eight are printed."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.ballquery import (_ball_query_cuda, _radius_sq, ball_query_plain,
                                              ball_query_raw)

    def check(cents, pts, r, K, what, depth=None, mask=None):
        before = dict(_kernels.LAUNCHES)
        if depth is None:
            g_idx, g_in = ball_query_raw(cents, pts, r, K, mask=mask, select="two_level")
        else:
            g_idx, g_in = _ball_query_cuda(cents, pts, _radius_sq(r), K, mask, "two_level", depth)
        if (_kernels.LAUNCHES["ball_query_2l"] != before["ball_query_2l"] + 1
                or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
            raise AssertionError(f"two-level ball query {what}: not exactly one launch of its "
                                 f"kernel ({before} -> {_kernels.LAUNCHES})")
        f_idx, f_in = ball_query_raw(cents, pts, r, K, mask=mask, select="flat")
        w_idx, w_in = ball_query_plain(cents, pts, r, K, mask=mask)
        torch.cuda.synchronize()
        if not (torch.equal(g_idx, f_idx) and torch.equal(g_in, f_in)):
            raise AssertionError(f"ball query {what}: two-level and flat differ at "
                                 f"{int((g_idx != f_idx).sum())} slots")
        if not torch.equal(g_in, w_in):
            raise AssertionError(f"two-level ball query {what}: in_ball differs from plain")
        return (*check_picks(cents, pts, g_idx, w_idx), float(g_in.float().mean()))

    rng = np.random.default_rng(5)
    sums = {which: {"two_level": 0.0, "flat": 0.0, "plain": 0.0, "bound": 0.0,
                    "two_level_us": 0.0, "flat_us": 0.0} for which in ("PointNeXt", "MSG")}
    extra = [  # (B, N, C, repeat_from, radius, K, kernel reps)
        (8, 3000, 1000, 2300, 0.1, 32, 20), (2, 16384, 1024, 12000, 0.1, 32, 10),
        (1, 65536, 1024, None, 0.1, 32, 5)]
    # (centroids, cloud, radius, K, times per PointNeXt forward, one of MSG's, kernel reps)
    cases = [(levels[q[0]], levels[q[1]], q[2], q[3], int(q in POINTNEXT_QUERIES),
              q in MSG_QUERIES, 20) for q in dict.fromkeys(POINTNEXT_QUERIES + MSG_QUERIES)]
    for B, N, C, repeat_from, r, K, reps in extra:
        pts = torch.from_numpy(block_cloud(rng, B, N, repeat_from)).to(device)
        cases.append((pts[:, :C].contiguous(), pts, r, K, 0, False, reps))
    for cents, pts, r, K, per_forward, in_msg, reps in cases:
        B, C, N = cents.shape[0], cents.shape[1], pts.shape[1]
        shape = (B, C, N, r, K)
        flips, err, share = check(cents, pts, r, K, shape)
        ms, flat_ms = timed_pair(lambda: ball_query_raw(cents, pts, r, K, select="two_level"),
                                 lambda: ball_query_raw(cents, pts, r, K, select="flat"), reps)
        plain_ms = timed(lambda: ball_query_plain(cents, pts, r, K), max(2, reps // 4))
        flops, nbytes = 10.0 * B * C * N, 12 * B * C + 12 * B * N + 5 * B * C * K
        record.note("ball_query_2l", shape, ms, plain_ms, None, flops, nbytes, flips, err,
                    per_forward)
        us = kernel_device_us(lambda: ball_query_raw(cents, pts, r, K, select="two_level"),
                              "ball_query_two_level_kernel")
        flat_us = kernel_device_us(lambda: ball_query_raw(cents, pts, r, K, select="flat"),
                                   "ball_query_kernel")
        print(f"{'':11s} flat kernel {flat_ms:9.4f} ms  device time a launch (profiler): "
              f"two-level {us:.1f} us, flat {flat_us:.1f} us  share of in-ball slots {share:.3f}")
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        for which, count in (("PointNeXt", per_forward), ("MSG", int(in_msg))):
            for key, value in (("two_level", ms), ("flat", flat_ms), ("plain", plain_ms),
                               ("bound", bound), ("two_level_us", us), ("flat_us", flat_us)):
                sums[which][key] += count * value
        if N == 3000:  # the ragged shape: a mask, and depth 1 (a refill after every pick)
            mask = torch.rand((B, N), device=device,
                              generator=torch.Generator(device).manual_seed(6)) < 0.7
            mask[0] = False  # a cloud whose balls are all empty
            for depth, m in ((None, mask), (1, None), (1, mask)):
                check(cents, pts, r, K, f"{shape} depth {depth} mask {m is not None}", depth, m)
            print(f"{'':11s} with a mask, at depth 1, and both: two-level equals flat and plain")
    for which, n in (("PointNeXt", "nine"), ("MSG", "eight")):
        t = sums[which]
        print(f"{'':11s} {which}'s {n} queries summed: two-level {t['two_level']:.4f} ms, flat "
              f"{t['flat']:.4f} ms, plain {t['plain']:.4f} ms, bound {t['bound']:.5f} ms; device "
              f"time (profiler): two-level {t['two_level_us']:.1f} us, flat {t['flat_us']:.1f} us")


def knn_kernels(device, record: Record) -> None:
    from pointseg_torch.ops.knn import knn_indices, knn_indices_plain

    rng = np.random.default_rng(1)
    k = K_NEIGHBOURS
    cases = [  # (x, what, how often one DGCNN forward runs it, kernel reps, plain reps)
        (block_cloud(rng, 8, 4096), "xyz", 1, 10, 3),
        (activations(rng, 8, 4096, 64), "activations", 3, 5, 2),
        (activations(rng, 4, 3000, 64, repeat_from=2000), "repeated points", 0, 5, 2),
        (activations(rng, 2, 16384, 64), "eval bucket", 0, 5, 1),
    ]
    for x_np, what, per_forward, reps, plain_reps in cases:
        x = torch.from_numpy(x_np).to(device)
        B, N, F = x.shape
        want = knn_indices_plain(x, k)
        flat = knn_indices(x, k, select="flat")
        two = knn_indices(x, k, select="two_level")
        torch.cuda.synchronize()
        if not torch.equal(flat, two):
            raise AssertionError(f"kNN {tuple(x.shape)} {what}: flat and two-level differ at "
                                 f"{int((flat != two).sum())} slots")
        flips, err = check_picks(x, x, flat, want)
        if what == "repeated points":
            check_knn_options(x, k)
        lib_ms = timed(lambda: knn_library(x, k), reps)
        flops, nbytes = 2.0 * B * N * N * F, 4 * B * N * F + 4 * B * N * k
        times = {}
        for name, select in (("knn", "flat"), ("knn_2l", "two_level")):
            ms, plain_ms = timed_pair(lambda: knn_indices(x, k, select=select),
                                      lambda: knn_indices_plain(x, k), reps, plain_reps)
            record.note(name, (B, N, F, what), ms, plain_ms, lib_ms, flops, nbytes,
                        flips, err, per_forward)
            times[name] = ms
        # The kernels round every product and add it by itself: two float32
        # instructions where the bound above counts one fused multiply-add,
        # so an exact kernel's floor is twice the operation bound.
        floor_ms = 2 * flops / PEAK_F32_FLOPS * 1e3
        us = kernel_device_us(lambda: knn_indices(x, k), "knn_flat_kernel", reps=5)
        us_2l = kernel_device_us(lambda: knn_indices(x, k, select="two_level"),
                                 "knn_two_level_kernel", reps=5)
        norms_us = kernel_device_us(lambda: knn_indices(x, k), "row_sqnorm_kernel", reps=5)
        # with k = 1 a row's list takes some ln(N) insertions instead of
        # k ln(N / k) + k: nearly the score pass and the tile votes alone
        k1_us = kernel_device_us(lambda: knn_indices(x, 1), "knn_flat_kernel", reps=5)
        print(f"{'':11s} device time a launch (profiler): knn_flat_kernel {us:.1f} us, "
              f"knn_two_level_kernel {us_2l:.1f} us, the norms kernel {norms_us:.1f} us; "
              f"exact-arithmetic floor {floor_ms:.4f} ms (two instructions a product at "
              f"{PEAK_F32_FLOPS / 2e12:.1f} T instructions/s): the flat kernel takes "
              f"{us / 1e3 / floor_ms:.2f}x its floor on the device, "
              f"{times['knn'] / floor_ms:.2f}x under CUDA events; at k = 1 (nearly no "
              f"insertions) {k1_us:.1f} us, so the insertions of k = {k} cost "
              f"{us - k1_us:.1f} us")
    print(f"{'':11s} SM clock right after the timed loops: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    knn_edge_cases(device)


def knn_edge_cases(device) -> None:
    """Shapes the flat kernel's tiles can get wrong, each against the plain
    version slot for slot, with and without `mask` and
    `include_self=False`, and flat against two-level: N no multiple of the
    128-candidate tile or of the rows of a block (4099, 37, 1100), row
    widths on the 16-byte path (64, 128, 8, 12), on the 4-byte path (1, 3,
    6, 9, 67) and past one 64-feature chunk (67, 128, 132), k = 1 and 32,
    one cloud, a view that is not 16-byte aligned, and batches small
    enough that a warp takes four or two query rows instead of eight."""
    from pointseg_torch.ops.knn import knn_indices, knn_indices_plain

    rng = np.random.default_rng(14)
    cases = [  # (B, N, F, k)
        (2, 4099, 64, 20), (1, 37, 64, 20), (1, 37, 3, 20), (2, 500, 1, 20), (2, 500, 3, 1),
        (2, 500, 6, 32), (2, 500, 9, 20), (2, 300, 64, 32), (2, 500, 67, 20), (2, 500, 128, 20),
        (1, 700, 128, 1), (1, 1000, 64, 20), (2, 400, 8, 20), (2, 400, 12, 32),
        (1, 130, 132, 7), (8, 1100, 64, 20), (8, 1100, 9, 20), (5, 4099, 3, 32),
    ]
    for B, N, F, k in cases:
        x = torch.from_numpy(activations(rng, B, N, F, repeat_from=N - N // 4)).to(device)
        want = knn_indices_plain(x, k)
        for select in ("flat", "two_level"):
            got = knn_indices(x, k, select=select)
            if not torch.equal(got, want):
                raise AssertionError(f"kNN {select} {(B, N, F, k)}: {int((got != want).sum())} "
                                     f"slots differ from plain")
        check_knn_options(x, k, quiet=True)
    # the same rows at an address that is 4 bytes past a 16-byte boundary
    x = torch.from_numpy(activations(rng, 2, 400, 8)).to(device)
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view_as(x).copy_(x)
    if shifted.data_ptr() % 16 == 0 or not torch.equal(knn_indices(shifted, 20),
                                                        knn_indices_plain(x, 20)):
        raise AssertionError("kNN on a view that is not 16-byte aligned differs from plain")
    print(f"{'':11s} {len(cases) + 1} more shapes (N = 37, 4099, 1100; F = 1, 3, 6, 8, 9, 12, "
          f"64, 67, 128, 132; k = 1, 20, 32; B = 1, 2, 5, 8; a misaligned view), each with "
          f"mask, without self, and both: flat and two-level equal plain slot for slot")


def check_knn_options(x, k: int, quiet: bool = False) -> None:
    """`mask` and `include_self=False` run in both kernels and give the
    plain version's lists, slot for slot."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.knn import knn_indices, knn_indices_plain

    B, N, _ = x.shape
    mask = torch.rand((B, N), device=x.device,
                      generator=torch.Generator(x.device).manual_seed(4)) < 0.8
    mask[0, 10:] = False  # a cloud with fewer than k points left
    for kwargs in ({"mask": mask}, {"include_self": False},
                   {"mask": mask, "include_self": False}):
        want = knn_indices_plain(x, k, **kwargs)
        for select, counter in (("flat", "knn"), ("two_level", "knn_2l")):
            before = _kernels.LAUNCHES[counter]
            got = knn_indices(x, k, select=select, **kwargs)
            if _kernels.LAUNCHES[counter] != before + 1:
                raise AssertionError(f"kNN {select} with {sorted(kwargs)} launched no kernel")
            if not torch.equal(got, want):
                raise AssertionError(f"kNN {select} {tuple(x.shape)} k={k} with {sorted(kwargs)}: "
                                     f"{int((got != want).sum())} slots differ from plain")
    if not quiet:
        print(f"{'':11s} with mask, without self, and both: flat and two-level equal plain")


# What one PointNet++ step gathers from, (N, C, idx shape): per SA stage
# the centroids' coordinates and the (features, coords) table of width
# h + 3, per FP stage the three interpolation sources of every target.
POINTNETPP_GATHERS = [
    (4096, 3, (1024,)), (4096, 35, (1024, 32)), (1024, 3, (256,)), (1024, 67, (256, 32)),
    (256, 3, (64,)), (256, 131, (64, 32)), (64, 3, (16,)), (64, 259, (16, 32)),
    (16, 512, (64, 3)), (64, 256, (256, 3)), (256, 256, (1024, 3)), (1024, 128, (4096, 3)),
]


def gather_kernels(device, record: Record) -> None:
    from pointseg_torch.ops.gather import gather_rows, gather_rows_plain

    rng = np.random.default_rng(2)
    # (B, N, C, idx shape, how often one DGCNN forward runs it)
    cases = [(8, 4096, 64, (4096, K_NEIGHBOURS), 3), (8, 4096, 128, (4096, K_NEIGHBOURS), 1)]
    cases += [(8, N, C, shape, 0) for N, C, shape in POINTNETPP_GATHERS]
    for B, N, C, shape, per_forward in cases:
        table = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(0, N, (B, *shape)).astype(np.int32)).to(device)
        weight = torch.randn((B, *shape, C), device=device,
                             generator=torch.Generator(device).manual_seed(3))
        t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
        got, want = gather_rows(t1, idx), gather_rows_plain(t2, idx)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows {(B, N, C)}: rows differ from torch.gather "
                                 f"(max |diff| {err:.3g})")
        (got * weight).sum().backward()
        (want * weight).sum().backward()
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-4, atol=1e-4)
        grad_err = float((t1.grad - t2.grad).abs().max())
        del t1, t2, got, want, weight
        M = math.prod(shape)
        # the plain version is the library call: one torch.gather
        ms, plain_ms = timed_pair(lambda: gather_rows(table, idx),
                                  lambda: gather_rows_plain(table, idx), 20)
        record.note("gather_rows", (B, N, C, M), ms, plain_ms, plain_ms, 0.0,
                    4 * B * N * C + 4 * B * M + 4 * B * M * C, 0, max(err, grad_err),
                    per_forward)
        print(f"{'':11s} backward (index_add_) against autograd of torch.gather: "
              f"max |diff| {grad_err:.3g}")


# SetAbstraction groupings of one forward pass at B = 8, N = 4096 (the
# feature table's points, its width h, centroids, K), per model: one
# `gather_rows_with_coords` each, feature rows of h floats and coordinate
# rows of 3; the first stage's coordinates are a view of the (8, 4096, 9)
# input, as in the models.
SA_GROUPINGS = {
    "PointNet++": [(4096, 32, 1024, 32), (1024, 64, 256, 32), (256, 128, 64, 32),
                   (64, 256, 16, 32)],
    "PointNet++MSG": [(4096, 16, 1024, 16), (4096, 32, 1024, 32), (1024, 64, 256, 16),
                      (1024, 64, 256, 32), (256, 128, 64, 16), (256, 128, 64, 32),
                      (64, 256, 16, 16), (64, 256, 16, 32)],
    "PointNeXt": [(4096, 32, 1024, 32), (1024, 64, 1024, 32), (1024, 64, 256, 32),
                  (256, 128, 256, 32), (256, 128, 256, 32), (256, 128, 64, 32),
                  (64, 256, 64, 32), (64, 256, 16, 16), (16, 512, 16, 16)],
}


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds a call of `fn`: every kernel and copy it runs
    (profiler), none of the host's gaps between them."""
    from torch.autograd import DeviceType

    fn()  # warm-up
    return sum(device_time_us(e) for e in profiled(fn, reps)
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / reps / 1e3


def sa_grouping_forms(device) -> None:
    """Three forms of SetAbstraction grouping at every SA table of
    PointNet++, MSG and PointNeXt, forward (as in training: the features
    need a gradient) and forward + backward (eight forwards and one
    backward call over them, as a step has one; times per grouping): the
    concatenated table with
    one launch (the JAX package's form, and the port's before the
    two-table kernel), two
    launches, and the two-table kernel (`gather_rows_with_coords`). Rows
    bit-equal across the three, and the two-table call beside the library
    (two `torch.gather` calls). CUDA events (host and device) and device
    time (profiler), in turns."""
    from pointseg_torch.ops.gather import gather_rows, gather_rows_with_coords

    def concat(f, c, idx):
        rows = gather_rows(torch.cat([f, c], dim=-1), idx)
        return rows[..., :f.shape[-1]], rows[..., f.shape[-1]:]

    def two_launches(f, c, idx):
        return gather_rows(f, idx), gather_rows(c, idx)

    def library(f, c, idx):
        return rows(f, idx), rows(c, idx)

    forms = {"concat": concat, "two launches": two_launches,
             "two-table kernel": gather_rows_with_coords}
    rng = np.random.default_rng(9)
    sums = {model: {(form, kind): 0.0 for form in forms for kind in ("fwd", "fwd+bwd",
                                                                     "fwd device",
                                                                     "fwd+bwd device")}
            for model in SA_GROUPINGS}
    lib_sum = {model: [0.0, 0.0] for model in SA_GROUPINGS}
    shapes = dict.fromkeys(g for groupings in SA_GROUPINGS.values() for g in groupings)
    for N, h, C, K in shapes:
        B = 8
        x = torch.from_numpy(rng.random((B, N, 9)).astype(np.float32)).to(device)
        coords = x[..., :3] if N == 4096 else x[..., :3].contiguous()
        feats = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(device)
        feats.requires_grad_(True)
        idx = torch.from_numpy(rng.integers(0, N, (B, C, K)).astype(np.int32)).to(device)
        grad = torch.randn((B, C, K, h), device=device)
        outs = {name: form(feats, coords, idx) for name, form in forms.items()}
        want = library(feats.detach(), coords, idx)
        for name, (gf, gc) in outs.items():
            if not (torch.equal(gf, want[0]) and torch.equal(gc, want[1])):
                raise AssertionError(f"SA grouping {(N, h, C, K)}, {name}: rows differ")
        del outs

        def fwd(form):
            return lambda: form(feats, coords, idx)

        def fwd_bwd(form):  # eight groupings, one backward call: a step's shape
            return lambda: torch.autograd.backward(
                [form(feats, coords, idx)[0] for _ in range(8)], [grad] * 8)

        times = {}
        for name in [*forms, *reversed(forms)]:  # in turns, there and back
            times.setdefault((name, "fwd"), []).append(timed(fwd(forms[name]), 20))
            times.setdefault((name, "fwd+bwd"), []).append(timed(fwd_bwd(forms[name]), 5) / 8)
        for name, form in forms.items():
            times[(name, "fwd device")] = [device_ms(fwd(form))]
            times[(name, "fwd+bwd device")] = [device_ms(fwd_bwd(form), reps=3) / 8]
        lib_ms = timed(lambda: library(feats.detach(), coords, idx), 20)
        call_ms = timed(lambda: gather_rows_with_coords(feats.detach(), coords, idx), 20)
        feats.grad = None
        line = "; ".join(f"{name} " + " / ".join(
            f"{sum(times[(name, kind)]) / len(times[(name, kind)]):.4f}"
            for kind in ("fwd", "fwd+bwd", "fwd device", "fwd+bwd device")) for name in forms)
        print(f"SA grouping (8, {N}, {h}) + coords x ({C}, {K}), ms fwd / fwd+bwd (CUDA events) "
              f"/ fwd / fwd+bwd (device): {line}; the two-table call without a gradient "
              f"{call_ms:.4f} against two torch.gather {lib_ms:.4f} ({call_ms / lib_ms:.2f}x)")
        for model, groupings in SA_GROUPINGS.items():
            n = groupings.count((N, h, C, K))
            for key, values in times.items():
                sums[model][key] += n * sum(values) / len(values)
            lib_sum[model][0] += n * call_ms
            lib_sum[model][1] += n * lib_ms
    for model, total in sums.items():
        line = "; ".join(f"{name} " + " / ".join(f"{total[(name, kind)]:.4f}" for kind in (
            "fwd", "fwd+bwd", "fwd device", "fwd+bwd device")) for name in forms)
        fastest = {kind: min(forms, key=lambda name: total[(name, kind)])
                   for kind in ("fwd", "fwd+bwd", "fwd device", "fwd+bwd device")}
        print(f"SA grouping, {model}'s {len(SA_GROUPINGS[model])} tables summed, ms fwd / fwd+bwd "
              f"(CUDA events) / fwd / fwd+bwd (device): {line}; fastest {fastest}; the "
              f"two-table calls {lib_sum[model][0]:.4f} against two torch.gather each "
              f"{lib_sum[model][1]:.4f}")


def sector_bytes(idx: torch.Tensor, row_bytes: int, table_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors that the rows `idx` of a
    table of `row_bytes`-wide rows touch: what these indices make the
    card read, however short the rows are."""
    first = idx * row_bytes // 32
    last = (idx * row_bytes + row_bytes - 1) // 32
    spans = [first + k for k in range((row_bytes + 30) // 32 + 1)]
    touched = torch.cat([torch.minimum(s, last) for s in spans])
    return min(table_bytes, 32 * int(torch.unique(touched).numel()))


def gather_flat_kernels(device, record: Record, seed: int) -> None:
    """The flat gather at the device store's tables, small and full size."""
    from torch.autograd import DeviceType

    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.gather import gather_rows_flat, gather_rows_flat_plain

    gen = torch.Generator(device).manual_seed(seed)

    def make_table(rows, width, dtype):
        shape = (rows,) if width is None else (rows, width)
        if dtype == torch.float32:
            return torch.rand(shape, device=device, generator=gen)
        return torch.randint(0, 250 if dtype == torch.uint8 else 2**31 - 1, shape,
                             device=device, generator=gen, dtype=dtype)

    def case(table, what, mrows, per_step, reps=20):
        R, row_bytes = table.shape[0], table[0].numel() * table.element_size()

        def fresh():  # every training step gathers rows it has not seen
            idx = torch.randint(0, R, (mrows,), device=device, generator=gen)
            idx[0], idx[-1] = 0, R - 1
            return idx

        idx = fresh()
        before = dict(_kernels.LAUNCHES)
        got = gather_rows_flat(table, idx)
        if (_kernels.LAUNCHES["gather_rows_flat"] != before["gather_rows_flat"] + 1
                or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
            raise AssertionError(f"gather_rows_flat {what}: not exactly one launch of its kernel")
        want = gather_rows_flat_plain(table, idx)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"gather_rows_flat {what}: rows differ from index_select")
        if not torch.equal(gather_rows_flat(table, idx.int()), want):
            raise AssertionError(f"gather_rows_flat {what}: int32 indices give other rows")
        nbytes = (sector_bytes(idx, row_bytes, table.numel() * table.element_size())
                  + 8 * mrows + mrows * row_bytes)
        del got, want

        def over_fresh_rows(fn):
            rows = [fresh() for _ in range(reps)]
            torch.cuda.synchronize()
            it = iter(rows)
            return cuda_ms(lambda: fn(table, next(it)), reps)

        # index_select alone: what the plain version calls after its checks
        def index_select(t, i):
            return torch.index_select(t, 0, i)

        p1 = over_fresh_rows(gather_rows_flat_plain)
        l1 = over_fresh_rows(index_select)
        k1 = over_fresh_rows(gather_rows_flat)
        k2 = over_fresh_rows(gather_rows_flat)
        l2 = over_fresh_rows(index_select)
        p2 = over_fresh_rows(gather_rows_flat_plain)
        lib_ms = (l1 + l2) / 2
        us = kernel_device_us(lambda: gather_rows_flat(table, fresh()), "gather_rows_flat_kernel")
        # whatever kernels `index_select` runs (their names change with the
        # row width and the PyTorch version): all device time of the calls
        rows = iter([fresh() for _ in range(10)])
        lib_us = sum(device_time_us(e) for e in profiled(
            lambda: torch.index_select(table, 0, next(rows)), 10)
            if e.device_type == DeviceType.CUDA) / 10
        record.note("gather_rows_flat", (R, row_bytes, mrows, what), (k1 + k2) / 2,
                    (p1 + p2) / 2, lib_ms, 0.0, nbytes, 0, 0.0, per_step)
        print(f"{'':11s} device time a launch (profiler): kernel {us:.1f} us, index_select's "
              f"kernels {lib_us:.1f} us; sectors {nbytes - 8 * mrows - mrows * row_bytes} B, "
              f"rows {mrows * row_bytes} B")
        call_ms = (k1 + k2) / 2
        print(f"{'':11s} a call under CUDA events, in turns: kernel {call_ms * 1e3:.2f} us "
              f"({k1 * 1e3:.2f}, {k2 * 1e3:.2f}), index_select {lib_ms * 1e3:.2f} us "
              f"({l1 * 1e3:.2f}, {l2 * 1e3:.2f}): the kernel's call is "
              f"{'faster' if call_ms <= lib_ms else 'slower'} ({call_ms / lib_ms:.2f}x)")

    odd = 12_347  # rows to gather: a prime
    for what, width, dtype, per_step in (("labels", None, torch.uint8, 1),
                                         ("packed", 4, torch.int32, 0),
                                         ("points", 9, torch.float32, 1),
                                         ("odd width", 35, torch.float32, 0)):
        table = make_table(SYNTHETIC_ROWS, width, dtype)
        case(table, what, SAMPLED_ROWS, per_step)
        case(table, what, odd, 0)
    # all of S3DIS: each table freed before the next is made
    for what, width, dtype in (("packed", 4, torch.int32), ("points", 9, torch.float32),
                               ("labels", None, torch.uint8)):
        t0 = time.time()
        table = make_table(S3DIS_ROWS, width, dtype)
        torch.cuda.synchronize()
        print(f"{'':11s} {what} table of {S3DIS_ROWS} rows, "
              f"{table.numel() * table.element_size() / 1e9:.2f} GB, made in "
              f"{time.time() - t0:.2f} s")
        case(table, f"{what}, all of S3DIS", SAMPLED_ROWS, 0)
        case(table, f"{what}, all of S3DIS", odd, 0, reps=5)
        del table
        torch.cuda.empty_cache()


def host_us(fn, calls: int = 10_000) -> float:
    """Host microseconds per call of `fn` over `calls` calls, by the host's
    clock with no synchronisation inside the loop: what the call costs the
    thread that launches the work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def launch_path_split(device) -> None:
    """Where the host time of one `gather_rows_flat` call goes: 32,768 rows
    of the 240,000-row table of nine floats. Each part is timed by itself
    (the parts of the call as it is now, then the steps it no longer
    takes), beside the whole call, `torch.index_select` and an empty
    Python function."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.gather import gather_rows_flat

    gen = torch.Generator(device).manual_seed(11)
    table = torch.rand((SYNTHETIC_ROWS, 9), device=device, generator=gen)
    idx = torch.randint(0, SYNTHETIC_ROWS, (SAMPLED_ROWS,), device=device, generator=gen)
    out = torch.empty((SAMPLED_ROWS, 9), device=device)
    _kernels.library()
    symbol = "pointseg_gather_rows_flat"
    entry = _kernels._ENTRY_POINTS[symbol]
    index = device.index
    stream = _kernels._raw_stream(index)
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), SYNTHETIC_ROWS, SAMPLED_ROWS, 36)

    def empty_call():
        pass

    def checks():  # the tests the public function and its CUDA path make
        dtype = idx.dtype
        return (idx.dim() != 1 or (dtype != torch.int64 and (idx.is_floating_point()
                                                             or dtype == torch.bool))
                or table.dim() < 1 or not table.is_cuda or idx.device != table.device
                or not table.is_contiguous() or idx.dtype != torch.int64
                or not idx.is_contiguous())

    def sizes_and_pointers():
        return (table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0], idx.shape[0],
                out.stride(0) * out.element_size(), out.numel())

    def guard():
        with torch.cuda.device(device):
            pass

    def count():
        _kernels.LAUNCHES["gather_rows_flat"] += 0

    now = [
        ("argument checks", checks),
        ("table.new_empty of the output", lambda: table.new_empty((idx.shape[0],
                                                                   *table.shape[1:]))),
        ("pointers, sizes, row bytes", sizes_and_pointers),
        ("device index and raw stream handle", lambda: _kernels._raw_stream(device.index)),
        ("the ctypes call (launches the kernel)", lambda: entry(*args, index, stream)),
        ("launch counter", count),
    ]
    before = [
        ("`with torch.cuda.device(device)`", guard),
        ("torch.cuda.current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(device).cuda_stream),
        ("getattr(library(), symbol)", lambda: getattr(_kernels.library(), symbol)),
        ("idx.to(int64).contiguous() on an int64 index", lambda: idx.to(torch.int64).contiguous()),
        ("math.prod(table.shape[1:])", lambda: math.prod(table.shape[1:])),
        ("torch.empty(shape, dtype=, device=) of the output, less new_empty's time",
         lambda: torch.empty((SAMPLED_ROWS, 9), dtype=table.dtype, device=table.device)),
    ]
    whole = host_us(lambda: gather_rows_flat(table, idx))
    library_call = host_us(lambda: torch.index_select(table, 0, idx))
    nothing = host_us(empty_call)
    print(f"host time of one gather_rows_flat call ({SAMPLED_ROWS} rows of 36 bytes from "
          f"{SYNTHETIC_ROWS}), us a call over 10,000 calls, host clock, no synchronisation:")
    print(f"  whole call {whole:.2f}; torch.index_select {library_call:.2f}; an empty Python "
          f"function {nothing:.3f}")
    parts = {name: host_us(fn) for name, fn in now}
    total = sum(parts.values())
    for name, us in parts.items():
        print(f"  part of the call: {name:45s} {us:7.2f}")
    print(f"  parts summed {total:.2f} (each part pays an empty call's {nothing:.3f} again)")
    gone = 0.0
    for name, fn in before:
        us = host_us(fn)
        if name.startswith("torch.empty"):
            us -= parts["table.new_empty of the output"]
        gone += us
        print(f"  no longer in the call: {name:45s} {us:7.2f}")
    print(f"  steps no longer taken, summed {gone:.2f}")


def gather_call_split(device) -> None:
    """Where the host time of one `gather_rows` call goes, at the first
    stage's centroid gather, (8, 4096, 3) x 1,024 rows, a table needing no
    gradient (four such calls a PointNet++ step; a kernel of a few
    microseconds, so the call is host time): each part timed by itself,
    then the steps the call no longer takes, beside the whole call,
    `torch.gather` and an empty Python function."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.gather import _check_batched, _GatherRows, gather_rows

    gen = torch.Generator(device).manual_seed(12)
    table = torch.rand((8, 4096, 3), device=device, generator=gen)
    idx = torch.randint(0, 4096, (8, 1024), device=device, generator=gen, dtype=torch.int32)
    grad_table = table.clone().requires_grad_(True)
    flat = idx.long()[..., None].expand(-1, -1, 3)
    out = table.new_empty((8, 1024, 3))
    _kernels.library()
    symbol = "pointseg_gather_rows"
    entry = _kernels._ENTRY_POINTS[symbol]
    index = device.index
    stream = _kernels._raw_stream(index)
    args = (table.data_ptr(), None, idx.data_ptr(), out.data_ptr(), None, 8, 4096, 1024, 12, 0)

    def count():
        _kernels.LAUNCHES["gather_rows"] += 0

    def dispatch():  # the public function's test and its device test
        return (table.requires_grad and torch.is_grad_enabled()) or _kernels.on_cuda(table)

    def layout():  # contiguity and the index's type, nothing to convert
        return (table.is_contiguous(), idx.dtype != torch.int32 or not idx.is_contiguous())

    now = [
        ("grad test and device dispatch", dispatch),
        ("argument checks (_check_batched)", lambda: _check_batched(table, idx, None)),
        ("contiguity and index type", layout),
        ("table.new_empty of the output", lambda: table.new_empty((*idx.shape, 3))),
        ("pointers, sizes, row bytes", lambda: (table.data_ptr(), idx.data_ptr(),
                                                out.data_ptr(), idx.numel() // 8,
                                                3 * table.element_size(), table.shape)),
        ("device index and raw stream handle", lambda: _kernels._raw_stream(device.index)),
        ("the ctypes call (launches the kernel)", lambda: entry(*args, index, stream)),
        ("launch counter", count),
    ]
    before = [
        ("_GatherRows.apply on a table needing a gradient, less the direct call",
         lambda: _GatherRows.apply(grad_table, idx, None)),
        ("table.contiguous() on a contiguous table", lambda: table.contiguous()),
        ("idx.reshape(B, -1).to(int32).contiguous()",
         lambda: idx.reshape(8, -1).to(torch.int32).contiguous()),
        ("two _kernels.check calls", lambda: (
            _kernels.check(table, "table", torch.float32, (8, 4096, 3)),
            _kernels.check(idx.reshape(8, -1), "idx", torch.int32, (8, 1024)))),
        ("torch.empty(shape, dtype=, device=) of the output, less new_empty's time",
         lambda: torch.empty((8, 1024, 3), dtype=table.dtype, device=table.device)),
    ]
    whole = host_us(lambda: gather_rows(table, idx))
    library_call = host_us(lambda: torch.gather(table, 1, flat))
    nothing = host_us(lambda: None)
    print(f"host time of one gather_rows call (8 x 1,024 rows of 3 floats from 8 x 4096, a "
          f"table needing no gradient), us a call over 10,000 calls, host clock, no "
          f"synchronisation:")
    print(f"  whole call {whole:.2f}; torch.gather {library_call:.2f}; an empty Python function "
          f"{nothing:.3f}")
    parts = {name: host_us(fn) for name, fn in now}
    for name, us in parts.items():
        print(f"  part of the call: {name:45s} {us:7.2f}")
    print(f"  parts summed {sum(parts.values()):.2f} (each part pays an empty call's "
          f"{nothing:.3f} again)")
    gone = 0.0
    for name, fn in before:
        us = host_us(fn)
        if name.startswith("_GatherRows"):
            us -= whole
        elif name.startswith("torch.empty"):
            us -= parts["table.new_empty of the output"]
        gone += us
        print(f"  no longer in the call: {name:45s} {us:7.2f}")
    print(f"  steps no longer taken, summed {gone:.2f}")


def streams_and_graphs(device) -> None:
    """Kernels 8 and 4 on a stream that is not the default one, and inside
    a captured CUDA graph that is replayed on new input; each result equal
    to the plain version's. On the side stream the input is written behind
    a long wait, so a launch that went to another stream would read it too
    early."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.gather import gather_rows_flat, gather_rows_flat_plain
    from pointseg_torch.ops.knn import knn_indices, knn_indices_plain

    rng = np.random.default_rng(12)
    gen = torch.Generator(device).manual_seed(13)
    table = torch.rand((SYNTHETIC_ROWS, 9), device=device, generator=gen)
    rows = [torch.randint(0, SYNTHETIC_ROWS, (SAMPLED_ROWS,), device=device, generator=gen)
            for _ in range(2)]
    clouds = [torch.from_numpy(activations(rng, 2, 1024, 64)).to(device) for _ in range(2)]
    runs = {
        "gather_rows_flat": (lambda i: gather_rows_flat(table, i),
                             lambda i: gather_rows_flat_plain(table, i), rows),
        "knn": (lambda x: knn_indices(x, K_NEIGHBOURS),
                lambda x: knn_indices_plain(x, K_NEIGHBOURS), clouds),
    }
    side = torch.cuda.Stream(device)
    for name, (kernel_fn, plain_fn, (first, second)) in runs.items():
        want_first, want_second = plain_fn(first), plain_fn(second)
        inp = torch.zeros_like(first)
        torch.cuda.synchronize()
        before = _kernels.LAUNCHES[name]
        with torch.cuda.stream(side):
            torch.cuda._sleep(40_000_000)  # some 20 ms on the side stream
            inp.copy_(first)
            got = kernel_fn(inp)
        side.synchronize()
        if _kernels.LAUNCHES[name] != before + 1 or not torch.equal(got, want_first):
            raise AssertionError(f"{name} on a side stream differs from the plain version")

        with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
            kernel_fn(inp)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kernel_fn(inp)
        inp.copy_(second)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, want_second):
            raise AssertionError(f"{name} replayed from a CUDA graph on new input differs from "
                                 f"the plain version")
        inp.copy_(first)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, want_first):
            raise AssertionError(f"{name}: the second replay differs from the plain version")
        print(f"{name:16s} on a side stream, and captured in a CUDA graph and replayed on new "
              f"input twice: equal to the plain version")


def zero_launches() -> None:
    from pointseg_torch.ops import _kernels

    for name in _kernels.LAUNCHES:
        _kernels.LAUNCHES[name] = 0


def read_launches() -> dict:
    from pointseg_torch.ops import _kernels

    torch.cuda.synchronize()
    return dict(_kernels.LAUNCHES)


def own_kernel_names() -> set:
    """The `__global__` functions of the port's CUDA sources."""
    from pointseg_torch.ops import _kernels

    return {name for source in _kernels.SOURCES
            for name in re.findall(r"__global__ void (\w+)", (_kernels.CSRC / source).read_text())}


def steady_state(state, batch, label: str) -> dict:
    """Step time, points/s, peak memory and a profile of `train_step`."""
    from torch.profiler import ProfilerActivity, profile

    from pointseg_torch.train.state import train_step

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
    print(f"{label} train step (B={batch[0].shape[0]}, N={batch[0].shape[1]}): "
          f"{step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock), "
          f"{points / (step_ms / 1e3):.0f} points/s, peak allocated {peak / 2**20:.1f} MiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            train_step(state, *batch)
        torch.cuda.synchronize()
    print(f"profile of 3 {label} train steps, by device time:")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=18,
                                    max_name_column_width=60))
    own = {}
    for e in prof.key_averages():
        match = re.search(r"\(anonymous namespace\)::(\w+)[<(]", e.key)
        if match and match.group(1) in own_kernel_names():
            ms, n = own.get(match.group(1), (0.0, 0))  # a template's instances add up
            own[match.group(1)] = (ms + device_time_us(e) / 3e3, n + e.count // 3)
    print(f"{label}: device ms a step (launches a step) of the port's own kernels: "
          + ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in sorted(own.items())))
    return {"step_ms": step_ms, "host_step_ms": host_ms,
            "points_per_s": points / (step_ms / 1e3), "peak_bytes": peak}


def train_through_cli(model_name: str, workdir: str, needed: tuple[str, ...],
                      flags: tuple[str, ...] = (), mode: str = "host loader",
                      env: dict | None = None):
    """One epoch and its evaluation through the CLI, with `flags` added
    and the environment variables `env` set for the run; returns (state,
    launches, records). Raises unless every kernel in `needed` was
    launched and the train split came by way of `mode`."""
    from pointseg_torch import cli

    argv = ["train", model_name, "--synthetic", "--data-dir", f"{workdir}/data",
            "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "4096",
            "--device", "cuda", "--log-dir", f"{workdir}/logs", *flags]
    args = cli.build_parser().parse_args(argv)
    env = env or {}
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    try:
        zero_launches()
        t0 = time.time()
        state, records = cli.train_from_args(args)
        launches = read_launches()
    finally:
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value
    shown = " ".join([*(f"{k}={v}" for k, v in env.items()), *flags])
    print(f"{model_name} {shown}: {time.time() - t0:.1f} s for one epoch ({state.step} "
          f"steps) and its evaluation; launches {launches}")
    if records["config"]["data_mode"] != mode:
        raise AssertionError(f"train {model_name} {flags}: the train split came by way of "
                             f"{records['config']['data_mode']!r}, not {mode!r}")
    if not all(math.isfinite(v) for v in records["train_loss"] + records["val_loss"]):
        raise AssertionError(f"non-finite loss: {records}")
    off_card = [k for k, p in state.model.named_parameters() if p.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"parameters off the card: {off_card}")
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by train {model_name}: {missing}")
    return state, launches, records


def two_level_against_flat(model_name: str, option: str, flat: str, two_level: str,
                           per_step: int, state, batch, device) -> dict:
    """Three steps each of `model_name` with the two-level and the flat
    kernel (model argument `option`, launch counters `two_level` and
    `flat`, `per_step` launches a step), from the trained weights, one
    batch, one FPS seed and one dropout seed; returns the two-level run's
    launches."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses, launches = {}, {}
    for select in ("two_level", "flat"):
        model = create_model(model_name, **{option: select})
        model.load_state_dict(weights)
        run = create_train_state(model, device=device, learning_rate=1e-3, seed=0)
        torch.manual_seed(1234)  # the same dropout masks in both runs
        zero_launches()
        losses[select] = [float(train_step(run, *batch)["loss"]) for _ in range(3)]
        launches[select] = read_launches()
    print(f"{model_name} two-level: losses {losses['two_level']} launches {launches['two_level']}")
    print(f"{model_name} flat:      losses {losses['flat']} launches {launches['flat']}")
    for select, used, unused in (("two_level", two_level, flat), ("flat", flat, two_level)):
        if launches[select][used] != 3 * per_step or launches[select][unused] != 0:
            raise AssertionError(f"{model_name} {option}={select!r} must launch {used} "
                                 f"{per_step} times a step and {unused} never: "
                                 f"{launches[select]}")
    for step, (a, b) in enumerate(zip(losses["two_level"], losses["flat"])):
        rel = 1e-6 if step == 0 else 1e-3
        if not math.isfinite(a) or abs(a - b) > rel * abs(b):
            raise AssertionError(f"{model_name} step {step}: two-level loss {a} vs flat {b} "
                                 f"(rel {rel})")
    return launches["two_level"]


def few_steps(model_name: str, batch, device) -> None:
    """Step time and peak memory of three train steps of `model_name` from
    fresh weights, after two warm-up steps."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    torch.manual_seed(0)
    run = create_train_state(create_model(model_name), device=device, learning_rate=1e-3, seed=0)
    loss = [float(train_step(run, *batch)["loss"]) for _ in range(2)][-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    step_ms = cuda_ms(lambda: train_step(run, *batch), 3)
    launches = read_launches()
    if not math.isfinite(loss) or launches["ball_query"] == 0:
        raise AssertionError(f"{model_name}: loss {loss}, launches {launches}")
    points = batch[0].shape[0] * batch[0].shape[1]
    print(f"{model_name} train step (3 steps): {step_ms:.3f} ms, "
          f"{points / (step_ms / 1e3):.0f} points/s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches a step "
          f"{ {k: v // 3 for k, v in launches.items() if v} }")
    del run
    torch.cuda.empty_cache()


def remat_cost(state, batch, device) -> None:
    """Step time and peak memory of DeepGraphCnn with and without
    `EdgeConv.remat`, from the same weights and batch."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    for remat in (False, True):
        model = create_model("DeepGraphCnn")
        model.load_state_dict(weights)
        for conv in (model.conv1, model.conv2, model.conv3, model.conv4):
            conv.remat = remat
        run = create_train_state(model, device=device, learning_rate=1e-3, seed=0)
        loss = [float(train_step(run, *batch)["loss"]) for _ in range(2)][-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        step_ms = cuda_ms(lambda: train_step(run, *batch), 5)
        gathers = read_launches()["gather_rows"] // 5
        if not math.isfinite(loss) or gathers != (8 if remat else 4):
            raise AssertionError(f"remat={remat}: loss {loss}, {gathers} gathers a step")
        print(f"DeepGraphCnn remat={remat}: {step_ms:.3f} ms a step, {gathers} gathers a step, "
              f"peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        del run, model
        torch.cuda.empty_cache()


def trainer_phase(device, workdir: str):
    from pointseg_torch.data.datasets import create_block_dataloaders
    from pointseg_torch.train.loop import to_device

    pp_state, pp_launches, _ = train_through_cli(
        "PointNet++", workdir, ("fps", "ball_query", "three_nn", "gather_rows"))
    if (pp_launches["knn"] or pp_launches["knn_2l"] or pp_launches["ball_query_2l"]
            or pp_launches["gather_rows_flat"]):
        raise AssertionError(f"PointNet++ launched kernels off its path: {pp_launches}")
    train_loader, _ = create_block_dataloaders(f"{workdir}/data", {6}, 8, 2, 4096, seed=1)
    batch = to_device(next(iter(train_loader)), device)
    pp_perf = steady_state(pp_state, batch, "PointNet++")

    dg_state, dg_launches, _ = train_through_cli("DeepGraphCnn", workdir,
                                                 ("knn", "gather_rows"))
    steps = dg_state.step
    if dg_launches["knn"] < 4 * steps or dg_launches["gather_rows"] < 4 * steps:
        raise AssertionError(f"DeepGraphCnn: {steps} steps need at least {4 * steps} kNN and "
                             f"gather launches, got {dg_launches}")
    if dg_launches["knn_2l"] or dg_launches["fps"] or dg_launches["ball_query_2l"]:
        raise AssertionError(f"DeepGraphCnn launched kernels off its path: {dg_launches}")
    two_level_against_flat("DeepGraphCnn", "knn_select", "knn", "knn_2l", 4, dg_state, batch,
                           device)
    dg_perf = steady_state(dg_state, batch, "DeepGraphCnn")
    remat_cost(dg_state, batch, device)
    states = {"PointNet++": (pp_state, pp_perf), "DeepGraphCnn": (dg_state, dg_perf)}

    # per forward pass (a train step or an eval batch): fps, ball_query, three_nn
    for name, per_forward in (("PointNeXt", (4, 9, 4)), ("PointNet++MSG", (4, 8, 4))):
        state, got, _ = train_through_cli(name, workdir,
                                          ("fps", "ball_query", "three_nn", "gather_rows"))
        forwards = got["fps"] // per_forward[0]
        want = {"fps": per_forward[0] * forwards, "ball_query": per_forward[1] * forwards,
                "three_nn": per_forward[2] * forwards, "ball_query_2l": 0, "knn": 0, "knn_2l": 0}
        if forwards <= state.step or any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: {state.step} steps and their evaluation must launch "
                                 f"{per_forward} (fps, ball_query, three_nn) per forward pass "
                                 f"and no other selection kernel, got {got}")
        two_level_against_flat(
            name, "ball_select", "ball_query", "ball_query_2l", per_forward[1], state, batch,
            device)
        states[name] = (state, steady_state(state, batch, name))
    few_steps("PointNeXt-L", batch, device)
    # the two-level kernels from a command a user can type: the JAX
    # package's switch, read by the port's CLI
    select2l = {}
    for name, used, unused, per_step in (("PointNeXt", "ball_query_2l", "ball_query", 9),
                                         ("DeepGraphCnn", "knn_2l", "knn", 4)):
        state, got, _ = train_through_cli(name, workdir, (used,),
                                          env={"POINTSEG_SELECT2L": "1"})
        if got[unused] or got[used] < per_step * state.step:
            raise AssertionError(f"POINTSEG_SELECT2L=1 train {name}: {state.step} steps must "
                                 f"launch {used} at least {per_step} times a step and {unused} "
                                 f"never, got {got}")
        select2l[used] = got[used]
        del state
    flat_launches = device_store_phase(device, workdir, pp_state)

    launches = {"fps": pp_launches["fps"], "ball_query": pp_launches["ball_query"],
                "ball_query_2l": select2l["ball_query_2l"],
                "three_nn": pp_launches["three_nn"], "knn": dg_launches["knn"],
                "knn_2l": select2l["knn_2l"],
                "gather_rows": dg_launches["gather_rows"],
                "gather_rows_flat": flat_launches}
    return states, launches, batch


def fresh_state(weights: dict, device, learning_rate: float = 1e-3):
    """PointNet++ from `weights`, with the FPS and dropout seeds reset."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    model = create_model("PointNet++")
    model.load_state_dict(weights)
    torch.manual_seed(1234)
    return create_train_state(model, device=device, learning_rate=learning_rate, seed=0)


def device_store_phase(device, workdir: str, pp_state) -> int:
    """The device-resident store through the CLI and by itself; returns
    the flat-gather launches of the `--device-store flat` epoch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pointseg_torch.data import device as dev
    from pointseg_torch.data.datasets import BlockDataset, create_block_dataloaders
    from pointseg_torch.train.loop import to_device
    from pointseg_torch.train.state import train_step

    pointnetpp = ("fps", "ball_query", "three_nn", "gather_rows", "gather_rows_flat")
    flat_state, flat_launches, flat_rec = train_through_cli(
        "PointNet++", workdir, pointnetpp, ("--device-data", "--device-store", "flat"), "device")
    steps = flat_state.step
    if flat_launches["gather_rows_flat"] != 2 * steps:
        raise AssertionError(f"flat store: {steps} steps must launch the flat gather "
                             f"{2 * steps} times, got {flat_launches}")
    cache = ("--device-data", "--device-store", "compact", "--pack-cache", f"{workdir}/pack")
    _, packed_launches, first = train_through_cli("PointNet++", workdir, pointnetpp, cache,
                                                  "compact")
    raw_loader = dev._load_raw_blocks

    def no_raw_load(dataset, num_workers):
        raise AssertionError("the second start with --pack-cache loaded raw blocks: no cache hit")

    dev._load_raw_blocks = no_raw_load
    try:
        _, launches, second = train_through_cli("PointNet++", workdir, pointnetpp, cache,
                                                "compact")
    finally:
        dev._load_raw_blocks = raw_loader
    if packed_launches["gather_rows_flat"] != steps or launches["gather_rows_flat"] != steps:
        raise AssertionError(f"compact store: {steps} steps must launch the flat gather "
                             f"{steps} times, got {packed_launches} and, from the cache, "
                             f"{launches}")
    _, launches, scanned = train_through_cli(
        "PointNet++", workdir, pointnetpp,
        ("--device-data", "--device-store", "flat", "--scan-steps", "4"), "device")
    if launches["gather_rows_flat"] != 2 * steps:
        raise AssertionError(f"--scan-steps 4: {launches}")
    # one seed, one store content, one stream: the same epoch whichever way
    for label, rec in (("compact store", first), ("compact store from the cache", second),
                       ("--scan-steps 4", scanned)):
        a, b = rec["train_loss"][0], flat_rec["train_loss"][0]
        print(f"epoch loss, {label}: {a} against the flat store's {b}")
        if abs(a - b) > 1e-1 * abs(b):
            raise AssertionError(f"{label}: epoch loss {a} against {b} (rel 1e-1)")
    accum_state, launches, _ = train_through_cli(
        "PointNet++", workdir, ("fps", "ball_query", "three_nn", "gather_rows"),
        ("--accum-steps", "2"))
    if accum_state.step != (steps + 1) // 2 or launches["gather_rows_flat"]:
        raise AssertionError(f"--accum-steps 2: {accum_state.step} updates from {steps} "
                             f"batches, launches {launches}")
    _, launches, _ = train_through_cli("DeepGraphCnn", workdir,
                                       ("knn", "gather_rows", "gather_rows_flat"),
                                       ("--device-data",), "device")
    if launches["gather_rows_flat"] != 2 * steps or launches["knn"] < 4 * steps:
        raise AssertionError(f"DeepGraphCnn --device-data: {launches}")

    # the two stores by themselves
    raw_ds = BlockDataset(f"{workdir}/data", {1, 2, 3, 4, 5}, sampling=None, seed=0)
    loaders = {}
    for layout, mode in (("flat", "device"), ("compact", "compact")):
        torch.cuda.synchronize()
        t0 = time.time()
        loaders[layout], got = dev.device_store_or_host_loader(
            raw_ds, 8, 4096, seed=0, device=device, layout=layout)
        torch.cuda.synchronize()
        store = loaders[layout].store
        if got != mode or store.tables[0].device.type != "cuda":
            raise AssertionError(f"layout {layout}: mode {got}, tables on "
                                 f"{store.tables[0].device}")
        print(f"{layout} store: {store.num_blocks} blocks, {store.tables[0].shape[0]} rows, "
              f"{store.nbytes} bytes on the card; read, packed and uploaded in "
              f"{time.time() - t0:.2f} s")
    first_batches = {k: next(iter(dev.DeviceEpochLoader(v.store, 8, 4096, seed=0)))
                     for k, v in loaders.items()}
    for a, b in zip(first_batches["flat"], first_batches["compact"]):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError("the first batch of the flat and the compact store differ")
    print("first batch of the flat and the compact store from one seed: bit-identical")
    for layout, loader in loaders.items():
        store = loader.store
        order, gen = loader._epoch_start()
        sample = lambda: store.sample(order, 0, gen, 8, 4096)  # noqa: E731
        ms = timed(sample, 50)
        us = kernel_device_us(sample, "gather_rows_flat_kernel")
        print(f"{layout} store: {ms:.4f} ms a sampled batch (CUDA events, 8 x 4096 points), "
              f"{us:.1f} us of it in the flat-gather kernel (profiler)")

    # scan_epoch against iterating the loader: same batches, same first loss
    weights = {k: v.clone() for k, v in pp_state.model.state_dict().items()}
    store = loaders["flat"].store
    seen = {"iter": [], "scan": []}
    sample_from = store.sample_from

    def recording(into):
        def wrapped(ids, u):
            batch = sample_from(ids, u)
            into.append(torch.stack([batch[0].double().sum(), batch[1].double().sum(),
                                     batch[2].double().sum()]))
            return batch
        return wrapped

    def iterated():
        run = fresh_state(weights, device, learning_rate=1e-5)
        return torch.stack([train_step(run, *b)["loss"]
                            for b in dev.DeviceEpochLoader(store, 8, 4096, seed=3)])

    try:
        store.sample_from = recording(seen["iter"])
        iter_losses = iterated()
        store.sample_from = recording([])
        again = iterated().tolist()  # the same epoch once more: the drift of the atomic adds
        store.sample_from = recording(seen["scan"])
        run = fresh_state(weights, device, learning_rate=1e-5)
        run, ms = dev.DeviceEpochLoader(store, 8, 4096, seed=3).scan_epoch(run, 4)
    finally:
        del store.sample_from
    same = torch.equal(torch.stack(seen["iter"]), torch.stack(seen["scan"]))
    a, b = ms["loss"].tolist(), iter_losses.tolist()
    print(f"scan_epoch(4) losses {a}\niterated losses     {b}\niterated once more  {again}")
    if not same or len(a) != len(b) or run.step != len(b):
        raise AssertionError("scan_epoch(4) saw other batches than iterating the loader")
    drift = 0.0
    for step, (x, y, z) in enumerate(zip(a, b, again)):
        drift = max(drift, abs(z - y) / abs(y))
        rel = 1e-6 if step == 0 else max(1e-3, 4 * drift)
        if not math.isfinite(x) or abs(x - y) > rel * abs(y):
            raise AssertionError(f"scan_epoch step {step}: loss {x} against {y} (rel {rel:.3g}; "
                                 f"two iterated runs drift by {drift:.3g})")
    print(f"scan_epoch(4) against iterating at learning rate 1e-5: first loss to 1e-6, the "
          f"others to 1e-3; two iterated runs of the epoch drift by {drift:.3g} relative at most")

    # PointNet++ fed by the host loader and by the device store, in turns
    host_loader, _ = create_block_dataloaders(f"{workdir}/data", {6}, 8, 2, 4096, seed=0,
                                              num_workers=4)
    feeds = {"host loader": host_loader,
             "device store (flat)": dev.DeviceEpochLoader(loaders["flat"].store, 8, 4096),
             "device store (compact)": dev.DeviceEpochLoader(loaders["compact"].store, 8, 4096)}
    run = fresh_state(weights, device)

    def epoch(feed):
        n = 0
        for batch in feed:
            train_step(run, *to_device(batch, device))
            n += 1
        torch.cuda.synchronize()
        return n

    for feed in feeds.values():
        epoch(feed)  # warm-up: reader threads, allocator
    wall = {name: [] for name in feeds}
    for name in [*feeds, *reversed(feeds)]:
        t0 = time.time()
        n = epoch(feeds[name])
        wall[name].append((time.time() - t0) * 1e3 / n)
    for name, feed in feeds.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            n = epoch(feed)
        # rows of the device's own type are kernels and copies; an
        # operator's row repeats the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy = sum(device_time_us(e) for e in events) / 1e3 / n
        copies = sum(device_time_us(e) for e in events if "Memcpy HtoD" in e.key) / 1e3 / n
        step_ms = sum(wall[name]) / len(wall[name])
        print(f"PointNet++ fed by the {name}: {step_ms:.3f} ms a step over an epoch of {n} "
              f"(host clock, runs {[round(w, 3) for w in wall[name]]}), device time "
              f"{busy:.3f} ms a step (profiler; host-to-device copies {copies:.3f} ms), "
              f"device busy {100 * busy / step_ms:.1f}%")
    return flat_launches["gather_rows_flat"]


def cpu_copy(model_name: str, model, **kwargs):
    from pointseg_torch.models import create_model

    twin = create_model(model_name, **kwargs).eval()
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


def forward_with_graphs(model, x, graphs=None):
    """Eval forward of a DGCNN that records the graph each EdgeConv builds,
    or, with `graphs`, runs on those instead; returns (logits, graphs)."""
    from pointseg_torch import ops

    used = []

    def pre_hook(module, args, kwargs):
        if graphs is not None:
            idx = graphs[len(used)].to(args[0].device)
        else:
            idx = ops.knn_indices(args[0], module.k, select=module.knn_select)
        used.append(idx)
        return args, {**kwargs, "idx": idx}

    handles = [conv.register_forward_pre_hook(pre_hook, with_kwargs=True)
               for conv in (model.conv1, model.conv2, model.conv3, model.conv4)]
    try:
        return model(x), used
    finally:
        for handle in handles:
            handle.remove()


def check_logits(label: str, got, want) -> None:
    if got.shape != (2, 4096, 14) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits, shape {tuple(got.shape)}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"{label} eval logits card vs CPU: max |diff| {float((got - want).abs().max()):.3g}")


def output_phase(states: dict, batch) -> None:
    x = batch[0][:2]
    with torch.no_grad():
        for name in ("PointNet++", "PointNeXt", "PointNet++MSG"):
            model = states[name][0].model.eval()
            check_logits(name, model(x).cpu(), cpu_copy(name, model)(x.cpu()))

        model = states["DeepGraphCnn"][0].model.eval()
        twin = cpu_copy("DeepGraphCnn", model)
        got = model(x)
        recorded, card_graphs = forward_with_graphs(model, x)
        if not torch.equal(recorded, got):
            raise AssertionError("recording the graphs changed the card's logits")
        got = got.cpu()
        own, cpu_graphs = forward_with_graphs(twin, x.cpu())
        slots = [int((a.cpu() != b).sum()) for a, b in zip(card_graphs, cpu_graphs)]
        moved = ((got - own).abs() > 1e-4 + 1e-4 * own.abs()).any(dim=-1)
        print(f"DeepGraphCnn dynamic graph, the CPU building its own graphs: graph slots that "
              f"differ per layer {slots} of {card_graphs[0].numel()}; {int(moved.sum())} of "
              f"{moved.numel()} points moved beyond 1e-4 (max |diff| "
              f"{float((got - own).abs().max()):.3g})")
        if slots[0]:
            raise AssertionError("the xyz graph (conv1) differs between the card and the CPU")
        check_logits("DeepGraphCnn dynamic graph, the card's graphs given to the CPU,", got,
                     forward_with_graphs(twin, x.cpu(), card_graphs)[0])
        model.static_graph = True
        try:
            got = model(x).cpu()
        finally:
            model.static_graph = False
        check_logits("DeepGraphCnn static graph", got,
                     cpu_copy("DeepGraphCnn", model, static_graph=True)(x.cpu()))


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
    print(f"built {lib} from {len(_kernels.SOURCES)} sources in {time.time() - t0:.1f} s")

    phase("3. kernels against their plain versions")
    record = Record()
    levels = pointnetpp_kernels(device, record)
    ball_query_2l_kernels(device, record, levels)
    del levels
    knn_kernels(device, record)
    gather_kernels(device, record)
    gather_flat_kernels(device, record, seed=7)
    torch.cuda.empty_cache()
    launch_path_split(device)
    gather_call_split(device)
    sa_grouping_forms(device)
    streams_and_graphs(device)

    phase("4. trainers")
    workdir = tempfile.mkdtemp(prefix="pointseg_smoke_")
    try:
        states, launches, batch = trainer_phase(device, workdir)
        phase("5. output against the CPU")
        output_phase(states, batch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = record.rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
            "library_ms": r["library_ms"]})
    print()
    for model_name, (_, perf) in states.items():
        print(f"summary: {smi}; {model_name} step {perf['step_ms']:.3f} ms, "
              f"{perf['points_per_s']:.0f} points/s, peak {perf['peak_bytes'] / 2**20:.1f} MiB")
    print(f"summary: {smi}; kernel, plain, library and bound ms are per forward pass of the "
          f"kernel's training path (its shapes summed; ball_query_2l: PointNeXt's nine "
          f"queries); launches are one epoch and its "
          f"evaluation (knn_2l and ball_query_2l: DeepGraphCnn and PointNeXt with "
          f"POINTSEG_SELECT2L=1; gather_rows_flat: one PointNet++ epoch from the flat device store, two "
          f"launches a step, its ms the 36-byte and the 1-byte gather of a batch from "
          f"{SYNTHETIC_ROWS} rows); tie flips "
          f"{({k: r['flips'] for k, r in record.rows.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
