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
     equal and 3-NN distances equal to rtol 1e-5 / atol 1e-6.
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
     kernels must equal the plain version slot for slot.
   - the row gather at the EdgeConv shapes (8, 4096, 64 and 128) x
     81,920 rows and at every table PointNet++ gathers from in a step
     (centroid coordinates, the SA tables of odd width h + 3, the FP
     interpolation sources): forward bit-equal to `torch.gather`;
     backward (`index_add_`) equal to autograd of the plain version to
     rtol/atol 1e-4 (both add with atomics). Its `max_abs_err` is the
     larger of the forward's (0 when bit-equal) and the backward's.
   An index may differ from the plain version's only where the float64
   squared distances of the two picks differ by less than 1e-6 (counted
   and printed as tie flips). Each version is timed with CUDA events, in
   the order plain, kernel, kernel, plain; then one PyTorch library
   formulation of the same function is timed as a yardstick (bmm + topk
   for 3-NN and kNN, `torch.gather` for the gather; FPS and the ball
   queries have none). The port never calls these. Each kernel's bound is the
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
   PointNeXt-L give its step time and peak memory. For DeepGraphCnn three steps of DeepGraphCnn with
   `knn_select="two_level"` and three with "flat", from the same weights,
   batch and dropout seed: knn_2l must launch, the first losses must
   agree to 1e-6 relative (same forward) and the later ones to 1e-3 (the
   gather's backward adds with atomics). For each model the steady-state
   step time (CUDA events), points/s, peak memory, a profile and the
   device time per step of each of the port's own kernels; for
   DeepGraphCnn also the step time and peak memory with
   `EdgeConv.remat`, which gathers again in the backward pass.
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
import re
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
}


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


def kernel_device_us(fn, kernel: str, reps: int = 10) -> float:
    """Mean device microseconds per call of `fn` inside kernels whose name
    contains `kernel`, from the profiler: unlike CUDA events around a loop
    of launches it holds none of the host's gaps between them. A trace
    that comes back without the kernel is taken once more; NaN (printed as
    such, and so marking every sum it enters) if that one lacks it too."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(device_time_us(e) for e in prof.key_averages() if kernel in e.key)
        if total > 0:
            return total / reps
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
        (activations(rng, 2, 16384, 64), "eval bucket", 0, 2, 1),
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
        for name, select in (("knn", "flat"), ("knn_2l", "two_level")):
            ms, plain_ms = timed_pair(lambda: knn_indices(x, k, select=select),
                                      lambda: knn_indices_plain(x, k), reps, plain_reps)
            record.note(name, (B, N, F, what), ms, plain_ms, lib_ms, flops, nbytes,
                        flips, err, per_forward)


def check_knn_options(x, k: int) -> None:
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
                raise AssertionError(f"kNN {select} with {sorted(kwargs)}: "
                                     f"{int((got != want).sum())} slots differ from plain")
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


def train_through_cli(model_name: str, workdir: str, needed: tuple[str, ...]):
    """One epoch and its evaluation through the CLI; returns (state,
    launches). Raises unless every kernel in `needed` was launched."""
    from pointseg_torch import cli

    argv = ["train", model_name, "--synthetic", "--data-dir", f"{workdir}/data",
            "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "4096",
            "--device", "cuda", "--log-dir", f"{workdir}/logs"]
    args = cli.build_parser().parse_args(argv)
    zero_launches()
    t0 = time.time()
    state, records = cli.train_from_args(args)
    launches = read_launches()
    print(f"{model_name}: {time.time() - t0:.1f} s for one epoch ({state.step} steps) and its "
          f"evaluation; launches {launches}")
    if not all(math.isfinite(v) for v in records["train_loss"] + records["val_loss"]):
        raise AssertionError(f"non-finite loss: {records}")
    off_card = [k for k, p in state.model.named_parameters() if p.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"parameters off the card: {off_card}")
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by train {model_name}: {missing}")
    return state, launches


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

    pp_state, pp_launches = train_through_cli("PointNet++", workdir,
                                              ("fps", "ball_query", "three_nn", "gather_rows"))
    if pp_launches["knn"] or pp_launches["knn_2l"] or pp_launches["ball_query_2l"]:
        raise AssertionError(f"PointNet++ launched kernels off its path: {pp_launches}")
    train_loader, _ = create_block_dataloaders(f"{workdir}/data", {6}, 8, 2, 4096, seed=1)
    batch = to_device(next(iter(train_loader)), device)
    pp_perf = steady_state(pp_state, batch, "PointNet++")

    dg_state, dg_launches = train_through_cli("DeepGraphCnn", workdir, ("knn", "gather_rows"))
    steps = dg_state.step
    if dg_launches["knn"] < 4 * steps or dg_launches["gather_rows"] < 4 * steps:
        raise AssertionError(f"DeepGraphCnn: {steps} steps need at least {4 * steps} kNN and "
                             f"gather launches, got {dg_launches}")
    if dg_launches["knn_2l"] or dg_launches["fps"] or dg_launches["ball_query_2l"]:
        raise AssertionError(f"DeepGraphCnn launched kernels off its path: {dg_launches}")
    knn_2l_launches = two_level_against_flat("DeepGraphCnn", "knn_select", "knn", "knn_2l", 4,
                                             dg_state, batch, device)
    dg_perf = steady_state(dg_state, batch, "DeepGraphCnn")
    remat_cost(dg_state, batch, device)
    states = {"PointNet++": (pp_state, pp_perf), "DeepGraphCnn": (dg_state, dg_perf)}

    # per forward pass (a train step or an eval batch): fps, ball_query, three_nn
    bq_2l_launches = {}
    for name, per_forward in (("PointNeXt", (4, 9, 4)), ("PointNet++MSG", (4, 8, 4))):
        state, got = train_through_cli(name, workdir,
                                       ("fps", "ball_query", "three_nn", "gather_rows"))
        forwards = got["fps"] // per_forward[0]
        want = {"fps": per_forward[0] * forwards, "ball_query": per_forward[1] * forwards,
                "three_nn": per_forward[2] * forwards, "ball_query_2l": 0, "knn": 0, "knn_2l": 0}
        if forwards <= state.step or any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: {state.step} steps and their evaluation must launch "
                                 f"{per_forward} (fps, ball_query, three_nn) per forward pass "
                                 f"and no other selection kernel, got {got}")
        bq_2l_launches[name] = two_level_against_flat(
            name, "ball_select", "ball_query", "ball_query_2l", per_forward[1], state, batch,
            device)
        states[name] = (state, steady_state(state, batch, name))
    few_steps("PointNeXt-L", batch, device)

    launches = {"fps": pp_launches["fps"], "ball_query": pp_launches["ball_query"],
                "ball_query_2l": bq_2l_launches["PointNeXt"]["ball_query_2l"],
                "three_nn": pp_launches["three_nn"], "knn": dg_launches["knn"],
                "knn_2l": knn_2l_launches["knn_2l"],
                "gather_rows": dg_launches["gather_rows"]}
    return states, launches, batch


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
    torch.cuda.empty_cache()

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
          f"evaluation (knn_2l and ball_query_2l: three steps of DeepGraphCnn and of "
          f"PointNeXt); tie flips "
          f"{({k: r['flips'] for k, r in record.rows.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
