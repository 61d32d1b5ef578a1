#!/usr/bin/env python3
"""Smoke run of pointseg_torch on one CUDA card: every kernel against its
plain PyTorch version, and every entry point of the port on the card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero. The
bounds printed beside the kernels' times are the benchmark's: the peaks
of `portbench/work.py` and each op's operations and bytes from its
module in `portbench/opwork/` (a row with no such module says why it
counts its own).

1. Device: a CUDA device must be present; prints the torch and CUDA
   versions and `nvidia-smi --query-gpu=name,power.limit`.
2. Build: compiles the CUDA kernels from `pointseg_torch/csrc/` (one
   nvcc per source, all at once).
3. Kernels, each against its plain PyTorch version on the card:
   - FPS, ball query and 3-NN at the PointNet++ training shapes (B=8,
     N=4096 -> 1024 -> 256 -> 64 -> 16), a ragged shape with repeated
     points and a large evaluation shape (3-NN there too). Indices and `in_ball` must be
     equal and 3-NN distances equal to rtol 1e-5 / atol 1e-6. FPS also
     gives its device time a launch (profiler) and the kernel instance
     that ran at each shape; at the four SA stages the register path at
     each block size (32 to 1024 threads), equal to the plain version,
     and the row's latency floor (every step of the four stages at the
     per-step time of the same kernel with one point a thread); at (2,
     16384, 1024) the register path (16 points a thread) against the
     default kernel.
   - the flat ball query (kernel 2) and 3-NN (kernel 3) at every shape of
     PointNet++ SSG (four SA and four FP stages), MSG (eight queries) and
     PointNeXt (nine), and at the evaluation buckets (N = 16384 and 65536;
     r = 0.8 at 65536, a ball of thousands of members): equal to the plain
     version (the ball query raw and with the repeat filler, 3-NN indices
     and distance bits), device us a launch (profiler) beside the
     exact-arithmetic floor (9 rounded FP instructions a pair over 132 SMs
     x 128 lanes at the boost clock), and each model's row of launches
     under CUDA events; every split of the two kernels (centroids or
     targets a warp, warps a block, warps a centroid) at the training
     stages and the buckets, equal to plain, device us a launch; and that
     `ball_query(filler="repeat")` runs one device kernel.
   - the two-level ball query (kernel 6), which the shape rule runs only
     past K = 32, forced through the private route at every ball-query
     shape of PointNeXt (four SA stages and five InvResMLP blocks, where
     the centroids are the cloud itself) and of PointNet++ MSG at B=8,
     N=4096, at the ragged shape with repeated points (also with a mask
     and at stack depth 1, where every pick refills a lane) and at two
     evaluation shapes (N = 16384 and 65536): equal to the plain version
     and to the flat kernel, index for index and `in_ball` for `in_ball`;
     both kernels' device time a launch (profiler, in turns). Then K = 48
     and 64 at SA1 and at (2, 1024, 16384), where the shape rule runs
     kernel 6: one launch of it, equal to the plain version raw and with
     the repeat filler, with a mask and at depth 1; and every split of
     kernel 6 in BALL_2L_SPLITS at SA1, PointNeXt's first InvResMLP query
     and the buckets, equal to plain, device us a launch.
   - kNN, flat and two-level (kernel 5 forced through the private route),
     at the DGCNN EdgeConv shapes (8, 4096, 3) and (8, 4096, 64)
     (LeakyReLU'd normal features), a cloud with repeated points and (2,
     16384, 64); the two kernels must also equal each other. On the cloud
     with repeated points also with a mask, without the point itself, and
     both (ragged evaluation), where the kernels must equal the plain
     version slot for slot. Beside the CUDA-event time of each shape: both
     kernels' device time per launch from the profiler, and the flat
     kernel's floor (its arithmetic is exact, so a product costs two
     float32 instructions, not one fused one: twice the operation bound).
     Then 19 small shapes that the flat kernel's tiles can get wrong (N =
     37, 4099, 1100; F = 1 to 132 on the 16-byte and the 4-byte path; k =
     1 and 32; one cloud; a view that is not 16-byte aligned), each with
     and without the mask and the point itself, flat and two-level equal
     to plain slot for slot. Then k = 33, 48 and 64 at (8, 4096, 64) and F
     = 640 and 1024 at (2, 4096, F), where the shape rule runs kernel 5:
     one launch of it, equal to plain with and without the mask and the
     point itself and at depth 1, device us beside the bound and the
     floor.
   - the row gather at the EdgeConv shapes (8, 4096, 64 and 128) x
     81,920 rows and at the tables of a PointNet++ step (centroid
     coordinates, the FP interpolation sources, and the concatenated SA
     tables of odd width h + 3 that the JAX package gathers from):
     forward bit-equal to `torch.gather`; backward (`index_add_`) equal
     to autograd of the plain version to rtol/atol 1e-4 (both add with
     atomics). Its `max_abs_err` is the larger of the forward's (0 when
     bit-equal) and the backward's; its times and bound are PointNet++'s
     twelve gathers (the EdgeConv shapes are checked only: DGCNN's
     forward reduces them in edge_reduce).
   - EdgeConv's gather-reduce (kernel 9) at (8, 4096, k 20, C 64), three
     times a DGCNN forward, and C 128 once, ties forced, against
     `edge_reduce_plain`: max and min bit-equal, tie counts exact, the
     sums and the gradient (autograd of the plain composition) within
     1e-5 of their largest; the forward and the backward kernel timed
     against the plain forward and backward, beside their bytes bound,
     with device us a launch (profiler). Then PointNeXt-XL's 19
     groupings a forward at B 32 x 4,096 (eight shapes: each stage's set
     abstraction and its InvResMLPs, rows 128 to 1024 wide, K 32, the
     last level's 16 points under balls of 32): each ball query one
     launch, equal to the plain version with the repeat fill up to
     float64-verified ties, the slots of a ball past its level's points
     slot 0 as non-members; each gather one launch, rows bit-equal to
     `torch.gather`'s and the feature gradient within 1e-5 of its largest
     from a float64 `torch.gather` gradient.
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
   once, outputs written once) over the peak bandwidth and its float32
   operations over the peak float32 rate.
4. Trainers, through `pointseg_torch.cli` at the reference configuration
   (batch 8 x 4096 points x 9 features, 14 classes, Adam 1e-3) on a
   synthetic S3DIS-shaped block dataset, one epoch (12 steps) and its
   evaluation pass each, with the launch counters set to 0 just before
   and read just after: `train PointNet++` must launch fps, ball_query
   and three_nn 4 times each per forward pass; `train PointNet` none of
   the port's kernels; `train DeepGraphCnn` must launch knn (4 per step)
   and edge_reduce (4 + 4 per step), and no gather_rows; `train PointNeXt`
   must launch fps 4, ball_query 9 and three_nn 4 times per forward pass
   and `train PointNet++MSG` 4, 8 and 4 times, and neither a two-level
   kernel. Three steps of PointNeXt-L give its step time and peak memory.
   The train steps replay a CUDA graph after their state's first two
   (eager, then captured), so every count a step here is over the steps
   that launched from Python (`train/state.py::STEP_GRAPHS`,
   `launched_steps`). One PointNeXt-XL train step at B 32 x 4,096, the
   captured one, the counters set to 0 just before it, must launch fps
   4, ball_query 19, three_nn 4 and gather_rows 27 times and nothing
   else; three replayed ones give its step time and peak memory, and
   three more replayed steps against three eager steps of a copy of the
   state must be counted as replays, with the first loss bit-equal and
   the others within 1e-5. For each model the steady-state step time
   (CUDA events), points/s, peak memory, a profile and the device time
   per step of each of the port's own kernels.
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
   edge_reduce and the flat gather). The first batch of the two stores
   from one seed must be bit-identical, and `scan_epoch(4)` must see the same batches as
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
   PointNet, PointNeXt, PointNet++MSG). For DGCNN that
   holds under `static_graph=True` and, with the dynamic graph, when the
   CPU model is given the four graphs the card built. Left to build its
   own, the CPU can flip a neighbour in conv2-4, which select on
   activations that its matmuls round another way, and a flip moves a
   point's logits far beyond any tolerance: the differing graph slots
   per layer and the points that moved beyond 1e-4 are counted and
   printed, not bounded.
6. Checkpoint, resume and evaluate, through `pointseg_torch.cli` with the
   plain versions of the kernels made to raise on a tensor on the card:
   `train PointNet++ --model-dir D --lr-schedule warmup_cosine
   --warmup-steps 4 --grad-clip 1.0` one epoch, then `--resume` from its
   checkpoint one more (the checkpoint must hold twice the steps of an
   epoch); a fresh state on the card restored from that checkpoint must
   equal the resumed one bit for bit (every parameter and BatchNorm
   buffer, the Adam moments and counts, the step, the FPS generator) and
   give bit-equal eval logits. `evaluate` on blocks: a synthetic area 6
   of 3 m x 3 m rooms of 140,000 and 500,000 points, whose 1 m blocks
   fill the 16384 and 65536 buckets (blocks and batches per bucket
   printed), for that PointNet++ checkpoint, for phase 4's DeepGraphCnn
   saved as one and for phase 4's PointNet with running and with batch
   statistics (`--bn-stats batch`): fps, ball_query, three_nn and
   gather_rows must launch for PointNet++, knn and edge_reduce for
   DeepGraphCnn, none of the port's kernels for PointNet; one batch of the 16384 bucket on
   the card against the CPU. `evaluate --whole-rooms` with `--stream
   device` and `--stream host` over a synthetic area 6 of four rooms of
   1,000,000 points (fps and three_nn four times a forward: one a group
   of 8 windows, or one a window); the two streams' averaged logits per
   point (their predictions may differ only where the top two lie within
   1e-4); one room of 20,000 points on the card against the CPU. Card
   against CPU: logits within rtol/atol 1e-4, predictions equal outside
   near-ties. Each `evaluate` prints points/s and ms a block batch or a
   room under CUDA events over the whole call, peak allocated memory,
   the launches of each kernel and the metrics.
7. Measurement commands: `benchmark` through `cli.main` for every
   registry model in train and inference mode at B=8, N=4096, 20 runs
   after 3 warm-up calls (the subcommand's own input: N(0, 1) points,
   random one-hot labels), each JSON line printed with the launches of
   each kernel a call (the model's path kernels the same count every
   call, no other); `python -m pointseg_torch benchmark` with its
   defaults and `python -m pointseg_torch doctor` (exit 0, the card
   named, the kernels built and loaded) as a user starts them; `train
   PointNet++ --profile DIR` one epoch, whose Chrome trace must name the
   port's FPS, ball-query, 3-NN and gather kernels.
8. bf16 (`--bf16`): kernel 7 on bf16 rows at every SA grouping of
   PointNet++, MSG and PointNeXt and DGCNN's two EdgeConv gathers, with
   and without the float32 coordinate table: rows bit-equal to
   `torch.gather`, the backward within one bf16 rounding of a float64
   sum, kernel ms beside its bound (bytes / 3.35 TB/s) and
   `torch.gather`'s; `train --bf16` one epoch through the CLI for
   PointNet++, DeepGraphCnn, PointNeXt and PointNet (the sidecar says
   bf16, parameters float32, the launches equal the float32 epoch's of
   phase 4, one batch's loss from the trained weights within 2e-2 of
   the float32 loss of the same weights and batch); `evaluate` of the bf16
   PointNet++ checkpoint with no flag (bf16 from its sidecar) on the
   phase 6 blocks and whole rooms, both streams; `benchmark --bf16` for
   every registry model in both modes; bf16 eval logits of PointNet++,
   PointNet and DeepGraphCnn (static graph) on the card against the CPU,
   within 2e-2 of the largest logit; one PointNet train step at B = 1
   (ROADMAP F8), and the training BatchNorm at PointNet's (32768, 1024)
   rows with a mean 300 times the spread against float64 beside
   `F.batch_norm(training=True)`'s (F6).
9. The remaining entry points: FPS with more centroids than points ((2,
   1000) -> 1024, (8, 100) -> 128) and kernel 5 at the enhanced trainer's
   k = 40 ((2, 8192, 3) and (2, 8192, 64); device us beside the bound)
   against their plain versions; `train-legacy PointNet++` at its
   defaults (cut 1000, batch 2, 13 classes, SA1 at C = 1024 > N = 1000)
   one epoch on synthetic chunked rooms of 20,000 points (kernels 1, 2, 3
   and 7 launch; ms a step; card against CPU logits at rtol/atol 1e-4);
   `create_dgcnn_trainer` at its reference defaults (k = 40, emb 1024,
   cut 8192, sampling 0.5, batch 2) one epoch on the same rooms (kernel 5
   and edge_reduce launch, the flat kNN never: the record's knn_2l
   launches are this epoch's; ms a step, peak MiB,
   `format_memory_usage()`); `export` of PointNet++, DeepGraphCnn and
   PointNet at (1, 4096, 9) through the CLI (the graph's operators, the
   loaded artifact launching the kernels, its logits equal to the eager
   model's for two checkpoints, its size and forward ms against eager);
   `import-torch` of a reference-layout `.pt`, then `evaluate` of it;
   `prepare --stage all` on a small raw tree; a real
   `torch.cuda.OutOfMemoryError` through `is_oom_error`. Each path
   runs with the launch counts set to 0 before it and read after it. The
   script's whole time is printed before the two JSON lines.

10. Data parallel (`train --data-parallel`, `pointseg_torch/parallel/`),
   each path with the launch counts set to 0 before it and read after it:
   (a) `train PointNet++ --data-parallel` one epoch through the CLI on
   the one card (world size 1, in this process), in turns with the run
   without the flag (no flag, flag, flag, no flag), same seed, the host
   loader in one thread (reader threads draw each block's points in the
   order they arrive, so runs differ in their batches): the first
   step's loss equal within 1e-6, the epoch losses printed (atomics part
   two epochs by 1-6%), step ms and device ms of both states' steps
   (with two or more cards only the run without the flag, for (e)); (b)
   two ranks on the one card (gloo: NCCL refuses two ranks on a device),
   4 rows a rank, against the one-process step at B = 8 from the same
   weights and batch, for PointNet++, PointNet and DeepGraphCnn: one SGD
   step in float64 (loss within 1e-6 relative, parameters within 1e-9)
   and in float32 (loss within 5e-4, each parameter within 2e-5 plus
   twice its float32-to-float64 distance in the one-process step), FPS
   picks equal, the ranks bit-equal after three Adam steps, each rank's
   launches those of its model's path; step ms, device ms and peak MiB
   of a rank beside the one-process step's; (c) (b) again on two cards
   with NCCL where there are two, else a line that it was not run; (d)
   whole-room streaming of PointNet++ (a room of 20,000 points, window
   4096) with each group's windows shared by two ranks, against
   unsharded, running and batch statistics: equal predictions; (e) the
   entry point on several ranks: `train PointNet++ --data-parallel` one
   epoch as in (a), started by `cli.spawn_training` on two ranks sharing
   the card (gloo), or one rank a card (NCCL) where there are two or
   more: each rank launches its path's kernels, rank 0's first-step loss
   within 1e-5 of (a)'s run without the flag, one log directory and one
   checkpoint, which one process restores bit for bit. Each run of ranks
   has a deadline.

11. Placements (M10: `pointseg_torch/parallel/`'s two-axis mesh, tensor
   parallelism, the point-sharded forward and the row-sharded store, and
   `pointseg_torch/multichip.py`), four ranks (`parallel.spawn`: gloo
   sharing the one card, or one NCCL rank a card on four), each job's
   launch counts set to 0 before it and read after it in every rank: (a)
   a (data, model) = (2, 2) mesh's SGD step (`shard_state_tp`) of
   PointNet++ and DeepGraphCnn (k = 20, emb 1024) on phase 4's batch
   against the one-process step from the same weights and seeds: in
   float64 every gathered parameter within 1e-12, in float32 within 2e-5
   plus twice the leaf's float32-to-float64 distance, the sharded
   fraction equal to the JAX package's (constants below), each rank
   launching its model's kernels; a rank's step ms, device ms,
   collectives a step and the host ms they hold, peak MiB and launches
   beside the one-process step's; (b) the point-sharded PointNet++ eval
   forward of one 65,536-point cloud, a quarter a rank, against the
   unsharded forward: every FPS, ball-query and 3-NN selection equal,
   logits within 2e-4; (c) the compact store of the synthetic training
   blocks row-sharded over the four ranks: every batch bit-equal to the
   unsharded store's, kernel 8 once a batch a rank; and one of
   273,000,000 rows made on the card from a seed: ms a sampled batch
   sharded against unsharded, each rank's resident bytes; (d)
   `dryrun_multichip(4)` through its own ranks, its summary line printed.

The next-to-last line of output is the kernels' JSON record; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import glob
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import harness
from portbench.work import PEAK_BYTES_PER_S, PEAK_F32_FLOPS

SLICE_FPS = [(8, 4096, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16)]
FPS_THREADS = (32, 64, 128, 256, 512, 1024)  # the register path's block sizes
RADII = {4096: 0.1, 1024: 0.2, 256: 0.4, 64: 0.8}
TIE_M2 = 1e-6  # an index may differ where the two picks' d^2 differ by less
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
    # on DGCNN's path kernel 7's gather, with EdgeConv's four reductions fused in
    "edge_reduce": ("pointseg_torch/csrc/edgereduce.cu", "pointseg/ops/pallas/gather.py:111"),
}
S3DIS_ROWS = 273_000_000  # points in all of S3DIS
SYNTHETIC_ROWS = 240_000  # points in the --synthetic dataset
SAMPLED_ROWS = 8 * 4096  # rows one training batch gathers


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def opwork(op: str, *args) -> tuple[float, float]:
    """(operations, bytes) of one call of `pointseg_torch.ops.<op>` with
    the positional `args`, by the benchmark's count
    (`portbench/opwork/<op>.py`): tensors as (shape, itemsize), integers
    and booleans as they are, floats left out, as its traced run sees
    them."""
    shapes = [(tuple(a.shape), a.element_size()) if isinstance(a, torch.Tensor) else a
              for a in args if isinstance(a, (torch.Tensor, int))]
    return harness.op_module(op).work(shapes)


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
    calls, is taken again, up to four times; NaN (printed as such, and so
    marking every sum it enters) if the last one is short too."""
    fn()  # warm-up
    for _ in range(4):
        rows = [e for e in profiled(fn, reps) if kernel in e.key]
        # a trace can come back a launch short: then it is taken again
        if rows and sum(e.count for e in rows) % reps == 0:
            return sum(device_time_us(e) for e in rows) / reps
    return float("nan")


def device_us_in_turns(first_fn, first_kernel: str, second_fn, second_kernel: str,
                       reps: int = 10) -> tuple[float, float]:
    """Device us a launch of two kernels (profiler), in turns: first,
    second, second, first; each the mean of its two readings."""
    a1 = kernel_device_us(first_fn, first_kernel, reps)
    b1 = kernel_device_us(second_fn, second_kernel, reps)
    b2 = kernel_device_us(second_fn, second_kernel, reps)
    a2 = kernel_device_us(first_fn, first_kernel, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


class Record:
    """Per kernel: times summed over the shapes of one forward pass of
    its training path, the bound for the same work, the worst error."""

    def __init__(self):
        self.rows = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "ops_ms": 0.0,
                            "bytes_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "flips": 0}
                     for name in KERNELS}

    def note(self, name, shape, ms, plain_ms, library_ms, work, flips, err, per_forward: int):
        """`work`: (operations, bytes) of one call; `per_forward`: how often
        one forward pass runs this shape (0: the shape is checked and
        printed only)."""
        flops, nbytes = work
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
        record.note("fps", (B, N, C), ms, plain_ms, None,
                    opwork("farthest_point_sampling", pts, C), flips, err, per_forward)
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
        record.note("ball_query", (B, C, N, r), ms, plain_ms, None,
                    opwork("ball_query", cents, pts, r, 32), flips, err, per_forward)
        print(f"{'':11s} share of in-ball slots {float(g_in.float().mean()):.3f}")

        if N <= 16384:  # 3-NN upsamples each stage's centroids back onto its input
            g_d, g_i = three_nn(pts, cents)
            w_d, w_i = three_nn_plain(pts, cents)
            torch.testing.assert_close(g_d, w_d, rtol=1e-5, atol=1e-6)
            flips, _ = check_picks(pts, cents, g_i, w_i)
            err = float((g_d.double() - w_d.double()).abs().max())
            ms, plain_ms = timed_pair(lambda: three_nn(pts, cents),
                                      lambda: three_nn_plain(pts, cents), 20)
            lib_ms = timed(lambda: three_nn_library(pts, cents), 20)
            # no module of portbench/opwork/ counts three_nn alone (its
            # `interpolate` adds the weighted sum): distances, then (d2, idx) out
            record.note("three_nn", (B, N, C), ms, plain_ms, lib_ms,
                        (10.0 * B * N * C, 12 * B * N + 12 * B * C + 24 * B * N), flips, err,
                        per_forward)
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
    """Kernel 6, forced at K <= 32 through the private route, against the
    plain version and the flat kernel at every ball query of PointNeXt and
    MSG, the ragged shape (also with a mask and at depth 1) and the
    evaluation buckets. Its record row sums PointNeXt's nine queries; each
    shape prints both kernels' device time a launch (profiler, in turns)."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.ballquery import (_ball_query_cuda, _radius_sq, _select,
                                              ball_query_plain, ball_query_raw)

    def two_level(cents, pts, r, K, mask=None):
        return _select(cents, pts, r, K, mask, "two_level", False)

    def check(cents, pts, r, K, what, depth=None, mask=None):
        before = dict(_kernels.LAUNCHES)
        if depth is None:
            g_idx, g_in = two_level(cents, pts, r, K, mask)
        else:
            g_idx, g_in = _ball_query_cuda(cents, pts, _radius_sq(r), K, mask, "two_level", depth)
        if (_kernels.LAUNCHES["ball_query_2l"] != before["ball_query_2l"] + 1
                or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
            raise AssertionError(f"two-level ball query {what}: not exactly one launch of its "
                                 f"kernel ({before} -> {_kernels.LAUNCHES})")
        f_idx, f_in = ball_query_raw(cents, pts, r, K, mask=mask)
        w_idx, w_in = ball_query_plain(cents, pts, r, K, mask=mask)
        torch.cuda.synchronize()
        if not (torch.equal(g_idx, f_idx) and torch.equal(g_in, f_in)):
            raise AssertionError(f"ball query {what}: two-level and flat differ at "
                                 f"{int((g_idx != f_idx).sum())} slots")
        if not torch.equal(g_in, w_in):
            raise AssertionError(f"two-level ball query {what}: in_ball differs from plain")
        return (*check_picks(cents, pts, g_idx, w_idx), float(g_in.float().mean()))

    rng = np.random.default_rng(5)
    extra = [  # (B, N, C, repeat_from, radius, K, kernel reps)
        (8, 3000, 1000, 2300, 0.1, 32, 20), (2, 16384, 1024, 12000, 0.1, 32, 10),
        (1, 65536, 1024, None, 0.1, 32, 5)]
    # (centroids, cloud, radius, K, times per PointNeXt forward, kernel reps)
    cases = [(levels[q[0]], levels[q[1]], q[2], q[3], int(q in POINTNEXT_QUERIES), 20)
             for q in dict.fromkeys(POINTNEXT_QUERIES + MSG_QUERIES)]
    for B, N, C, repeat_from, r, K, reps in extra:
        pts = torch.from_numpy(block_cloud(rng, B, N, repeat_from)).to(device)
        cases.append((pts[:, :C].contiguous(), pts, r, K, 0, reps))
    for cents, pts, r, K, per_forward, reps in cases:
        B, C, N = cents.shape[0], cents.shape[1], pts.shape[1]
        shape = (B, C, N, r, K)
        flips, err, share = check(cents, pts, r, K, shape)
        ms, plain_ms = timed_pair(lambda: two_level(cents, pts, r, K),
                                  lambda: ball_query_plain(cents, pts, r, K), reps,
                                  max(2, reps // 4))
        record.note("ball_query_2l", shape, ms, plain_ms, None,
                    opwork("ball_query", cents, pts, r, K), flips, err, per_forward)
        flat_us, us = device_us_in_turns(
            lambda: ball_query_raw(cents, pts, r, K), "ball_query_kernel",
            lambda: two_level(cents, pts, r, K), "ball_query_two_level_kernel",
            10 if N <= 4096 else 5)
        print(f"{'':11s} device time a launch (profiler, in turns flat, two-level, two-level, "
              f"flat): two-level {us:.1f} us, flat {flat_us:.1f} us ({us / flat_us:.2f}x); "
              f"share of in-ball slots {share:.3f}")
        if N == 3000:  # the ragged shape: a mask, and depth 1 (a refill after every pick)
            mask = torch.rand((B, N), device=device,
                              generator=torch.Generator(device).manual_seed(6)) < 0.7
            mask[0] = False  # a cloud whose balls are all empty
            for depth, m in ((None, mask), (1, None), (1, mask)):
                check(cents, pts, r, K, f"{shape} depth {depth} mask {m is not None}", depth, m)
            print(f"{'':11s} with a mask, at depth 1, and both: two-level equals flat and plain")
    ball_query_2l_past_32(device, levels)
    ball_query_2l_splits(device, levels)


# K past the flat kernel's 32 at SA1 and an evaluation bucket, as (B, N, C,
# radius, K); the splits of kernel 6 swept (centroids a warp, warps a
# block, warps a centroid)
BALL_WIDE_K = [(8, 4096, 1024, 0.1, 48), (8, 4096, 1024, 0.1, 64), (2, 16384, 1024, 0.1, 48),
               (2, 16384, 1024, 0.1, 64)]
BALL_2L_SPLITS = [(1, 8, 1), (2, 8, 1), (2, 16, 1), (1, 16, 1), (1, 8, 2), (1, 8, 4), (2, 8, 2),
                  (2, 8, 4), (2, 16, 4), (2, 8, 8), (1, 16, 8), (2, 16, 8), (1, 16, 16),
                  (2, 16, 16)]


def ball_query_2l_past_32(device, levels) -> None:
    """K = 48 and 64, where the shape rule runs kernel 6: one launch of it,
    equal to the plain version raw and with the repeat filler, with a mask,
    and at depth 1 (a rescan after every pick past a lane's first); device
    us a launch beside the flat kernel at K = 32 and the floor."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.ballquery import (_ball_query_cuda, _radius_sq, ball_query,
                                              ball_query_plain, ball_query_raw)

    rng = np.random.default_rng(18)
    for B, N, C, r, K in BALL_WIDE_K:
        pts = levels[0] if N == 4096 else torch.from_numpy(block_cloud(rng, B, N)).to(device)
        cents = levels[1] if N == 4096 else pts[:, :C].contiguous()
        mask = torch.rand((B, N), device=device,
                          generator=torch.Generator(device).manual_seed(19)) < 0.8
        for m in (None, mask):
            want_idx, want_in = ball_query_plain(cents, pts, r, K, mask=m)
            want_rep = torch.where(want_in, want_idx, want_idx[..., :1])
            for depth in (None, 1):
                for repeat in (False, True):
                    before = dict(_kernels.LAUNCHES)
                    if depth is None:
                        idx, in_ball = ball_query(cents, pts, r, K, mask=m,
                                                  filler="repeat" if repeat else "index")
                    else:
                        idx, in_ball = _ball_query_cuda(cents, pts, _radius_sq(r), K, m, "flat",
                                                        depth, repeat)
                    if (_kernels.LAUNCHES["ball_query_2l"] != before["ball_query_2l"] + 1
                            or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
                        raise AssertionError(f"ball query K={K}: the shape rule must launch the "
                                             f"two-level kernel once")
                    if not (torch.equal(idx, want_rep if repeat else want_idx)
                            and torch.equal(in_ball, want_in)):
                        raise AssertionError(f"ball query {(B, C, N, r, K)} mask "
                                             f"{m is not None} depth {depth} repeat {repeat}: "
                                             f"differs from plain")
        flat_us, us = device_us_in_turns(
            lambda: ball_query_raw(cents, pts, r, 32), "ball_query_kernel",
            lambda: ball_query_raw(cents, pts, r, K), "ball_query_two_level_kernel",
            10 if N <= 4096 else 5)
        print(f"{'':11s} ball_query {(B, C, N, r, K)}: the shape rule runs the two-level kernel, "
              f"equal to plain (raw, repeat, mask, depth 1); {us:.1f} us a launch on the device "
              f"(the flat kernel at K = 32: {flat_us:.1f} us; floor {floor_us(B * C * N):.1f} us)"
              f"; share of in-ball slots {float(want_in.float().mean()):.3f}", flush=True)


def ball_query_2l_splits(device, levels) -> None:
    """Every split of kernel 6 in BALL_2L_SPLITS at the four SA stages,
    PointNeXt's first InvResMLP query and the buckets, each equal to the
    plain version, device us a launch beside its default and the flat
    kernel's."""
    from pointseg_torch.ops.ballquery import (_ball_query_cuda, _radius_sq, ball_query_plain,
                                              ball_query_raw)

    rng = np.random.default_rng(20)
    cases = [("SA1", levels[1], levels[0], 0.1), ("irmlp1", levels[1], levels[1], 0.1),
             ("SA2", levels[2], levels[1], 0.2), ("SA3", levels[3], levels[2], 0.4),
             ("SA4", levels[4], levels[3], 0.8)]
    for B, N, C in ((2, 16384, 1024), (1, 65536, 1024)):
        pts = torch.from_numpy(block_cloud(rng, B, N)).to(device)
        cases.append((f"bucket ({B}, {C}, {N})", pts[:, :C].contiguous(), pts, 0.1))
    for label, cents, pts, r in cases:
        want = ball_query_plain(cents, pts, r, 32)
        reps = 10 if pts.shape[1] <= 4096 else 5
        flat_us = kernel_device_us(lambda: ball_query_raw(cents, pts, r, 32), "ball_query_kernel",
                                   reps)
        times = [f"flat kernel {flat_us:.1f}"]
        for config in ((0, 0, 0), *BALL_2L_SPLITS):
            def call():
                return _ball_query_cuda(cents, pts, _radius_sq(r), 32, None, "two_level", 4,
                                        False, config)
            got = call()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"two-level ball query {label} split {config} differs")
            us = kernel_device_us(call, "ball_query_two_level_kernel", reps)
            times.append(f"{'default' if config == (0, 0, 0) else config} {us:.1f}")
        print(f"{'':11s} ball_query_2l {label}, device us a launch by (centroids a warp, warps "
              f"a block, warps a centroid), each equal to plain: " + ", ".join(times), flush=True)


# Kernel 2's queries of a PointNet++ SSG forward pass, as POINTNEXT_QUERIES
# and MSG_QUERIES: (centroid level, cloud level, radius, K).
SSG_QUERIES = [(1, 0, 0.1, 32), (2, 1, 0.2, 32), (3, 2, 0.4, 32), (4, 3, 0.8, 32)]
# The evaluation buckets, (B, N, C, radius, K): SA1's radius, and r = 0.8
# at N = 65536, a ball of thousands of members.
EVAL_BALLS = [(2, 16384, 1024, 0.1, 32), (1, 65536, 1024, 0.1, 32), (1, 65536, 1024, 0.8, 32)]
# 3-NN of an FP pass upsamples level l + 1 onto level l; the evaluation
# buckets as (B, N, M).
FP_LEVELS = [(0, 1), (1, 2), (2, 3), (3, 4)]
EVAL_THREE_NN = [(2, 16384, 1024), (1, 65536, 1024)]
# Rounded FP instructions a pair that exact arithmetic needs: the Gram form
# (3 mul, 2 add, the doubling, a subtraction and an addition) and one
# compare; at one instruction a lane a cycle (half the FMA rate)
EXACT_INSTR_A_PAIR = 9
# the kernels' splits swept at each shape: ball query (centroids a warp,
# warps a block, warps a centroid), 3-NN (targets a warp, warps a block)
BALL_SPLITS = [(1, 8, 1), (2, 8, 1), (4, 8, 1), (8, 8, 1), (4, 4, 1), (4, 16, 1), (1, 8, 2),
               (1, 8, 4), (1, 16, 16), (2, 8, 2), (2, 8, 4), (2, 8, 8), (4, 8, 2), (4, 16, 16)]
THREE_NN_SPLITS = [(1, 8), (2, 8), (4, 8), (8, 8), (1, 4), (2, 4), (4, 4), (8, 4), (2, 16),
                   (4, 16), (1, 2)]


def floor_us(pairs: float) -> float:
    """Exact-arithmetic floor of `pairs` distance evaluations, us: their
    rounded FP instructions over 132 SMs x 128 lanes at the boost clock
    (half the FMA rate that PEAK_F32_FLOPS counts)."""
    return pairs * EXACT_INSTR_A_PAIR / (PEAK_F32_FLOPS / 2) * 1e6


def training_levels(device) -> list:
    """The PointNet++ training path's five clouds (4096 points, then each
    stage's FPS picks from a start of 0), as in the kernel phase."""
    from pointseg_torch.ops.fps import farthest_point_sampling
    from pointseg_torch.ops.gather import gather_rows

    levels = [torch.from_numpy(block_cloud(np.random.default_rng(0), 8, 4096)).to(device)]
    for _, _, C in SLICE_FPS:
        levels.append(gather_rows(levels[-1], farthest_point_sampling(levels[-1], C)).contiguous())
    return levels


def ball_cases(device, levels) -> list:
    """(label, centroids, cloud, radius, K, launches a forward pass of SSG,
    of MSG, of PointNeXt) for every ball query the three models run and the
    evaluation buckets."""
    cases = []
    for q in dict.fromkeys(SSG_QUERIES + MSG_QUERIES + POINTNEXT_QUERIES):
        cents, pts = levels[q[0]], levels[q[1]]
        label = f"({cents.shape[0]}, {cents.shape[1]}, {pts.shape[1]}, r={q[2]}, K={q[3]})"
        cases.append((label, cents, pts, q[2], q[3], int(q in SSG_QUERIES), int(q in MSG_QUERIES),
                      POINTNEXT_QUERIES.count(q)))
    rng = np.random.default_rng(15)
    for B, N, C, r, K in EVAL_BALLS:
        pts = torch.from_numpy(block_cloud(rng, B, N)).to(device)
        cases.append((f"eval ({B}, {C}, {N}, r={r}, K={K})", pts[:, :C].contiguous(), pts, r, K,
                      0, 0, 0))
    return cases


def three_nn_cases(device, levels) -> list:
    """(label, targets, sources, launches a forward pass) for the four FP
    stages and the evaluation buckets."""
    cases = [(f"FP{i + 1} {tuple(levels[t].shape[:2])} <- {levels[s].shape[1]}",
              levels[t], levels[s], 1) for i, (t, s) in enumerate(FP_LEVELS)]
    rng = np.random.default_rng(16)
    for B, N, M in EVAL_THREE_NN:
        pts = torch.from_numpy(block_cloud(rng, B, N)).to(device)
        cases.append((f"eval ({B}, {N}) <- {M}", pts, pts[:, :M].contiguous(), 0))
    return cases


def selection_times(device) -> None:
    """Kernels 2 and 3 at every shape of the three PointNet++-family models
    and at the evaluation buckets: each equal to its plain version (ball
    query raw and with the repeat filler, 3-NN indices and distance bits),
    device us a launch (profiler), and each model's row under CUDA
    events."""
    from pointseg_torch.ops.ballquery import ball_query, ball_query_plain, ball_query_raw
    from pointseg_torch.ops.interpolate import three_nn, three_nn_plain

    levels = training_levels(device)
    rows = {"ball_query raw, SSG's four": 0.0, "ball_query repeat, SSG's four": 0.0,
            "ball_query repeat, MSG's eight": 0.0, "ball_query repeat, PointNeXt's nine": 0.0,
            "three_nn, the four FP stages": 0.0}
    for label, cents, pts, r, K, ssg, msg, pnext in ball_cases(device, levels):
        want_idx, want_in = ball_query_plain(cents, pts, r, K)
        idx, in_ball = ball_query_raw(cents, pts, r, K)
        rep, rep_in = ball_query(cents, pts, r, K)
        torch.cuda.synchronize()
        if not (torch.equal(idx, want_idx) and torch.equal(in_ball, want_in)
                and torch.equal(rep, torch.where(want_in, want_idx, want_idx[..., :1]))
                and torch.equal(rep_in, want_in)):
            raise AssertionError(f"ball query {label}: differs from plain "
                                 f"({int((idx != want_idx).sum())} slots)")
        reps = 10 if pts.shape[1] <= 4096 else 5
        us = kernel_device_us(lambda: ball_query_raw(cents, pts, r, K), "ball_query_kernel", reps)
        if ssg or msg or pnext:
            raw_ms = timed(lambda: ball_query_raw(cents, pts, r, K), 50)
            rep_ms = timed(lambda: ball_query(cents, pts, r, K), 50)
            rows["ball_query raw, SSG's four"] += ssg * raw_ms
            rows["ball_query repeat, SSG's four"] += ssg * rep_ms
            rows["ball_query repeat, MSG's eight"] += msg * rep_ms
            rows["ball_query repeat, PointNeXt's nine"] += pnext * rep_ms
        print(f"{'':11s} ball_query {label}: {us:.1f} us a launch on "
              f"the device, floor {floor_us(cents.shape[0] * cents.shape[1] * pts.shape[1]):.1f}"
              f" us; share of in-ball slots {float(want_in.float().mean()):.3f}", flush=True)
    for label, tgt, src, per_forward in three_nn_cases(device, levels):
        d2, idx = three_nn(tgt, src)
        want_d2, want_idx = three_nn_plain(tgt, src)
        torch.cuda.synchronize()
        if not (torch.equal(idx, want_idx)
                and torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))):
            raise AssertionError(f"three_nn {label}: differs from plain")
        reps = 10 if tgt.shape[1] <= 4096 else 5
        us = kernel_device_us(lambda: three_nn(tgt, src), "three_nn_kernel", reps)
        if per_forward:
            rows["three_nn, the four FP stages"] += timed(lambda: three_nn(tgt, src), 50)
        print(f"{'':11s} three_nn {label}: {us:.1f} us a launch on the "
              f"device, floor {floor_us(tgt.shape[0] * tgt.shape[1] * src.shape[1]):.1f} us",
              flush=True)
    print(f"{'':11s} rows under CUDA events, ms: "
          + "; ".join(f"{k} {v:.4f}" for k, v in rows.items()))


def selection_splits(device) -> None:
    """Every split of kernels 2 and 3 in BALL_SPLITS / THREE_NN_SPLITS at
    the training stages and the evaluation buckets, each equal to the plain
    version, device us a launch, beside the split the kernel picks."""
    from pointseg_torch.ops.ballquery import _ball_query_cuda, _radius_sq, ball_query_plain
    from pointseg_torch.ops.interpolate import _three_nn_cuda, three_nn_plain

    levels = training_levels(device)
    cases = [c for c in ball_cases(device, levels)
             if c[5] or c[0].startswith("eval")]  # SSG's four, the buckets
    for label, cents, pts, r, K, *_ in cases:
        want = ball_query_plain(cents, pts, r, K)
        times = []
        for config in ((0, 0, 0), *BALL_SPLITS):
            def call():
                return _ball_query_cuda(cents, pts, _radius_sq(r), K, None, "flat", 4, False,
                                        config)
            got = call()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"ball query {label} split {config} differs from plain")
            us = kernel_device_us(call, "ball_query_kernel", 5)
            times.append(f"{'default' if config == (0, 0, 0) else config} {us:.1f}")
        print(f"{'':11s} ball_query {label}, device us a launch by (centroids a warp, warps a "
              f"block, warps a centroid): " + ", ".join(times), flush=True)
    for label, tgt, src, _ in three_nn_cases(device, levels):
        want_d, want_i = three_nn_plain(tgt, src)
        times = []
        for split in ((0, 0), *THREE_NN_SPLITS):
            d, i = _three_nn_cuda(tgt, src, None, split)
            if not (torch.equal(i, want_i) and torch.equal(d.view(torch.int32),
                                                           want_d.view(torch.int32))):
                raise AssertionError(f"three_nn {label} split {split} differs from plain")
            us = kernel_device_us(lambda: _three_nn_cuda(tgt, src, None, split),
                                  "three_nn_kernel", 5)
            times.append(f"{'default' if split == (0, 0) else split} {us:.1f}")
        print(f"{'':11s} three_nn {label}, device us a launch by (targets a warp, warps a "
              f"block): " + ", ".join(times), flush=True)


def one_kernel_a_repeat_call(device) -> None:
    """`ball_query(filler="repeat")` on the card: one device kernel, the
    ball query's (profiler over one call)."""
    from torch.autograd import DeviceType

    from pointseg_torch.ops.ballquery import ball_query

    levels = training_levels(device)
    cents, pts = levels[1], levels[0]
    rows = [e for e in profiled(lambda: ball_query(cents, pts, 0.1, 32), 1)
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if [e.count for e in rows] != [1] or "ball_query_kernel" not in rows[0].key:
        raise AssertionError(f"ball_query(filler='repeat'): device kernels "
                             f"{[(e.key, e.count) for e in rows]}, not one ball_query_kernel")
    print(f"{'':11s} ball_query(filler='repeat') at SA1: one device kernel, {rows[0].key}")


def knn_kernels(device, record: Record) -> None:
    """The flat kNN kernel (kernel 4) and kernel 5, forced at k <= 32
    through the private route, at DGCNN's EdgeConv shapes, repeated points
    and an evaluation bucket: equal to each other and to the plain version
    beyond float64-verified ties."""
    from pointseg_torch.ops.knn import _knn_cuda, default_depth, knn_indices, knn_indices_plain

    def two_level(x, k):
        return _knn_cuda(x, k, "two_level", default_depth(k))

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
        flat = knn_indices(x, k)
        two = two_level(x, k)
        torch.cuda.synchronize()
        if not torch.equal(flat, two):
            raise AssertionError(f"kNN {tuple(x.shape)} {what}: flat and two-level differ at "
                                 f"{int((flat != two).sum())} slots")
        flips, err = check_picks(x, x, flat, want)
        if what == "repeated points":
            check_knn_options(x, k)
        lib_ms = timed(lambda: knn_library(x, k), reps)
        work = opwork("knn_indices", x, k)
        times = {}
        for name, fn in (("knn", knn_indices), ("knn_2l", two_level)):
            ms, plain_ms = timed_pair(lambda: fn(x, k), lambda: knn_indices_plain(x, k), reps,
                                      plain_reps)
            record.note(name, (B, N, F, what), ms, plain_ms, lib_ms, work, flips, err,
                        per_forward)
            times[name] = ms
        # The kernels round every product and add it by itself: two float32
        # instructions where the bound above counts one fused multiply-add,
        # so an exact kernel's floor is twice the operation bound.
        floor_ms = 2 * work[0] / PEAK_F32_FLOPS * 1e3
        us, us_2l = device_us_in_turns(lambda: knn_indices(x, k), "knn_flat_kernel",
                                       lambda: two_level(x, k), "knn_two_level_kernel", 5)
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
    knn_2l_past_the_flat_limits(device)


def knn_edge_cases(device) -> None:
    """Shapes the flat kernel's tiles can get wrong, each against the plain
    version slot for slot, with and without `mask` and
    `include_self=False`, and flat against two-level: N no multiple of the
    128-candidate tile or of the rows of a block (4099, 37, 1100), row
    widths on the 16-byte path (64, 128, 8, 12), on the 4-byte path (1, 3,
    6, 9, 67) and past one 64-feature chunk (67, 128, 132), k = 1 and 32,
    one cloud, a view that is not 16-byte aligned, and batches small
    enough that a warp takes four or two query rows instead of eight."""
    from pointseg_torch.ops.knn import _knn_cuda, default_depth, knn_indices, knn_indices_plain

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
        for select, got in (("flat", knn_indices(x, k)),
                            ("two_level", _knn_cuda(x, k, "two_level", default_depth(k)))):
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


def knn_2l_past_the_flat_limits(device) -> None:
    """k = 33, 48, 64 at (8, 4096, 64) and F = 640, 1024 at (2, 4096, F),
    where the shape rule runs kernel 5: one launch of it, equal to the
    plain version slot for slot with and without the mask and the point
    itself, and at depth 1; device us a launch beside the flat kernel at k
    = 20 (where it runs), the bound and the exact-arithmetic floor."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.knn import _knn_cuda, knn_indices, knn_indices_plain

    rng = np.random.default_rng(23)
    x64 = torch.from_numpy(activations(rng, 8, 4096, 64, repeat_from=3072)).to(device)
    cases = [(x64, k) for k in (33, 48, 64)]
    cases += [(torch.from_numpy(activations(rng, 2, 4096, F, repeat_from=3500)).to(device), 20)
              for F in (640, 1024)]
    for x, k in cases:
        B, N, F = x.shape
        mask = torch.rand((B, N), device=device,
                          generator=torch.Generator(device).manual_seed(24)) < 0.8
        mask[0, 10:] = False  # a cloud with fewer than k points left
        for kwargs in ({}, {"mask": mask}, {"include_self": False},
                       {"mask": mask, "include_self": False}):
            want = knn_indices_plain(x, k, **kwargs)
            before = dict(_kernels.LAUNCHES)
            got = knn_indices(x, k, **kwargs)
            if (_kernels.LAUNCHES["knn_2l"] != before["knn_2l"] + 1
                    or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
                raise AssertionError(f"kNN {(B, N, F)} k={k}: the shape rule must launch the "
                                     f"two-level kernel once")
            if not torch.equal(got, want):
                raise AssertionError(f"kNN {(B, N, F)} k={k} {sorted(kwargs)}: "
                                     f"{int((got != want).sum())} slots differ from plain")
            if not torch.equal(_knn_cuda(x, k, "two_level", 1, **kwargs), want):
                raise AssertionError(f"kNN {(B, N, F)} k={k} {sorted(kwargs)} at depth 1 "
                                     f"differs from plain")
        flops, nbytes = opwork("knn_indices", x, k)
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        if F <= 512:
            flat_us, us = device_us_in_turns(lambda: knn_indices(x, 20), "knn_flat_kernel",
                                             lambda: knn_indices(x, k), "knn_two_level_kernel", 5)
            beside = f"the flat kernel at k = 20: {flat_us:.1f} us"
        else:
            us = kernel_device_us(lambda: knn_indices(x, k), "knn_two_level_kernel", 5)
            beside = "the flat kernel does not stage rows this wide"
        print(f"{'':11s} knn {(B, N, F)} k={k}: the shape rule runs the two-level kernel, equal "
              f"to plain (mask, without self, both, depth 1); {us:.1f} us a launch on the "
              f"device ({beside}); bound {bound * 1e6:.1f} us, exact-arithmetic floor "
              f"{2 * flops / PEAK_F32_FLOPS * 1e6:.1f} us", flush=True)


def check_knn_options(x, k: int, quiet: bool = False) -> None:
    """`mask` and `include_self=False` run in both kernels (the second
    forced through the private route) and give the plain version's lists,
    slot for slot."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.knn import _knn, knn_indices_plain

    B, N, _ = x.shape
    mask = torch.rand((B, N), device=x.device,
                      generator=torch.Generator(x.device).manual_seed(4)) < 0.8
    mask[0, 10:] = False  # a cloud with fewer than k points left
    for kwargs in ({"mask": mask}, {"include_self": False},
                   {"mask": mask, "include_self": False}):
        want = knn_indices_plain(x, k, **kwargs)
        for select, counter in (("flat", "knn"), ("two_level", "knn_2l")):
            before = _kernels.LAUNCHES[counter]
            got = _knn(x, k, kwargs.get("mask"), kwargs.get("include_self", True), select)
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
    # (B, N, C, idx shape, how often one forward of the kernel's training
    # path, PointNet++'s, runs it): DGCNN's EdgeConv shapes are checked
    # only, since its forward reduces them in edge_reduce
    cases = [(8, 4096, 64, (4096, K_NEIGHBOURS), 0), (8, 4096, 128, (4096, K_NEIGHBOURS), 0)]
    cases += [(8, N, C, shape, 1) for N, C, shape in POINTNETPP_GATHERS]
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
        record.note("gather_rows", (B, N, C, M), ms, plain_ms, plain_ms,
                    opwork("gather_rows", table, idx), 0, max(err, grad_err), per_forward)
        print(f"{'':11s} backward (index_add_) against autograd of torch.gather: "
              f"max |diff| {grad_err:.3g}")


# EdgeConv's gather-reduce in one DGCNN forward at B = 8, N = 4096, k =
# 20: (C, how often)
EDGE_REDUCES = [(64, 3), (128, 1)]


def edge_reduce_kernels(device, record: Record) -> None:
    """Kernel 9's pair against `edge_reduce_plain` at DGCNN's EdgeConv
    shapes, ties forced (rows of small integers, the second half of the
    table a copy of the first, a repeated index in every list): max and
    min bit-equal, tie counts exact, the sums and the backward's gradient
    (against autograd of the plain composition) within 1e-5 of their
    largest. The forward and the backward kernel are timed and noted
    each, so the record's row is a training step's pair; their bound is
    the bytes (the compares and adds lie far below it)."""
    from pointseg_torch.ops.edgereduce import (
        _edge_reduce_backward_cuda,
        _edge_reduce_cuda,
        edge_reduce,
        edge_reduce_plain,
    )
    from pointseg_torch.ops.gather import gather_rows_plain

    rng = np.random.default_rng(4)
    B, N, k = 8, 4096, K_NEIGHBOURS
    for C, per_forward in EDGE_REDUCES:
        table_np = rng.integers(-3, 4, size=(B, N, C)).astype(np.float32)
        table_np[:, N // 2:] = table_np[:, :N - N // 2]
        idx_np = rng.integers(0, N, (B, N, k)).astype(np.int32)
        idx_np[..., 1] = idx_np[..., 0]
        table, idx = torch.from_numpy(table_np).to(device), torch.from_numpy(idx_np).to(device)
        gen = torch.Generator(device).manual_seed(5)
        grads = [torch.randn((B, N, C), device=device, generator=gen) for _ in range(4)]
        vmax, vmin, s, q, cmax, cmin = _edge_reduce_cuda(table, idx, True, counts=True)
        want = edge_reduce_plain(table, idx, True)
        if not (torch.equal(vmax, want[0]) and torch.equal(vmin, want[1])):
            raise AssertionError(f"edge_reduce {(B, N, k, C)}: max or min differ from the plain "
                                 f"composition")
        gp = gather_rows_plain(table, idx)
        n_max, n_min = (gp == want[0][:, :, None]).sum(2), (gp == want[1][:, :, None]).sum(2)
        del gp
        if not (torch.equal(cmax.long(), n_max) and torch.equal(cmin.long(), n_min)):
            raise AssertionError(f"edge_reduce {(B, N, k, C)}: tie counts differ")
        if int(n_max.max()) < 2 or int(n_min.max()) < 2:
            raise AssertionError(f"edge_reduce {(B, N, k, C)}: the inputs forced no tie")
        err = 0.0
        for label, got, w in (("s", s, want[2]), ("q", q, want[3])):
            rel = float((got - w).abs().max()) / float(w.abs().max())
            if rel > 1e-5:
                raise AssertionError(f"edge_reduce {(B, N, k, C)}: {label} off by {rel:.3g} "
                                     f"of its largest")
            err = max(err, rel)
        t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
        torch.autograd.backward(edge_reduce(t1, idx, True), grads)
        plain_out = edge_reduce_plain(t2, idx, True)
        torch.autograd.backward(plain_out, grads, retain_graph=True)
        grad_rel = float((t1.grad - t2.grad).abs().max()) / float(t2.grad.abs().max())
        if grad_rel > 1e-5:
            raise AssertionError(f"edge_reduce {(B, N, k, C)}: gradient off by {grad_rel:.3g} "
                                 f"of its largest")
        del t1

        shapes = [(tuple(table.shape), 4), (tuple(idx.shape), 4), True]
        fwd_work = harness.op_module("edge_reduce").work(shapes)
        bwd_work = harness.op_module("edge_reduce").backward_work(shapes)
        fwd_bytes, bwd_bytes = fwd_work[1], bwd_work[1]
        fwd = lambda: _edge_reduce_cuda(table, idx, True, counts=True)  # noqa: E731
        bwd = lambda: _edge_reduce_backward_cuda(  # noqa: E731
            table, idx, vmax, vmin, cmax, cmin, *grads)
        ms, plain_ms = timed_pair(fwd, lambda: edge_reduce_plain(table, idx, True), 20, 5)
        record.note("edge_reduce", (B, N, k, C, "forward"), ms, plain_ms, None, fwd_work,
                    0, err, per_forward)
        ms, plain_ms = timed_pair(bwd, lambda: torch.autograd.grad(plain_out, t2, grads,
                                                                   retain_graph=True), 20, 5)
        record.note("edge_reduce", (B, N, k, C, "backward"), ms, plain_ms, None, bwd_work,
                    0, grad_rel, per_forward)
        fwd_us = kernel_device_us(fwd, "edge_reduce_kernel")
        bwd_us = kernel_device_us(bwd, "edge_reduce_backward_kernel")
        print(f"{'':11s} device time a launch (profiler): edge_reduce_kernel {fwd_us:.1f} us "
              f"({100 * fwd_bytes / PEAK_BYTES_PER_S / (fwd_us * 1e-6):.0f}% of its bytes "
              f"bound), edge_reduce_backward_kernel {bwd_us:.1f} us "
              f"({100 * bwd_bytes / PEAK_BYTES_PER_S / (bwd_us * 1e-6):.0f}%); max tie count "
              f"{int(n_max.max())}; sums off by {err:.3g}, gradient by {grad_rel:.3g} of "
              f"their largest", flush=True)
        del table, idx, grads, vmax, vmin, s, q, cmax, cmin, want, t2, plain_out, n_max, n_min
        torch.cuda.empty_cache()


# PointNeXt-XL's grouped layers of one forward at B 32 x 4,096, over its
# clouds of 4096, 1024, 256, 64 and 16 points: per stage s, its set
# abstraction (level s's centroids in level s - 1 at radius r_s) and its
# InvResMLPs (level s around its own points at 2 r_s; 3, 6, 3, 3 of them),
# each a ball of 32 and one `gather_rows_with_coords` of rows of the
# stage's width. (centroid level, cloud level, radius, row width, calls a
# forward); the last one's balls are wider than their 16-point level.
XL_GROUPINGS = [(1, 0, 0.1, 128, 1), (1, 1, 0.2, 128, 3), (2, 1, 0.2, 256, 1),
                (2, 2, 0.4, 256, 6), (3, 2, 0.4, 512, 1), (3, 3, 0.8, 512, 3),
                (4, 3, 0.8, 1024, 1), (4, 4, 1.6, 1024, 3)]
XL_K = 32
# a PointNeXt-XL forward's launches (its backward launches none of the
# port's kernels: the gathers' gradient is the library's scatter-add)
XL_LAUNCHES = {"fps": 4, "ball_query": 19, "three_nn": 4, "gather_rows": 27}


def pointnext_xl_groupings(device) -> None:
    """PointNeXt-XL's 19 ball queries and grouped-row gathers at B 32 x
    4,096, on the clouds FPS makes from a block cloud: each ball query
    (public `ops.ball_query`, repeat filler, one flat launch) against the
    plain version with the repeat fill, picks equal up to float64-verified
    ties, and slots 16..31 of the last level's K > N balls slot 0 as
    non-members; each gather (one launch) bit-equal to two
    `torch.gather` calls, and its feature gradient within 1e-5 of the
    largest of a float64 `torch.gather` gradient (the scatter-add's order
    differs). Kernel and plain times, each and summed over a forward."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.ballquery import ball_query, ball_query_plain
    from pointseg_torch.ops.fps import farthest_point_sampling
    from pointseg_torch.ops.gather import gather_rows, gather_rows_with_coords

    def one_launch(fn, counter, what):
        before = dict(_kernels.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        if (_kernels.LAUNCHES[counter] != before[counter] + 1
                or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
            raise AssertionError(f"{what}: one {counter} launch expected "
                                 f"({before} -> {_kernels.LAUNCHES})")
        return out

    def plain_balls(cents, pts, r):
        N = pts.shape[1]
        idx, in_ball = ball_query_plain(cents, pts, r, min(XL_K, N))
        idx = torch.where(in_ball, idx, idx[..., :1])
        pad = (*idx.shape[:-1], XL_K - N)
        if XL_K > N:
            idx = torch.cat([idx, idx[..., :1].expand(pad)], dim=-1)
            in_ball = torch.cat([in_ball, in_ball.new_zeros(pad)], dim=-1)
        return idx, in_ball

    rng = np.random.default_rng(20)
    B = 32
    levels = [torch.from_numpy(block_cloud(rng, B, 4096)).to(device)]
    for n in (1024, 256, 64, 16):
        levels.append(gather_rows(levels[-1], farthest_point_sampling(levels[-1], n)).contiguous())
    sums = [0.0, 0.0, 0.0, 0.0]  # ball query kernel, plain; gather kernel, library
    for c, p, r, h, calls in XL_GROUPINGS:
        cents, pts = levels[c], levels[p]
        C, N = cents.shape[1], pts.shape[1]
        what = f"PointNeXt-XL ({B}, {C}, {N}, r={r}, K={XL_K}, rows {h})"
        idx, in_ball = one_launch(lambda: ball_query(cents, pts, r, XL_K), "ball_query", what)
        w_idx, w_in = plain_balls(cents, pts, r)
        if not torch.equal(in_ball, w_in):
            raise AssertionError(f"{what}: in_ball differs from the plain version")
        flips, err = check_picks(cents, pts, idx, w_idx)
        if XL_K > N and not (torch.equal(idx[..., N:], idx[..., :1].expand(-1, -1, XL_K - N))
                             and not bool(in_ball[..., N:].any())):
            raise AssertionError(f"{what}: the slots of a ball past its level's {N} points "
                                 f"must repeat slot 0, as non-members")
        bq_ms, bq_plain_ms = timed_pair(lambda: ball_query(cents, pts, r, XL_K),
                                        lambda: plain_balls(cents, pts, r), 10)

        feats = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(device)
        feats.requires_grad_(True)
        gf, gc = one_launch(lambda: gather_rows_with_coords(feats, pts, idx), "gather_rows",
                            what)
        if not (torch.equal(gf, rows(feats.detach(), idx)) and torch.equal(gc, rows(pts, idx))):
            raise AssertionError(f"{what}: gathered rows differ from torch.gather's")
        grad = torch.randn(gf.shape, device=device)
        gf.backward(grad)
        table = feats.detach().double().requires_grad_(True)
        rows(table, idx).backward(grad.double())
        g_err = float((feats.grad.double() - table.grad).abs().max()
                      / table.grad.abs().max())
        if not g_err <= 1e-5:
            raise AssertionError(f"{what}: feature gradient {g_err:.3g} of its largest from the "
                                 f"float64 torch.gather gradient")
        del gf, gc, grad, table
        g_ms, lib_ms = timed_pair(lambda: gather_rows_with_coords(feats.detach(), pts, idx),
                                  lambda: (rows(feats.detach(), idx), rows(pts, idx)), 10)
        for i, ms in enumerate((bq_ms, bq_plain_ms, g_ms, lib_ms)):
            sums[i] += calls * ms
        print(f"{what} x{calls} a forward: ball query {bq_ms:.4f} ms (plain {bq_plain_ms:.4f}), "
              f"tie flips {flips}, max |err| {err:.3g}, in-ball share "
              f"{float(in_ball.float().mean()):.3f}; gather {g_ms:.4f} ms (two torch.gather "
              f"{lib_ms:.4f}), rows bit-equal, gradient {g_err:.3g} of its largest", flush=True)
    print(f"PointNeXt-XL's 19 groupings a forward at B {B}: ball queries {sums[0]:.4f} ms "
          f"(plain {sums[1]:.4f}), gathers {sums[2]:.4f} ms (two torch.gather {sums[3]:.4f})")


def pointnext_xl_step(device) -> None:
    """One PointNeXt-XL train step at B 32 x 4,096, the launch counters set
    to 0 just before it: `XL_LAUNCHES` and no other kernel. The step is
    the state's second, the one captured into its CUDA graph (it launches
    from Python once; a replay launches nothing from Python). Then its
    step time and peak memory over three replayed steps, and three steps
    replayed against three eager steps from a copy of the same state and
    generators: replays counted, the first loss bit-equal, the others
    within 1e-5."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    rng = np.random.default_rng(21)
    B, N = 32, 4096
    x = np.concatenate([block_cloud(rng, B, N), rng.random((B, N, 6), dtype=np.float32)], -1)
    labels = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 14, (B, N))), 14)
    batch = (torch.from_numpy(x).to(device), labels.to(torch.uint8).to(device),
             torch.full((B,), N, dtype=torch.int32, device=device))
    torch.manual_seed(0)
    run = create_train_state(create_model("PointNeXt-XL"), device=device, learning_rate=1e-3,
                             seed=0)
    train_step(run, *batch)  # builds and warms every kernel; makes Adam's moments
    torch.cuda.synchronize()
    zero_launches()
    before = step_counts()
    loss = float(train_step(run, *batch)["loss"])
    launches = {k: v for k, v in read_launches().items() if v}
    captured = step_counts()["captured"] - before["captured"]
    if launches != XL_LAUNCHES or captured != 1 or not math.isfinite(loss):
        raise AssertionError(f"PointNeXt-XL train step: launches {launches}, want "
                             f"{XL_LAUNCHES}; captured {captured}, want 1; loss {loss}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: train_step(run, *batch), 3)
    print(f"PointNeXt-XL train step (B={B}, N={N}): launches {launches} (the captured step), "
          f"loss {loss:.4f}, {step_ms:.3f} ms (3 replayed steps), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    graphed_against_eager(run, batch, "PointNeXt-XL")
    del run, batch
    torch.cuda.empty_cache()


def copy_train_state(state):
    """A copy of a `TrainState` sharing no tensor with it: model, Adam's
    moments and step counts, rate tensors, FPS generator state, step."""
    from pointseg_torch.train.state import TrainState

    model = copy.deepcopy(state.model)
    optimizer = type(state.optimizer)(model.parameters(), state.optimizer.learning_rate,
                                      state.optimizer.schedule, state.optimizer.total_steps,
                                      state.optimizer.warmup_steps, state.optimizer.grad_clip)
    optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return TrainState(model, optimizer, generator, step=state.step)


def graphed_against_eager(run, batch, label: str, steps: int = 3) -> None:
    """`steps` train steps of `run` (replays of its graph) against the same
    steps of a copy kept eager by a forward hook, from one dropout
    generator state: every step of `run` replayed, the first loss
    bit-equal (its forward has no atomics), the others within 1e-5
    (the backward's `index_add_` adds in another order each run)."""
    from pointseg_torch.train.state import train_step

    eager = copy_train_state(run)
    hook = eager.model.register_forward_hook(lambda *a: None)
    rng = torch.cuda.get_rng_state()
    losses = {}
    for name, state in (("graphed", run), ("eager", eager)):
        torch.cuda.set_rng_state(rng)
        before = step_counts()
        losses[name] = [float(train_step(state, *batch)["loss"]) for _ in range(steps)]
        counts = {k: v - before[k] for k, v in step_counts().items()}
        want = ({"captured": 0, "replayed": steps, "eager": 0} if name == "graphed"
                else {"captured": 0, "replayed": 0, "eager": steps})
        if counts != want:
            raise AssertionError(f"{label} {name} steps: {counts}, want {want}")
    hook.remove()
    a, b = losses["graphed"], losses["eager"]
    if a[0] != b[0] or any(abs(x - y) > 1e-5 * abs(y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: replayed losses {a} against eager {b}")
    print(f"{label}: {steps} replayed steps against {steps} eager steps from a copy of the "
          f"state: losses {a} / {b} (the first bit-equal)", flush=True)


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
        # its own count: portbench/opwork/ has no module for the store's gather,
        # and these random rows read whole sectors, not their bytes
        record.note("gather_rows_flat", (R, row_bytes, mrows, what), (k1 + k2) / 2,
                    (p1 + p2) / 2, lib_ms, (0.0, nbytes), 0, 0.0, per_step)
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


def step_counts() -> dict:
    """`train/state.py::STEP_GRAPHS` as it stands: train steps captured,
    replayed and run eagerly."""
    from pointseg_torch.train.state import STEP_GRAPHS

    return dict(STEP_GRAPHS)


def launched_steps(before: dict) -> int:
    """Train steps since `before` (a `step_counts()`) that launched their
    kernels from Python: the eager and the captured ones. A replayed step
    launches none, so a launch count covers these steps alone."""
    now = step_counts()
    return now["eager"] - before["eager"] + now["captured"] - before["captured"]


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
                      flags: tuple[str, ...] = (), mode: str = "host loader"):
    """One epoch and its evaluation through the CLI, with `flags` added;
    returns (state, launches, records), `records["launched_steps"]` the train steps that
    launched from Python (`launched_steps`: the launches count these and
    the evaluation's forwards, not the replayed steps). Raises unless every
    kernel in `needed` was launched and the train split came by way of
    `mode`."""
    from pointseg_torch import cli

    argv = ["train", model_name, "--synthetic", "--data-dir", f"{workdir}/data",
            "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "4096",
            "--device", "cuda", "--log-dir", f"{workdir}/logs",
            "--model-dir", f"{workdir}/models", *flags]
    args = cli.build_parser().parse_args(argv)
    zero_launches()
    before = step_counts()
    t0 = time.time()
    state, records = cli.train_from_args(args)
    launches = read_launches()
    records["launched_steps"] = launched_steps(before)
    steps = {k: v - before[k] for k, v in step_counts().items()}
    print(f"{model_name} {' '.join(flags)}: {time.time() - t0:.1f} s for one epoch ({state.step} "
          f"steps; `train_step` calls {steps}) and its evaluation; launches {launches}")
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


def few_steps(model_name: str, batch, device) -> None:
    """Step time and peak memory of three train steps of `model_name` from
    fresh weights, after two warm-up steps (eager, then captured: the
    launches a step are theirs; the three timed steps replay)."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step

    torch.manual_seed(0)
    run = create_train_state(create_model(model_name), device=device, learning_rate=1e-3, seed=0)
    zero_launches()
    before = step_counts()
    loss = [float(train_step(run, *batch)["loss"]) for _ in range(2)][-1]
    launches, launched = read_launches(), launched_steps(before)
    torch.cuda.reset_peak_memory_stats()
    before = step_counts()
    step_ms = cuda_ms(lambda: train_step(run, *batch), 3)
    replayed = step_counts()["replayed"] - before["replayed"]
    if not math.isfinite(loss) or launches["ball_query"] == 0 or launched != 2 or replayed != 3:
        raise AssertionError(f"{model_name}: loss {loss}, launches {launches} in {launched} "
                             f"steps launched from Python, then {replayed} of 3 replayed")
    points = batch[0].shape[0] * batch[0].shape[1]
    print(f"{model_name} train step (3 steps, replayed): {step_ms:.3f} ms, "
          f"{points / (step_ms / 1e3):.0f} points/s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches a step "
          f"{ {k: v // 2 for k, v in launches.items() if v} }")
    del run
    torch.cuda.empty_cache()


def trainer_phase(device, workdir: str):
    from pointseg_torch.data.datasets import create_block_dataloaders
    from pointseg_torch.train.loop import to_device

    pp_state, pp_launches, pp_rec = train_through_cli(
        "PointNet++", workdir, ("fps", "ball_query", "three_nn", "gather_rows"))
    if (pp_launches["knn"] or pp_launches["knn_2l"] or pp_launches["ball_query_2l"]
            or pp_launches["gather_rows_flat"]):
        raise AssertionError(f"PointNet++ launched kernels off its path: {pp_launches}")
    forwards = pp_launches["fps"] // 4  # train steps launched from Python and eval batches
    if forwards <= pp_rec["launched_steps"] or any(pp_launches[k] != 4 * forwards
                                        for k in ("fps", "ball_query", "three_nn")):
        raise AssertionError(f"PointNet++: every forward pass must launch fps, ball_query and "
                             f"three_nn 4 times each, got {pp_launches}")
    train_loader, _ = create_block_dataloaders(f"{workdir}/data", {6}, 8, 2, 4096, seed=1)
    batch = to_device(next(iter(train_loader)), device)
    pp_perf = {**steady_state(pp_state, batch, "PointNet++"), "cli_launches": pp_launches}

    pn_state, pn_launches, _ = train_through_cli("PointNet", workdir, ())
    if any(pn_launches.values()):
        raise AssertionError(f"PointNet runs none of the port's kernels, got {pn_launches}")
    pn_perf = {**steady_state(pn_state, batch, "PointNet"), "cli_launches": pn_launches}

    dg_state, dg_launches, dg_rec = train_through_cli("DeepGraphCnn", workdir,
                                                      ("knn", "edge_reduce"))
    steps = dg_rec["launched_steps"]  # a replayed step launches nothing from Python
    if dg_launches["knn"] < 4 * steps or dg_launches["edge_reduce"] < 8 * steps:
        raise AssertionError(f"DeepGraphCnn: {steps} steps launched from Python need at least "
                             f"{4 * steps} kNN and {8 * steps} edge_reduce launches, got "
                             f"{dg_launches}")
    if (dg_launches["knn_2l"] or dg_launches["fps"] or dg_launches["ball_query_2l"]
            or dg_launches["gather_rows"]):
        raise AssertionError(f"DeepGraphCnn launched kernels off its path: {dg_launches}")
    dg_perf = {**steady_state(dg_state, batch, "DeepGraphCnn"), "cli_launches": dg_launches}
    states = {"PointNet++": (pp_state, pp_perf), "PointNet": (pn_state, pn_perf),
              "DeepGraphCnn": (dg_state, dg_perf)}

    # per forward pass (a train step or an eval batch): fps, ball_query, three_nn
    for name, per_forward in (("PointNeXt", (4, 9, 4)), ("PointNet++MSG", (4, 8, 4))):
        state, got, rec = train_through_cli(name, workdir,
                                            ("fps", "ball_query", "three_nn", "gather_rows"))
        forwards = got["fps"] // per_forward[0]
        want = {"fps": per_forward[0] * forwards, "ball_query": per_forward[1] * forwards,
                "three_nn": per_forward[2] * forwards, "ball_query_2l": 0, "knn": 0, "knn_2l": 0}
        if forwards <= rec["launched_steps"] or any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{name}: {rec['launched_steps']} steps launched from Python "
                                 f"and their evaluation must launch "
                                 f"{per_forward} (fps, ball_query, three_nn) per forward pass "
                                 f"and no other selection kernel, got {got}")
        states[name] = (state, {**steady_state(state, batch, name), "cli_launches": got})
    few_steps("PointNeXt-L", batch, device)
    pointnext_xl_step(device)
    flat_launches = device_store_phase(device, workdir, pp_state)

    # kernel 6 runs on no registered model's path (no ball of more than 32);
    # kernel 5's launches are the enhanced trainer's (phase 9, k = 40)
    launches = {"fps": pp_launches["fps"], "ball_query": pp_launches["ball_query"],
                "ball_query_2l": 0, "three_nn": pp_launches["three_nn"],
                "knn": dg_launches["knn"], "knn_2l": None,
                "gather_rows": pp_launches["gather_rows"],
                "gather_rows_flat": flat_launches, "edge_reduce": dg_launches["edge_reduce"]}
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
    _, launches, rec = train_through_cli("DeepGraphCnn", workdir,
                                         ("knn", "edge_reduce", "gather_rows_flat"),
                                         ("--device-data",), "device")
    # the store samples every batch from Python; the model launches in the steps that do
    if (launches["gather_rows_flat"] != 2 * steps
            or launches["knn"] < 4 * rec["launched_steps"]):
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
            idx = ops.knn_indices(args[0], module.k)
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
        for name in ("PointNet++", "PointNet", "PointNeXt", "PointNet++MSG"):
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


# Phase 6: 3 m x 3 m rooms of area 6 whose 1 m blocks fill the 16384 and
# 65536 buckets; whole rooms of a real size (S3DIS: 273 M points in 272 rooms)
EVAL_ROOM_POINTS = (140_000, 500_000)
EVAL_BUCKETS_REACHED = (16384, 65536)  # the first also checked card against CPU
WHOLE_ROOMS, WHOLE_ROOM_POINTS = 4, 1_000_000
TRAIN_SHAPE = ("--train-batch-size", "8", "--train-sampling", "4096")
NEAR_TIE = 1e-4  # a prediction may differ where the top two logits lie this close
SCHEDULE = ("--lr-schedule", "warmup_cosine", "--warmup-steps", "4", "--grad-clip", "1.0")
PLAIN_VERSIONS = (("fps", "farthest_point_sampling_plain"), ("ballquery", "ball_query_plain"),
                  ("interpolate", "three_nn_plain"), ("knn", "knn_indices_plain"),
                  ("gather", "gather_rows_plain"), ("gather", "gather_rows_flat_plain"))


@contextlib.contextmanager
def no_plain_version_on_the_card():
    """Every plain version of the port's kernels raises if it is handed a
    tensor on the card while the block runs."""
    import importlib

    saved = []
    for module_name, name in PLAIN_VERSIONS:
        module = importlib.import_module(f"pointseg_torch.ops.{module_name}")
        plain = getattr(module, name)

        def guard(*args, _plain=plain, _name=f"{module_name}.{name}", **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                raise AssertionError(f"the plain version {_name} ran on the card")
            return _plain(*args, **kwargs)

        setattr(module, name, guard)
        saved.append((module, name, plain))
    try:
        yield
    finally:
        for module, name, plain in saved:
            setattr(module, name, plain)


def timed_call(fn):
    """(fn's result, ms under CUDA events over the whole call, peak
    allocated bytes, kernel launches), no plain version allowed on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with no_plain_version_on_the_card():
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated(), read_launches()


def train_and_resume(device, workdir: str):
    """`train PointNet++` one epoch with checkpoints, a schedule and a
    clip, then `--resume` with `--epochs 2`: the resumed run's schedule
    spans 2 epochs from the restored step, so its updates have a nonzero
    rate and must move the weights. Returns (the resumed run's checkpoint
    dir, its state, steps an epoch)."""
    from pointseg_torch import cli
    from pointseg_torch.io.checkpoint import latest_checkpoint, load_checkpoint

    argv = ["train", "PointNet++", "--synthetic", "--data-dir", f"{workdir}/data",
            *TRAIN_SHAPE, "--device", str(device), "--log-dir", f"{workdir}/logs", *SCHEDULE]
    parse = cli.build_parser().parse_args
    first, _ = cli.train_from_args(parse(argv + ["--epochs", "1",
                                                 "--model-dir", f"{workdir}/ckpt_first"]))
    (first_dir,) = glob.glob(f"{workdir}/ckpt_first/PointNet++/*")
    resumed, records = cli.train_from_args(parse(argv + ["--epochs", "2",
                                                         "--model-dir", f"{workdir}/ckpt_resumed",
                                                         "--resume", first_dir]))
    (run_dir,) = glob.glob(f"{workdir}/ckpt_resumed/PointNet++/*")
    path = latest_checkpoint(run_dir)
    step = load_checkpoint(path)["step"]
    moved = sum(not torch.equal(a, b) for a, b in zip(first.model.parameters(),
                                                       resumed.model.parameters()))
    print(f"train PointNet++ {' '.join(SCHEDULE)}: {first.step} steps an epoch; after --resume "
          f"--epochs 2 the checkpoint {os.path.basename(path)} holds step {step}; the resumed "
          f"updates moved {moved} of {len(list(first.model.parameters()))} parameter tensors")
    if step != 3 * first.step or resumed.step != step:
        raise AssertionError(f"resumed checkpoint at step {step}, state at {resumed.step}, "
                             f"want {3 * first.step}")
    if not moved:
        raise AssertionError("the resumed run's updates moved no parameter")
    if not all(math.isfinite(v) for v in records["train_loss"] + records["val_loss"]):
        raise AssertionError(f"non-finite loss after the resume: {records}")
    return run_dir, resumed, first.step


def restore_bit_for_bit(device, run_dir: str, resumed, steps: int, x) -> None:
    """A fresh state on the card restored from `run_dir` equals the state
    that wrote it, and gives the same eval logits."""
    from pointseg_torch.io.checkpoint import restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    torch.manual_seed(99)
    fresh = create_train_state(create_model("PointNet++"), device=device, seed=99,
                               schedule="warmup_cosine", total_steps=2 * steps, warmup_steps=4,
                               grad_clip=1.0)
    restore_train_state(run_dir, fresh)
    differ = [k for k, v in resumed.model.state_dict().items()
              if not torch.equal(v, fresh.model.state_dict()[k])]
    want, got = resumed.optimizer.state_dict(), fresh.optimizer.state_dict()
    differ += [f"adam {i} {name}" for i, moments in want["state"].items()
               for name, value in moments.items()
               if not torch.equal(value, got["state"][i][name])]
    if fresh.step != resumed.step:
        differ.append(f"step {fresh.step} vs {resumed.step}")
    if not torch.equal(fresh.generator.get_state(), resumed.generator.get_state()):
        differ.append("FPS generator")
    with torch.no_grad():
        a, b = resumed.model.eval()(x), fresh.model.eval()(x)
    if not torch.equal(a, b):
        differ.append(f"eval logits (max |diff| {float((a - b).abs().max()):.3g})")
    if differ:
        raise AssertionError(f"restore on the card differs: {differ[:10]}")
    print(f"restore on the card: {len(want['state'])} parameters' Adam moments, "
          f"{len(resumed.model.state_dict())} state_dict entries, step {fresh.step} and the FPS "
          f"generator bit-equal; eval logits of one {tuple(x.shape)} batch bit-equal")


def eval_block_dataset(path: str) -> None:
    """Areas 1-5 one small room each; area 6 rooms of EVAL_ROOM_POINTS."""
    from pointseg_torch.data.blocks import preprocess_dataset
    from pointseg_torch.data.prepare import save_room_archive
    from pointseg_torch.data.s3dis import S3DIS_CLASSES
    from pointseg_torch.data.synthetic import make_room

    rng = np.random.default_rng(6)
    chunks = f"{path}_chunked"
    os.makedirs(chunks)
    for area in range(1, 7):
        sizes = EVAL_ROOM_POINTS if area == 6 else (2000,)
        save_room_archive(f"{chunks}/s3dis{area}_chunk1.npz",
                          [make_room(rng, n, rgb_u8=True) for n in sizes], S3DIS_CLASSES)
    preprocess_dataset(chunks, path, verbose=False)


def near_tie_check(label: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> None:
    """`got` and `want` (N, C) logits: within `atol` (and rtol), argmax equal
    wherever `want`'s top two lie more than NEAR_TIE apart."""
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite logits")
    torch.testing.assert_close(got, want, rtol=atol, atol=atol)
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    flip = got.argmax(-1) != want.argmax(-1)
    if (flip & ~tie).any():
        raise AssertionError(f"{label}: {int((flip & ~tie).sum())} predictions differ outside "
                             f"near-ties")
    print(f"{label}: max |diff| {float((got - want).abs().max()):.3g}; predictions differ at "
          f"{int(flip.sum())} of {flip.numel()} points, near-ties (top two within {NEAR_TIE}) "
          f"{int(tie.sum())}")


def bucketed_eval(device, workdir: str, smi: str, pp_dir: str, dg_dir: str,
                  pn_dir: str) -> dict:
    """`evaluate` of PointNet++, DeepGraphCnn and PointNet (with running
    and with batch statistics) on blocks that fill the 16384 and 65536
    buckets; returns launches per block batch by run."""
    from pointseg_torch import cli
    from pointseg_torch.data.datasets import create_block_dataloaders

    data = f"{workdir}/eval_blocks"
    t0 = time.time()
    eval_block_dataset(data)
    _, loader = create_block_dataloaders(data_dir=data, test_areas={6}, test_batch_size=2,
                                         train_sampling=4096, test_sampling=None,
                                         test_buckets=cli.EVAL_BUCKETS)
    blocks, batches, points, checked = {}, {}, 0, None
    for x, _, lengths in loader:
        n = x.shape[1]
        blocks[n] = blocks.get(n, 0) + len(lengths)
        batches[n] = batches.get(n, 0) + 1
        points += int(lengths.sum())
        if n == EVAL_BUCKETS_REACHED[0] and checked is None:
            checked = torch.from_numpy(np.asarray(x))
    print(f"eval blocks: area 6 rooms of {EVAL_ROOM_POINTS} points (3 m x 3 m), made in "
          f"{time.time() - t0:.1f} s; blocks per bucket {blocks}, batches of 2 per bucket "
          f"{batches}, {points} points")
    if not set(EVAL_BUCKETS_REACHED) <= set(blocks):
        raise AssertionError(f"the eval blocks missed the buckets {EVAL_BUCKETS_REACHED}: "
                             f"{blocks}")
    per_batch = {}
    n_batches = sum(batches.values())
    for name, ckpt, needed, stats in (
            ("PointNet++", pp_dir, ("fps", "ball_query", "three_nn", "gather_rows"), "running"),
            ("DeepGraphCnn", dg_dir, ("knn", "edge_reduce"), "running"),
            ("PointNet", pn_dir, (), "running"), ("PointNet", pn_dir, (), "batch")):
        args = cli.build_parser().parse_args(
            ["evaluate", "--model-path", ckpt, "--data-path", data, "--device", str(device),
             "--bn-stats", stats, "--save-results", f"{workdir}/{name}_{stats}_blocks.json"])
        results, ms, peak, launches = timed_call(lambda: cli.evaluate_from_args(args))
        missing = [k for k in needed if launches[k] == 0]
        if missing or not math.isfinite(results["loss"]):
            raise AssertionError(f"evaluate {name}: loss {results['loss']}, kernels never "
                                 f"launched {missing}: {launches}")
        if not needed and any(launches.values()):
            raise AssertionError(f"evaluate {name} runs none of the port's kernels: {launches}")
        if stats != "running":
            name = f"{name} --bn-stats {stats}"
        per_batch[name] = {k: v / n_batches for k, v in launches.items() if v}
        print(f"evaluate {name}, blocks ({smi}): {ms:.1f} ms for {n_batches} batches, "
              f"{points / (ms / 1e3):.0f} points/s, {ms / n_batches:.2f} ms a block batch, peak "
              f"allocated {peak / 2**20:.1f} MiB; launches {launches} ({per_batch[name]} a "
              f"batch); accuracy {results['accuracy']:.4f}, mean class accuracy "
              f"{results['mean_class_accuracy']:.4f}, mIoU {results['mean_iou']:.4f}, loss "
              f"{results['loss']:.4f}")
    # one batch of the first bucket: the card against the CPU, same checkpoint
    from pointseg_torch.io.checkpoint import restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    card = restore_train_state(pp_dir, create_train_state(create_model("PointNet++"),
                                                          device=device)).model.eval()
    host = restore_train_state(pp_dir, create_train_state(create_model("PointNet++"),
                                                          device="cpu")).model.eval()
    with torch.no_grad(), no_plain_version_on_the_card():
        got = card(checked.to(device))
    with torch.no_grad():
        want = host(checked)
    near_tie_check(f"PointNet++ eval logits of one {tuple(checked.shape)} batch, card vs CPU",
                   got.reshape(-1, 14), want.reshape(-1, 14), 1e-4)
    return per_batch


def whole_room_eval(device, workdir: str, smi: str, pp_dir: str) -> dict:
    """`evaluate --whole-rooms` with both streams over rooms of a real
    size; the streams' predictions point by point; one room of 20,000
    points on the card against the CPU. Returns launches per window
    group of the device stream."""
    from pointseg_torch import cli
    from pointseg_torch.data import synthetic
    from pointseg_torch.data.datasets import ChunkedRoomDataset
    from pointseg_torch.io.checkpoint import restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state
    from pointseg_torch.utils import sliding_window as sw

    data = f"{workdir}/rooms"
    t0 = time.time()
    synthetic.make_chunked_dataset(data, areas=(6,), rooms_per_area=WHOLE_ROOMS,
                                   points_per_room=WHOLE_ROOM_POINTS, seed=1, with_index=False)
    window, overlap = 4096, 512
    step = window - overlap
    num_win = (WHOLE_ROOM_POINTS - window + 2 * step - 1) // step
    groups = WHOLE_ROOMS * -(-num_win // 8)
    points = WHOLE_ROOMS * WHOLE_ROOM_POINTS
    print(f"whole rooms: {WHOLE_ROOMS} rooms of {WHOLE_ROOM_POINTS} points made in "
          f"{time.time() - t0:.1f} s; window {window}, overlap {overlap}: {num_win} windows a "
          f"room, {groups} groups of 8 in all")
    per_group = None
    for stream in ("device", "host"):
        args = cli.build_parser().parse_args(
            ["evaluate", "--model-path", pp_dir, "--data-path", data, "--device", str(device),
             "--whole-rooms", "--stream", stream, "--save-results",
             f"{workdir}/rooms_{stream}.json"])
        results, ms, peak, launches = timed_call(lambda: cli.evaluate_from_args(args))
        if results["total_points"] != points or not math.isfinite(results["mean_iou"]):
            raise AssertionError(f"whole rooms, {stream} stream: {results}")
        forwards = groups if stream == "device" else WHOLE_ROOMS * num_win
        if launches["fps"] != 4 * forwards or launches["three_nn"] != 4 * forwards:
            raise AssertionError(f"whole rooms, {stream} stream: {forwards} forwards need 4 fps "
                                 f"and 4 three_nn launches each, got {launches}")
        if stream == "device":
            per_group = {k: v / groups for k, v in launches.items() if v}
        print(f"evaluate --whole-rooms --stream {stream} ({smi}): {ms:.1f} ms, "
              f"{points / (ms / 1e3):.0f} points/s, {ms / WHOLE_ROOMS:.1f} ms a room, peak "
              f"allocated {peak / 2**20:.1f} MiB; launches {launches}; overall accuracy "
              f"{results['overall_accuracy']:.4f}, mean class accuracy "
              f"{results['mean_class_accuracy']:.4f}, mIoU {results['mean_iou']:.4f}")

    card = restore_train_state(pp_dir, create_train_state(create_model("PointNet++"),
                                                          device=device)).model.eval()
    forward = cli.whole_room_forward(card)
    rooms = ChunkedRoomDataset(data, [6], require_index_file=False)
    flips = ties = 0
    with no_plain_version_on_the_card():
        for i in range(len(rooms)):
            room = rooms[i]["x"]
            n = room.shape[0]
            buf = np.zeros((sw._room_pad(n, window, step), room.shape[1]), np.float32)
            buf[:n] = room
            on_device = sw.scene_logits_device(forward, torch.from_numpy(buf).to(device), n,
                                               window, step, 14)[:n].cpu()
            on_host = torch.from_numpy(sw.scene_logits_host(forward, room, window, overlap,
                                                            device))
            top2 = on_host.topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) < NEAR_TIE
            flip = on_device.argmax(-1) != on_host.argmax(-1)
            if (flip & ~tie).any():
                raise AssertionError(f"room {i}: the streams' predictions differ at "
                                     f"{int((flip & ~tie).sum())} points outside near-ties")
            flips, ties = flips + int(flip.sum()), ties + int(tie.sum())
    print(f"whole rooms, device against host stream: predictions differ at {flips} of "
          f"{points} points, all where the top two averaged logits lie within {NEAR_TIE} "
          f"({ties} such points)")

    # one room of 20,000 points on the card against the CPU, same checkpoint
    room = synthetic.make_room(np.random.default_rng(2), 20_000)["points"]
    buf = np.zeros((sw._room_pad(20_000, window, step), 6), np.float32)
    buf[:20_000] = room
    host = restore_train_state(pp_dir, create_train_state(create_model("PointNet++"),
                                                          device="cpu")).model.eval()
    with no_plain_version_on_the_card():
        got = sw.scene_logits_device(forward, torch.from_numpy(buf).to(device), 20_000, window,
                                     step, 14)[:20_000]
    want = sw.scene_logits_device(cli.whole_room_forward(host), torch.from_numpy(buf), 20_000,
                                  window, step, 14)[:20_000]
    near_tie_check("PointNet++ averaged logits of a 20,000-point room, card vs CPU", got, want,
                   1e-4)
    return per_group


def checkpoint_phase(device, workdir: str, smi: str, states: dict, batch) -> dict:
    """Phase 6; returns launches per block batch and per window group."""
    from pointseg_torch.io.checkpoint import save_checkpoint

    run_dir, resumed, steps = train_and_resume(device, workdir)
    restore_bit_for_bit(device, run_dir, resumed, steps, batch[0][:2])
    dg_dir, pn_dir = f"{workdir}/ckpt_dgcnn", f"{workdir}/ckpt_pointnet"
    save_checkpoint(dg_dir, states["DeepGraphCnn"][0],
                    config={"model": "DeepGraphCnn", "static_graph": False})
    save_checkpoint(pn_dir, states["PointNet"][0], config={"model": "PointNet"})
    per_batch = bucketed_eval(device, workdir, smi, run_dir, dg_dir, pn_dir)
    per_group = whole_room_eval(device, workdir, smi, run_dir)
    return {"block batch": per_batch, "window group": per_group}


# Phase 7: `benchmark` as the JAX package's measures it (B=8, N=4096),
# every registry model in both modes, fewer runs than its default
BENCH_B, BENCH_N, BENCH_RUNS, BENCH_WARMUP = 8, 4096, 20, 3
BENCH_ARGS = ("--batch-size", str(BENCH_B), "--num-points", str(BENCH_N),
              "--runs", str(BENCH_RUNS), "--warmup", str(BENCH_WARMUP))
BENCH_KEYS = ["model", "mode", "B", "N", "mean_s", "std_s", "min_s", "max_s", "fps",
              "num_runs", "points_per_sec"]


def path_kernels(model_name: str) -> tuple[str, ...]:
    """The port's kernels a forward pass of `model_name` launches on the
    flat kernels (the default)."""
    from pointseg_torch import cli

    if model_name == "PointNet":
        return ()
    if model_name in cli.DGCNN_NAMES:
        return ("knn", "edge_reduce")
    return ("fps", "ball_query", "three_nn", "gather_rows")


def export_kernels(model_name: str) -> tuple[str, ...]:
    """The operators of an exported graph: EdgeConv's gather-reduce is
    exported as its plain composition, whose gather is `gather_rows`."""
    return tuple("gather_rows" if k == "edge_reduce" else k for k in path_kernels(model_name))


def benchmark_in_process(model_name: str, mode: str, smi: str, flags: tuple = ()) -> dict:
    """`benchmark` through `cli.main` with `flags` added, its line printed
    and checked, the launches of each kernel counted over its calls that
    launched from Python: every forward, and the train steps that ran
    eagerly or were captured (the first two; the others replay)."""
    from pointseg_torch import cli

    out = io.StringIO()
    zero_launches()
    before = step_counts()
    with contextlib.redirect_stdout(out):
        code = cli.main(["benchmark", "--model", model_name, "--mode", mode, *BENCH_ARGS,
                         *flags])
    launches = read_launches()
    (line,) = out.getvalue().strip().splitlines()
    print(line)
    result = json.loads(line)
    needed = path_kernels(model_name)
    calls = launched_steps(before) if mode == "train" else BENCH_RUNS + BENCH_WARMUP
    per_call = {k: v / calls for k, v in launches.items() if v}
    print(f"benchmark {model_name} {mode} {' '.join(flags)} ({smi}): "
          f"{1e3 * result['mean_s']:.3f} ms a call, "
          f"{result['points_per_sec']:.0f} points/s; launches a call {per_call}")
    if code != 0 or list(result) != BENCH_KEYS or (result["B"], result["N"]) != (BENCH_B, BENCH_N) \
            or not all(math.isfinite(result[k]) for k in BENCH_KEYS[4:]):
        raise AssertionError(f"benchmark {model_name} {mode}: exit {code}, {result}")
    wrong = {k: v for k, v in launches.items()
             if (k in needed) != (v > 0) or v % calls}
    if wrong:
        raise AssertionError(f"benchmark {model_name} {mode} must launch {needed} the same "
                             f"number of times each call and no other kernel: {launches}")
    return {**result, "launches_a_call": per_call}


def host_state() -> None:
    """Prints what of this process could slow a host-bound loop: its
    Python and native threads, the objects the garbage collector tracks,
    and the host's load."""
    with open("/proc/self/status") as f:
        native = next(line.split()[1] for line in f if line.startswith("Threads:"))
    print(f"host: {threading.active_count()} Python threads "
          f"({sorted(t.name for t in threading.enumerate())}), {native} native threads, "
          f"{len(gc.get_objects())} objects tracked by the garbage collector (counts "
          f"{gc.get_count()}), load average {os.getloadavg()}")


def run_module(*argv: str) -> str:
    """`python -m pointseg_torch *argv` from the checkout's root, as a
    user starts it; its output printed, its standard output returned.
    Raises unless it exits with 0."""
    done = subprocess.run([sys.executable, "-m", "pointseg_torch", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    print(f"python -m pointseg_torch {' '.join(argv)}: exit {done.returncode}\n"
          f"{done.stdout.strip()}")
    if done.returncode != 0:
        raise AssertionError(f"python -m pointseg_torch {argv}: exit {done.returncode}\n"
                             f"{done.stderr[-3000:]}")
    return done.stdout


def measurement_phase(device, workdir: str, smi: str) -> dict:
    """Phase 7: `benchmark` of every registry model in both modes, the
    subcommand once more as a user starts it, `doctor`, and `train
    PointNet++ --profile`, whose trace must name the port's kernels.
    Returns the benchmark readings by (model, mode)."""
    from pointseg_torch import cli

    t0 = time.time()
    host_state()
    readings = {}
    for model_name in cli.MODEL_CHOICES:
        for mode in ("train", "inference"):
            readings[model_name, mode] = benchmark_in_process(model_name, mode, smi)
        torch.cuda.empty_cache()
    # the host-bound models' in-process readings against this process's
    # state: PointNet++ train again, with the cyclic garbage collector on
    # and off (printed, no claim)
    for collector in ("on", "off"):
        if collector == "off":
            gc.collect()
            gc.disable()
        try:
            again = benchmark_in_process("PointNet++", "train", smi)
        finally:
            gc.enable()
        print(f"benchmark PointNet++ train in process again, garbage collector {collector}: "
              f"{1e3 * again['mean_s']:.3f} ms a call (min {1e3 * again['min_s']:.3f})")
    host_state()

    result = json.loads(run_module("benchmark").strip().splitlines()[-1])
    if list(result) != BENCH_KEYS or [result[k] for k in ("model", "mode", "B", "N", "num_runs")] \
            != ["PointNet++", "train", 8, 4096, 30]:
        raise AssertionError(f"benchmark with its defaults: {result}")
    doctor = run_module("doctor")
    if (torch.cuda.get_device_name(0) not in doctor
            or "CUDA kernels: built and loaded" not in doctor):
        raise AssertionError("doctor must name the card and load the kernels")

    trace_dir = f"{workdir}/trace"
    train_through_cli("PointNet++", workdir, path_kernels("PointNet++"),
                      flags=("--profile", trace_dir))
    with open(f"{trace_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {name: sum(bool(re.search(rf"\b{name}[<(]", k)) for k in kernels)
             for name in own_kernel_names()}
    found = {k: n for k, n in found.items() if n}
    print(f"train PointNet++ --profile: {len(events)} trace events, {len(kernels)} kernel "
          f"launches; the port's kernels named in the trace (launches): {found}")
    if not {"ball_query_kernel", "three_nn_kernel", "gather_rows_kernel"} <= set(found) or \
            not any(k.startswith("fps_") for k in found):
        raise AssertionError(f"the profile names too few of the port's kernels: {found}")
    print(f"phase 7: {time.time() - t0:.1f} s")
    return readings


# Phase 8: bf16 compute (`--bf16`). Kernel 7 at bf16 rows: the
# SetAbstraction groupings of one forward pass at B = 8, N = 4096 of the
# three PointNet++-family models, as (the feature table's points, its
# width h, centroids, K) per model, and DGCNN's EdgeConv gathers, as (B,
# N, h, idx shape).
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
BF16_GATHERS = [(8, N, h, (C, K)) for model in SA_GROUPINGS
                for N, h, C, K in SA_GROUPINGS[model]]
BF16_GATHERS += [(8, 4096, 64, (4096, K_NEIGHBOURS)), (8, 4096, 128, (4096, K_NEIGHBOURS))]
BF16_MODELS = ("PointNet++", "DeepGraphCnn", "PointNeXt", "PointNet")  # trained through the CLI
BF16_LOSS_REL = 2e-2  # bf16 loss against float32, as the JAX package's tests hold it
# card against CPU in bf16, max |Δlogit| over max |logit|: the two round
# bf16 products and sums differently (cuBLAS against the CPU's kernels);
# measured 3.9e-3 to 1.09e-2 on an H100 (PointNet++, PointNet, DeepGraphCnn)
BF16_CARD_CPU_REL = 2e-2


def ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def bf16_gathers(device) -> dict:
    """Kernel 7 on bf16 rows, with and without the float32 coordinate
    table: rows bit-equal to `gather_rows_plain`; the backward (float32
    `index_add_`, cast once) within one bf16 rounding of a float64 sum
    (plus the float32 sum's own rounding); kernel, bound and `torch.gather`
    ms. Returns the summed row of each set of shapes."""
    from pointseg_torch.ops.gather import (
        gather_rows,
        gather_rows_plain,
        gather_rows_with_coords,
    )

    rng = np.random.default_rng(8)
    sums = {}
    for B, N, h, shape in BF16_GATHERS:
        table = torch.from_numpy(rng.normal(size=(B, N, h)).astype(np.float32)).to(
            device, torch.bfloat16)
        coords = torch.rand((B, N, 3), device=device, generator=torch.Generator(device).manual_seed(5))
        idx = torch.from_numpy(rng.integers(0, N, (B, *shape)).astype(np.int32)).to(device)
        rows, crow = gather_rows_with_coords(table, coords, idx)
        if not (torch.equal(rows, gather_rows_plain(table, idx)) and
                torch.equal(crow, gather_rows_plain(coords, idx)) and
                torch.equal(gather_rows(table, idx), rows)):
            raise AssertionError(f"bf16 gather {(B, N, h, shape)} differs from torch.gather")
        ct = torch.randn((B, *shape, h), device=device, dtype=torch.float32,
                         generator=torch.Generator(device).manual_seed(6)).to(torch.bfloat16)
        t = table.clone().requires_grad_(True)
        gather_rows_with_coords(t, coords, idx)[0].backward(ct)
        flat = (idx.reshape(B, -1).long()
                + torch.arange(B, device=device)[:, None] * N).reshape(-1)
        want = torch.zeros((B * N, h), dtype=torch.float64, device=device)
        want.index_add_(0, flat, ct.reshape(-1, h).double())
        mass = torch.zeros_like(want).index_add_(0, flat, ct.reshape(-1, h).double().abs())
        err = (t.grad.reshape(B * N, h).double() - want).abs()
        allowed = ulp_bf16(want) + mass * 2.0 ** -24 * math.prod(shape)
        if t.grad.dtype != torch.bfloat16 or bool((err > allowed).any()):
            raise AssertionError(f"bf16 gather backward {(B, N, h, shape)}: "
                                 f"{int((err > allowed).sum())} sums off by more than one "
                                 f"bf16 rounding")
        for with_coords in (False, True):
            if with_coords:
                def kernel():
                    return gather_rows_with_coords(table, coords, idx)

                def library():
                    return gather_rows_plain(table, idx), gather_rows_plain(coords, idx)
            else:
                def kernel():
                    return gather_rows(table, idx)

                def library():
                    return gather_rows_plain(table, idx)
            ms, lib_ms = timed_pair(kernel, library, 20)
            if with_coords:
                _, nbytes = opwork("gather_rows_with_coords", table, coords, idx)
            else:
                _, nbytes = opwork("gather_rows", table, idx)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            key = "bf16 rows and coordinates" if with_coords else "bf16 rows"
            s = sums.setdefault(key, {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0})
            s["ms"] += ms
            s["bound_ms"] += bound
            s["library_ms"] += lib_ms
            print(f"gather_rows {key:26s} {str((B, N, h, shape)):26s} kernel {ms:8.4f} ms  "
                  f"torch.gather {lib_ms:8.4f} ms  bound {bound:8.5f} ms (bytes)  backward max "
                  f"|err| {float(err.max()):.3g}", flush=True)
    for key, s in sums.items():
        print(f"gather_rows {key}, all {len(BF16_GATHERS)} shapes summed: kernel "
              f"{s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
              f"({100 * s['bound_ms'] / s['ms']:.0f}% of it), torch.gather "
              f"{s['library_ms']:.4f} ms")
    return sums


def bf16_train_through_cli(device, workdir: str, f32_launches: dict, batch) -> dict:
    """`train <model> --bf16` one epoch through the CLI for the four
    models: the sidecar says bf16, the parameters stay float32, the
    launches equal the float32 epoch's of phase 4, and the loss of one
    batch from the trained weights in bf16 lies within BF16_LOSS_REL of
    the float32 loss of the same weights, batch and dropout masks.
    Returns each run's checkpoint directory."""
    from pointseg_torch.models import create_model
    from pointseg_torch.train.loss import masked_onehot_cross_entropy

    dirs = {}
    for name in BF16_MODELS:
        model_dir = f"{workdir}/models_bf16"
        state, launches, records = train_through_cli(
            name, workdir, path_kernels(name), flags=("--bf16", "--model-dir", model_dir))
        if records["config"].get("bf16") is not True:
            raise AssertionError(f"train {name} --bf16: config {records['config']}")
        if {p.dtype for p in state.model.parameters()} != {torch.float32}:
            raise AssertionError(f"train {name} --bf16: parameters not float32")
        if launches != f32_launches[name]:
            raise AssertionError(f"train {name} --bf16 launched {launches}, the float32 epoch "
                                 f"{f32_launches[name]}")
        losses = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = create_model(name, dtype=dtype).to(device)
            model.load_state_dict(state.model.state_dict())
            torch.manual_seed(7)  # the same dropout masks in both
            with torch.no_grad():
                logits = model.train()(batch[0])
            losses[dtype] = float(masked_onehot_cross_entropy(logits, batch[1], batch[2]))
        rel = abs(losses[torch.bfloat16] - losses[torch.float32]) / abs(losses[torch.float32])
        print(f"train {name} --bf16: launches equal the float32 epoch's; loss of one batch "
              f"from its weights, bf16 {losses[torch.bfloat16]:.6f} against float32 "
              f"{losses[torch.float32]:.6f} (relative {rel:.3g}, bound {BF16_LOSS_REL})")
        if not all(math.isfinite(v) for v in losses.values()) or rel > BF16_LOSS_REL:
            raise AssertionError(f"train {name} --bf16: losses {losses}")
        (dirs[name],) = glob.glob(f"{model_dir}/{name}/*")
        del state
    return dirs


def bf16_evaluate(device, workdir: str, smi: str, pp_dir: str) -> None:
    """`evaluate` of the PointNet++ bf16 checkpoint with no flag: bf16 from
    its sidecar, on the phase 6 blocks (buckets 16384 and 65536) and on
    the whole rooms with both streams."""
    from pointseg_torch import cli

    runs = [("blocks", f"{workdir}/eval_blocks", ())]
    runs += [(f"whole rooms, {stream} stream", f"{workdir}/rooms",
              ("--whole-rooms", "--stream", stream)) for stream in ("device", "host")]
    for label, data, flags in runs:
        args = cli.build_parser().parse_args(
            ["evaluate", "--model-path", pp_dir, "--data-path", data, "--device", str(device),
             *flags])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results, ms, peak, launches = timed_call(lambda: cli.evaluate_from_args(args))
        said = out.getvalue()
        score = results["mean_iou"]
        if "computing in bfloat16" not in said or not math.isfinite(score) or \
                any(launches[k] == 0 for k in path_kernels("PointNet++")):
            raise AssertionError(f"evaluate PointNet++ (bf16 sidecar), {label}: mIoU {score}, "
                                 f"launches {launches}\n{said[-2000:]}")
        print(f"evaluate PointNet++ --bf16 from its sidecar, {label} ({smi}): {ms:.1f} ms, "
              f"peak allocated {peak / 2**20:.1f} MiB, mIoU {score:.4f}, launches {launches}")


def bf16_card_against_cpu(device, states: dict, batch) -> None:
    """The same weights and batch in bf16 on the card and on the CPU:
    logits within BF16_CARD_CPU_REL of the largest (eval mode; DeepGraphCnn
    on the static graph, the kNN of the bf16-rounded xyz)."""
    x = batch[0][:2]
    for name, kwargs in (("PointNet++", {}), ("PointNet", {}),
                         ("DeepGraphCnn", {"static_graph": True})):
        card = cpu_copy(name, states[name][0].model, dtype=torch.bfloat16, **kwargs).to(device)
        host = cpu_copy(name, states[name][0].model, dtype=torch.bfloat16, **kwargs)
        with torch.no_grad():
            got = card.eval()(x).cpu()
            want = host.eval()(x.cpu())
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"{name} bf16 eval logits, card against CPU: max |diff| {err:.4g} of max |logit| "
              f"{scale:.4g} ({err / scale:.3g}; bound {BF16_CARD_CPU_REL}), float32 logits "
              f"{got.dtype == torch.float32}")
        if got.dtype != torch.float32 or not torch.isfinite(got).all() or \
                err > BF16_CARD_CPU_REL * scale:
            raise AssertionError(f"{name} bf16 logits, card against CPU: {err} of {scale}")


def batch_norm_faults(device, states: dict, batch) -> None:
    """F8: one PointNet train step at B = 1 on the card (finite loss; the
    TNet's FC BatchNorm gives its bias). F6: training-mode BatchNorm at
    PointNet's (32768, 1024) rows with a mean 300 times the spread, max
    |Δ| against float64 of `F.batch_norm(training=True)` (the old training
    path) beside the port's BatchNorm with a gradient."""
    import torch.nn.functional as F

    from pointseg_torch.nn.mlp import BatchNorm
    from pointseg_torch.train.state import create_train_state, train_step

    one = tuple(t[:1] for t in batch)
    run = create_train_state(cpu_copy("PointNet", states["PointNet"][0].model), device=device)
    loss = float(train_step(run, *one)["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"PointNet train step at B = 1: loss {loss}")
    print(f"F8: PointNet train step at B = 1 on the card: loss {loss:.6f}")

    gen = torch.Generator(device).manual_seed(11)
    x = 3.0 + 0.01 * torch.randn((32768, 1024), device=device, generator=gen)
    want = F.batch_norm(x.double(), None, None, training=True, eps=1e-5)
    old = F.batch_norm(x, None, None, training=True, eps=1e-5)
    bn = BatchNorm(1024).to(device).train()
    bn.running_var.zero_()  # so the update is 0.1 x the batch's statistics
    new = bn(x.clone().requires_grad_(True))
    var, mean = torch.var_mean(x.double(), dim=0, correction=0)
    stats_err = max(float(((bn.running_mean.double() / 0.1 - mean) / mean).abs().max()),
                    float(((bn.running_var.double() / 0.1 - var) / var).abs().max()))
    err_old = float((old.double() - want).abs().max())
    err_new = float((new.detach().double() - want).abs().max())
    print(f"F6 on the card, (32768, 1024) rows at a mean 300x the spread, max |diff| of the "
          f"normalised output against float64: F.batch_norm(training=True) {err_old:.3g}, the "
          f"port's BatchNorm (var_mean statistics, with a gradient) {err_new:.3g}; its "
          f"statistics (relative) {stats_err:.3g}")
    if not err_new < 1e-4:
        raise AssertionError(f"F6: the training BatchNorm lies {err_new} from float64")


def bf16_phase(device, workdir: str, smi: str, states: dict, batch) -> dict:
    """Phase 8; returns the bf16 readings for the summary."""
    t0 = time.time()
    gathers = bf16_gathers(device)
    f32_launches = {name: states[name][1]["cli_launches"] for name in BF16_MODELS}
    dirs = bf16_train_through_cli(device, workdir, f32_launches, batch)
    bf16_evaluate(device, workdir, smi, dirs["PointNet++"])
    readings = {}
    from pointseg_torch import cli

    for model_name in cli.MODEL_CHOICES:
        for mode in ("train", "inference"):
            readings[model_name, mode] = benchmark_in_process(model_name, mode, smi, ("--bf16",))
        torch.cuda.empty_cache()
    bf16_card_against_cpu(device, states, batch)
    batch_norm_faults(device, states, batch)
    print(f"phase 8: {time.time() - t0:.1f} s")
    return {"gathers": gathers, "benchmark": readings}


# Phase 9: the remaining entry points (`train-legacy`, the enhanced DGCNN
# trainer, `export`, `import-torch`, `prepare`) and the shapes only they
# give the kernels: FPS with more centroids than points, kernel 5 at k = 40.
FPS_PAST_N = [(2, 1000, 1024), (8, 100, 128)]  # (B, N, C): SA1 of train-legacy's cut 1000
ENHANCED_K = 40  # create_dgcnn_trainer's k: past the flat kernel's 32
LEGACY_ROOM_POINTS = 20_000
EXPORT_SHAPE = (1, 4096, 9)
EXPORT_MODELS = ("PointNet++", "DeepGraphCnn", "PointNet")
# the artifact's logits against the eager model's on the card: the graph
# holds the same aten ops and the same kernels, so they should be
# bit-equal; 1e-6 would allow a library call that rounds in another order
EXPORT_ATOL = 1e-6


def fps_past_n(device) -> None:
    """FPS with C > N: after N picks every distance is 0 and the lowest
    index repeats, in the kernel as in the plain version (index for
    index)."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.fps import farthest_point_sampling, farthest_point_sampling_plain

    rng = np.random.default_rng(31)
    for B, N, C in FPS_PAST_N:
        pts = torch.from_numpy(block_cloud(rng, B, N)).to(device)
        for start in (torch.zeros(B, dtype=torch.int32, device=device),
                      torch.arange(B, dtype=torch.int32, device=device) * 37 % N):
            before = _kernels.LAUNCHES["fps"]
            got = farthest_point_sampling(pts, C, start_indices=start)
            want = farthest_point_sampling_plain(pts, C, start)
            if _kernels.LAUNCHES["fps"] != before + 1 or not torch.equal(got, want):
                raise AssertionError(f"FPS {(B, N, C)}: the kernel differs from plain at "
                                     f"{int((got != want).sum())} of {got.numel()} picks")
            if len(torch.unique(got[0])) != N or not bool((got[:, N:] == 0).all()):
                raise AssertionError(f"FPS {(B, N, C)}: not every point picked once, then 0")
        us, instance = fps_device(lambda: farthest_point_sampling(pts, C))
        print(f"fps {(B, N, C)} (C > N): kernel equal to plain index for index from two starts; "
              f"{us:.1f} us a launch on the device ({instance})", flush=True)


def knn_2l_at_k40(device) -> None:
    """Kernel 5 at the enhanced trainer's k = 40, (2, 8192, 3) and (2,
    8192, 64): the shape rule runs it (k > 32), slot for slot equal to the
    plain version beyond float64-verified ties; device us a launch beside
    its bound."""
    from pointseg_torch.ops import _kernels
    from pointseg_torch.ops.knn import knn_indices, knn_indices_plain

    rng = np.random.default_rng(32)
    for x_np in (block_cloud(rng, 2, 8192), activations(rng, 2, 8192, 64)):
        x = torch.from_numpy(x_np).to(device)
        B, N, F = x.shape
        before = dict(_kernels.LAUNCHES)
        got = knn_indices(x, ENHANCED_K)
        if (_kernels.LAUNCHES["knn_2l"] != before["knn_2l"] + 1
                or sum(_kernels.LAUNCHES.values()) != sum(before.values()) + 1):
            raise AssertionError(f"kNN {(B, N, F)} k={ENHANCED_K} must launch kernel 5 once")
        flips, gap = check_picks(x, x, got, knn_indices_plain(x, ENHANCED_K))
        us = kernel_device_us(lambda: knn_indices(x, ENHANCED_K), "knn_two_level_kernel", 5)
        flops, nbytes = opwork("knn_indices", x, ENHANCED_K)
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        print(f"knn_2l {(B, N, F)} k={ENHANCED_K}: equal to plain slot for slot ({flips} "
              f"float64-verified tie flips, gap {gap:.3g}); {us:.1f} us a launch on the device; "
              f"bound {bound * 1e6:.1f} us", flush=True)


def legacy_rooms(workdir: str) -> str:
    """Synthetic chunked rooms of 20,000 points, two an area."""
    from pointseg_torch.data import synthetic

    return synthetic.make_chunked_dataset(f"{workdir}/legacy_rooms", rooms_per_area=2,
                                          points_per_room=LEGACY_ROOM_POINTS, seed=0)


def path_run(label: str, needed: tuple[str, ...], run):
    """Runs `run()` with every launch count set to 0 before it and read
    after it; fails unless each kernel of `needed` launched and no other.
    Returns (run's result, the launches)."""
    zero_launches()
    result = run()
    launches = read_launches()
    ran = {k: v for k, v in launches.items() if v}
    if set(ran) != set(needed):
        raise AssertionError(f"{label}: launched {ran}, its path is {needed}")
    print(f"{label}: launches {ran}", flush=True)
    return result, launches


def legacy_batch(rooms: str, device, cut: int | None, sampling: float | None, classes):
    """The first train batch of `train-legacy` at its defaults (batch 2), preprocessed,
    on `device`."""
    from pointseg_torch.data.datasets import create_chunked_dataloaders
    from pointseg_torch.train.legacy import batches

    loader = create_chunked_dataloaders(rooms, batch_size=2)[0]
    return next(batches(loader, classes, cut, sampling, np.random.default_rng(0), device))


def legacy_phase(device, workdir: str, rooms: str) -> None:
    """`train-legacy PointNet++` at its defaults (cut 1000, batch 2, 13
    classes): one epoch, SA1 at C = 1024 > N = 1000; the step's time; the
    card's logits against the CPU's for the same weights and batch."""
    from pointseg_torch import cli
    from pointseg_torch.data.s3dis import S3DIS_CLASSES_13
    from pointseg_torch.train.state import train_step

    args = cli.build_parser().parse_args(
        ["train-legacy", "PointNet++", "--data-dir", rooms, "--epochs", "1",
         "--records-dir", f"{workdir}/legacy_records"])
    before = step_counts()
    (state, records), launches = path_run("train-legacy PointNet++ (one epoch)",
                                          path_kernels("PointNet++"),
                                          lambda: cli.train_legacy_from_args(args))
    forwards = launched_steps(before) + 1  # the steps launched from Python, one eval batch
    if not all(math.isfinite(records[k][0]) for k in ("train_loss", "val_loss")):
        raise AssertionError(f"train-legacy PointNet++: {records}")
    steps = state.step  # the epoch's; its evaluation is one batch of the two area-6 rooms
    batch = legacy_batch(rooms, device, 1000, None, S3DIS_CLASSES_13)
    if batch[0].shape != (2, 1000, 6):
        raise AssertionError(f"train-legacy's batch is {tuple(batch[0].shape)}, not (2, 1000, 6)")
    for _ in range(3):
        train_step(state, *batch)
    step_ms = timed(lambda: train_step(state, *batch), 10)
    print(f"train-legacy PointNet++ (B=2, N=1000, 6 features, SA1 C=1024): {steps} steps, "
          f"loss {records['train_loss'][0]:.4f}, val {records['val_loss'][0]:.4f}; "
          f"{step_ms:.3f} ms a step (CUDA events, 10 steps); launches a forward "
          f"{ {k: v / forwards for k, v in launches.items() if v} }", flush=True)
    model = state.model.eval()
    with torch.no_grad():
        got = model(batch[0]).cpu()
        want = cpu_copy("PointNet++", model, num_classes=13, in_dim=6)(batch[0].cpu())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"train-legacy PointNet++ eval logits card vs CPU: max |diff| "
          f"{float((got - want).abs().max()):.3g}", flush=True)


def enhanced_phase(device, workdir: str, rooms: str) -> int:
    """`create_dgcnn_trainer` at the reference's recommended configuration
    (k = 40, emb 1024, cut 8192, sampling 0.5, batch 2) for one epoch on
    rooms of 20,000 points (8,192 points a sampled room): kernel 5 only,
    never the flat kNN; ms a step, the peak and the memory line. Returns
    the epoch's kernel 5 launches."""
    from pointseg_torch.data.datasets import create_chunked_dataloaders
    from pointseg_torch.data.s3dis import S3DIS_CLASSES
    from pointseg_torch.train.enhanced import create_dgcnn_trainer
    from pointseg_torch.train.state import train_step
    from pointseg_torch.utils.memory import format_memory_usage

    train, cfg = create_dgcnn_trainer(epochs=1, records_dir=f"{workdir}/enhanced")
    if (cfg["k"], cfg["emb_dims"], cfg["cut"], cfg["sampling"]) != (ENHANCED_K, 1024, 8192, 0.5):
        raise AssertionError(f"create_dgcnn_trainer's defaults moved: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    (state, records), launches = path_run("the enhanced DGCNN trainer (one epoch)",
                                   ("knn_2l", "edge_reduce"),
                                   lambda: train(*create_chunked_dataloaders(rooms, batch_size=2)))
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(records["train_loss"][0]):
        raise AssertionError(f"the enhanced trainer: {records}")
    batch = legacy_batch(rooms, device, 8192, 0.5, S3DIS_CLASSES)
    train_step(state, *batch)
    step_ms = timed(lambda: train_step(state, *batch), 5)
    print(f"enhanced DGCNN trainer (B=2, N={batch[0].shape[1]}, k={ENHANCED_K}, emb 1024): "
          f"epoch {records['epoch_times'][0]:.2f} s, loss {records['train_loss'][0]:.4f}; "
          f"{step_ms:.3f} ms a step (CUDA events, 5 steps); peak allocated over the epoch "
          f"{peak / 2**20:.1f} MiB; {format_memory_usage()}", flush=True)
    return launches["knn_2l"]


def export_phase(device, workdir: str) -> None:
    """`export` of PointNet++, DeepGraphCnn and PointNet at (1, 4096, 9)
    through the CLI from a checkpoint: the graph holds the operators, the
    loaded artifact launches the kernels and gives the eager model's
    logits, for the exported weights and for a second checkpoint's; size,
    and forward ms against the eager forward's (CUDA events, in turns)."""
    from pointseg_torch import cli
    from pointseg_torch.io.checkpoint import save_checkpoint
    from pointseg_torch.io.export_aot import load_forward
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    x = torch.from_numpy(np.random.default_rng(33).random(EXPORT_SHAPE).astype(np.float32)
                         ).to(device)
    for name in EXPORT_MODELS:
        states = []
        for seed in (0, 1):
            torch.manual_seed(seed)
            states.append(create_train_state(create_model(name), device=device))
        ckpt = f"{workdir}/export_{name}"
        save_checkpoint(ckpt, states[0], config={"model": name})
        out = f"{workdir}/{name}.pt2"
        t0 = time.time()
        cli.main(["export", ckpt, "--out", out, "--batch-size", str(EXPORT_SHAPE[0]),
                  "--npoints", str(EXPORT_SHAPE[1])])
        export_s = time.time() - t0
        with open(out, "rb") as f:
            blob = f.read()
        graph = str(torch.export.load(io.BytesIO(blob)).graph)
        operators = {k: graph.count(f"pointseg_torch.{k}.default") for k in KERNELS
                     if f"pointseg_torch.{k}.default" in graph}
        if set(operators) != set(export_kernels(name)):
            raise AssertionError(f"export {name}: the graph holds {operators}, its path is "
                                 f"{export_kernels(name)}")
        forward = load_forward(blob)
        for state in states:
            model = state.model.eval()
            got, launches = path_run(f"export {name}: the loaded artifact's forward",
                                     export_kernels(name),
                                     lambda: forward(model.state_dict(), x))
            with torch.no_grad():
                want = model(x)
            err = float((got - want).abs().max())
            if got.shape != (*EXPORT_SHAPE[:2], 14) or not err <= EXPORT_ATOL:
                raise AssertionError(f"export {name}: artifact against eager, max |diff| {err}")
        weights = states[1].model.state_dict()
        eager = states[1].model

        def run_eager():
            with torch.no_grad():
                eager(x)

        artifact_ms = timed(lambda: forward(weights, x), 10)
        eager_ms = timed(run_eager, 10)
        artifact_ms = (artifact_ms + timed(lambda: forward(weights, x), 10)) / 2
        print(f"export {name} {EXPORT_SHAPE}: {len(blob) / 1024:.0f} KB in {export_s:.1f} s, "
              f"operators {operators}; artifact logits = eager (max |diff| {err:.3g}, two "
              f"checkpoints); forward {artifact_ms:.3f} ms artifact, {eager_ms:.3f} ms eager "
              f"(CUDA events, 10 calls, in turns)", flush=True)


def import_and_prepare_phase(device, workdir: str) -> None:
    """`import-torch` of a reference-layout PointNet++ `.pt` (1x1
    convolution weights), then `evaluate --model-path` of the result on
    the blocks of a synthetic room an area (area 6 evaluated); `prepare
    --stage all` on a small raw tree."""
    from pointseg_torch import cli
    from pointseg_torch.data import synthetic
    from pointseg_torch.models import create_model

    torch.manual_seed(5)
    reference = create_model("PointNet++")
    pt = f"{workdir}/reference.pt"
    torch.save({k: v[..., None] if v.dim() == 2 else v
                for k, v in reference.state_dict().items()}, pt)
    out = f"{workdir}/imported"
    cli.main(["import-torch", "--torch-checkpoint", pt, "--model", "PointNet++",
              "--out-dir", out])
    blocks = synthetic.make_block_dataset(f"{workdir}/import_blocks", rooms_per_area=1,
                                          points_per_room=LEGACY_ROOM_POINTS, seed=0,
                                          rgb_u8=True)
    args = cli.build_parser().parse_args(["evaluate", "--model-path", out, "--data-path",
                                          blocks])
    results, _ = path_run("evaluate of the imported PointNet++", path_kernels("PointNet++"),
                          lambda: cli.evaluate_from_args(args))
    if not 0.0 <= results["accuracy"] <= 1.0:
        raise AssertionError(f"evaluate of the imported checkpoint: {results}")

    raw = f"{workdir}/raw/Area_1/office_1/Annotations"
    os.makedirs(raw)
    rng = np.random.default_rng(0)
    for name in ("ceiling_1.txt", "floor_1.txt", "wall_1.txt"):
        np.savetxt(f"{raw}/{name}", np.concatenate(
            [rng.uniform(0, 2, (800, 3)), rng.uniform(0, 255, (800, 3))], axis=1), fmt="%.4f")
    cli.main(["prepare", "--input-path", f"{workdir}/raw", "--areas-path", f"{workdir}/areas",
              "--chunked-path", f"{workdir}/chunks", "--blocks-path", f"{workdir}/blocks",
              "--n-chunks", "2"])
    written = [f"{workdir}/areas/s3dis1.npz", f"{workdir}/chunks/chunked_index.json",
               f"{workdir}/blocks/block_to_coords_mapping.json"]
    if not all(os.path.exists(p) for p in written) or not glob.glob(f"{workdir}/blocks/area_1/*"):
        raise AssertionError("prepare --stage all did not write its files")
    print(f"import-torch PointNet++ then evaluate: accuracy {results['accuracy']:.4f}; prepare "
          f"--stage all wrote {len(glob.glob(f'{workdir}/blocks/area_1/*'))} blocks", flush=True)


def oom_phase(device) -> None:
    """A real `torch.cuda.OutOfMemoryError`, from an allocation larger than
    the card's memory, is an out-of-memory error to `is_oom_error`."""
    from pointseg_torch.runtime import is_oom_error

    total = torch.cuda.get_device_properties(device).total_memory
    try:
        torch.empty(total + 2**30, dtype=torch.uint8, device=device)
    except torch.cuda.OutOfMemoryError as e:
        if not is_oom_error(e):
            raise AssertionError(f"is_oom_error({type(e).__name__}) is false") from e
        print(f"allocating {(total + 2**30) / 2**30:.1f} GiB: {type(e).__name__}, is_oom_error "
              f"true", flush=True)
    else:
        raise AssertionError("an allocation past the card's memory did not raise")


def remaining_entry_points_phase(device, workdir: str) -> int:
    """Phase 9; returns the enhanced trainer's kernel 5 launches."""
    t0 = time.time()
    fps_past_n(device)
    knn_2l_at_k40(device)
    rooms = legacy_rooms(workdir)
    legacy_phase(device, workdir, rooms)
    knn_2l_launches = enhanced_phase(device, workdir, rooms)
    torch.cuda.empty_cache()
    export_phase(device, workdir)
    import_and_prepare_phase(device, workdir)
    oom_phase(device)
    print(f"phase 9: {time.time() - t0:.1f} s")
    return knn_2l_launches


DP_MODELS = {  # phase 10 (b, c): the model -> its path's kernels
    "PointNet++": ("fps", "ball_query", "three_nn", "gather_rows"),
    "PointNet": (),
    "DeepGraphCnn": ("knn", "edge_reduce"),
}
DP_RANK_TIMEOUT = 300  # seconds for one run of ranks
DP_ROOM_POINTS = 20_000
DP_WINDOW = (4096, 512)  # window, overlap
# rank 0's first-step loss on several ranks against one process: the same
# function summed in another order; 1e-5 is about 40 float32 ulps of a loss near 2.7
DP_CLI_LOSS_ATOL = 1e-5


def rank_side():
    """`tests/torch_parallel_ranks.py`: the rank-side runs that phase 10
    shares with `tests/test_torch_parallel.py` (torch and the port only).
    Its directory goes on `sys.path`, which the ranks inherit, so that
    they import it by name."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_parallel_ranks

    return torch_parallel_ranks


def dp_cli_args(device, workdir: str, tag: str, flags: tuple[str, ...]):
    """`train PointNet++` (B = 8, N = 4096, seed 0, one epoch) into logs of
    its own, the host loader reading in one thread (with reader threads
    each block's points are drawn in the order the threads arrive, so two
    runs differ in their batches)."""
    from pointseg_torch import cli

    return cli.build_parser().parse_args([
        "train", "PointNet++", "--synthetic", "--data-dir", f"{workdir}/data",
        "--epochs", "1", "--train-batch-size", "8", "--train-sampling", "4096",
        "--num-workers", "0", "--device", device.type,
        "--log-dir", f"{workdir}/dp_logs/{tag}", "--model-dir", f"{workdir}/dp_models/{tag}",
        *flags])


def dp_first_loss(workdir: str, tag: str) -> float:
    """The first step's loss as the run's one metrics log holds it."""
    (metrics,) = glob.glob(f"{workdir}/dp_logs/{tag}/*/*/metrics.jsonl")
    with open(metrics) as f:
        return next(r["value"] for r in map(json.loads, f) if r["tag"] == "Train/Loss")


def dp_cli_epoch(device, workdir: str, tag: str, flags: tuple[str, ...]):
    """One epoch of `dp_cli_args` in this process; returns (state, records,
    the first step's loss as logged)."""
    from pointseg_torch import cli

    state, records = cli.train_from_args(dp_cli_args(device, workdir, tag, flags))
    return state, records, dp_first_loss(workdir, tag)


def dp_world_one(device, workdir: str, batch, smi: str) -> tuple[dict, float]:
    """Phase 10 (a): `train PointNet++ --data-parallel` on one card (world
    size 1, in this process) in turns with the run without the flag (no
    flag, flag, flag, no flag), each with the counts set to 0 before it;
    the first step's loss equal within 1e-6; the epoch losses printed (not
    compared: `index_add_`'s atomics part two epochs by 1-6%); step ms and
    device ms of both states' steps on phase 4's batch, in turns. Returns
    the times and the first step's loss."""
    from pointseg_torch.train.state import train_step

    timed_steps = rank_side().timed_steps
    runs, by_turn = {}, []
    for turn, flags in enumerate(((), ("--data-parallel",), ("--data-parallel",), ())):
        label = "--data-parallel" if flags else "no flag"
        (state, records, first), _ = path_run(
            f"phase 10 (a) train PointNet++ {label}", DP_MODELS["PointNet++"],
            lambda: dp_cli_epoch(device, workdir, f"turn{turn}", flags))
        if flags and (state.mesh is None or state.mesh.world_size != 1):
            raise AssertionError(f"--data-parallel on one card: world size 1, got {state.mesh}")
        runs.setdefault(label, []).append((state, records["train_loss"][0], first))
        by_turn.append((label, state))
    firsts = [first for turns in runs.values() for _, _, first in turns]
    if max(firsts) - min(firsts) > 1e-6:
        raise AssertionError(f"phase 10 (a): first-step losses differ: {firsts}")
    print(f"phase 10 (a): first-step losses {firsts} (equal within 1e-6); epoch losses "
          + ", ".join(f"{label} {[round(loss, 6) for _, loss, _ in turns]}"
                      for label, turns in runs.items()), flush=True)
    times = {label: [] for label in runs}
    for turn in (0, 1, 2, 3, 3, 2, 1, 0):  # each turn's state, in turns and back
        label, state = by_turn[turn]
        times[label].append(timed_steps(state, batch, train_step, 20))
    for label, readings in times.items():
        print(f"phase 10 (a): {smi}; train PointNet++ {label}, a step on phase 4's batch "
              f"(each turn's state, in turns and back): "
              f"{[round(r['step_ms'], 3) for r in readings]} ms (CUDA events, 20 steps), "
              f"device {[round(r['device_ms'], 3) for r in readings]} ms (profiler), peak "
              f"{readings[0]['peak_mib']:.1f} MiB", flush=True)
    return times, firsts[0]


def dp_cli_ranks(device, workdir: str, want_first: float) -> dict:
    """Phase 10 (e): `train PointNet++ --data-parallel` through the CLI on
    several ranks, one epoch as in (a): two ranks sharing the one card
    (gloo), or one rank a card (NCCL) where there are two or more, started
    by `cli.spawn_training`, as `train --data-parallel` starts them
    standalone on several cards. Each rank is a new process, its launch
    counts 0 at its start, and must launch its path's kernels and no
    other. Rank 0's first-step loss within DP_CLI_LOSS_ATOL of the run
    without the flag; exactly one log directory and one checkpoint, which
    a one-process state restores bit for bit at the epoch's last step."""
    from pointseg_torch import cli
    from pointseg_torch.io.checkpoint import load_checkpoint, restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    cards = torch.cuda.device_count()
    world, visible, backend = (2, str(device.index or 0), "gloo") if cards == 1 else (
        cards, None, "nccl")
    label = f"phase 10 (e) train PointNet++ --data-parallel, {world} ranks ({backend})"
    args = dp_cli_args(device, workdir, "ranks", ("--data-parallel",))
    zero_launches()
    t0 = time.time()
    with visible_cards(visible):
        ranks = cli.spawn_training(args, world, timeout=DP_RANK_TIMEOUT)
    seconds = time.time() - t0
    if any(v for v in read_launches().values()):
        raise AssertionError(f"{label}: this process launched {read_launches()}")
    for rank, r in enumerate(ranks):
        ran = {k: v for k, v in r["launches"].items() if v}
        if set(ran) != set(DP_MODELS["PointNet++"]):
            raise AssertionError(f"{label}: rank {rank} launched {ran}, its path is "
                                 f"{DP_MODELS['PointNet++']}")
    records = ranks[0]["records"]
    if records["config"]["world_size"] != world:
        raise AssertionError(f"{label}: world size {records['config']['world_size']}")
    first = dp_first_loss(workdir, "ranks")
    if not abs(first - want_first) <= DP_CLI_LOSS_ATOL:
        raise AssertionError(f"{label}: first-step loss {first} against {want_first} in one "
                             f"process")
    logs = [p for p in glob.glob(f"{workdir}/dp_logs/ranks/*/*") if os.path.isdir(p)]
    ckpt_dirs = [p for p in glob.glob(f"{workdir}/dp_models/ranks/*/*") if os.path.isdir(p)]
    ckpts = glob.glob(f"{workdir}/dp_models/ranks/*/*/checkpoint_*.pt")
    if len(logs) != 1 or len(ckpt_dirs) != 1 or len(ckpts) != 1:
        raise AssertionError(f"{label}: log directories {logs}, checkpoint directories "
                             f"{ckpt_dirs}, checkpoints {ckpts}: one of each expected")
    torch.manual_seed(0)
    state = create_train_state(create_model("PointNet++", num_classes=cli.NUM_S3DIS_CLASSES,
                                            **cli.filler_switch("PointNet++")),
                               device=device, seed=0)
    restore_train_state(ckpts[0], state)
    saved = load_checkpoint(ckpts[0])["model"]
    got = state.model.state_dict()
    if got.keys() != saved.keys() or any(not torch.equal(got[k].cpu(), saved[k]) for k in saved):
        raise AssertionError(f"{label}: {ckpts[0]} does not restore bit for bit")
    if os.path.basename(ckpts[0]) != f"checkpoint_{state.step}.pt":
        raise AssertionError(f"{label}: {ckpts[0]} restored at step {state.step}")
    ran = [{k: v for k, v in r["launches"].items() if v} for r in ranks]
    print(f"{label}: launches a rank {ran}; "
          f"first-step loss {first:.7f}, one process {want_first:.7f} (|diff| "
          f"{abs(first - want_first):.3g}, bound {DP_CLI_LOSS_ATOL}); epoch loss "
          f"{records['train_loss'][0]:.6f}, val mIoU {records['val_miou'][0]:.4f}, epoch "
          f"{records['epoch_times'][0]:.1f} s, the ranks' run {seconds:.1f} s; one log "
          f"directory, one checkpoint ({os.path.basename(ckpts[0])}), restored bit for bit "
          f"in one process", flush=True)
    return {"world": world, "backend": backend, "first": first, "want_first": want_first,
            "epoch_s": records["epoch_times"][0], "seconds": seconds}


def dp_specs(name: str, batch) -> dict:
    """Phase 10's runs of one model from seed 3 on the global batch: one
    SGD step in float32 (then 10 steps timed) and in float64, three Adam
    steps in float32."""
    common = dict(model=name, seed=3, batch=tuple(t.cpu().numpy() for t in batch),
                  optimizer="sgd", lr=1e-3, steps=1)
    return {"f32": dict(common, timed=10), "f64": dict(common, dtype=torch.float64),
            "adam": dict(common, optimizer="adam", steps=3)}


def dp_max_abs(a: dict, b: dict, key: str) -> float:
    return max(float((a[key][k].double() - b[key][k].double()).abs().max())
               for k in a[key] if a[key][k].numel())


def dp_check(name: str, one: dict, ranks: list, label: str) -> None:
    """The checks of `tests/test_torch_parallel.py`: in float64 the ranks'
    step is the one-process step (loss within 1e-6 relative: float32
    logits; parameters within 1e-9); in float32 the loss within 5e-4 and
    every parameter within 2e-5 plus twice the leaf's float32-to-float64
    distance of the one-process step; FPS picks equal; the two ranks
    bit-equal after three Adam steps; each rank launched its path's kernels
    and no other."""
    for kind in ("f64", "f32"):
        picks = [torch.cat([r[kind]["fps"][i] for r in ranks])
                 for i in range(len(one[kind]["fps"]))]
        if any(not torch.equal(got, want) for got, want in zip(picks, one[kind]["fps"])):
            raise AssertionError(f"{label} {name} {kind}: FPS picks differ from one process")
    r64, o64 = ranks[0]["f64"], one["f64"]
    if (abs(r64["loss"] - o64["loss"]) > 1e-6 * abs(o64["loss"])
            or dp_max_abs(r64, o64, "params") > 1e-9):
        raise AssertionError(f"{label} {name} float64: loss {r64['loss']} against "
                             f"{o64['loss']}, params {dp_max_abs(r64, o64, 'params'):.3g}")
    r32, o32 = ranks[0]["f32"], one["f32"]
    worst = 0.0
    for k, want in o32["params"].items():
        got = (r32["params"][k].double() - want.double()).abs().max()
        noise = (want.double() - o64["params"][k].double()).abs().max()
        worst = max(worst, float(got / (2e-5 + 2.0 * noise)))
    if abs(r32["loss"] - o32["loss"]) >= 5e-4 or worst > 1.0:
        raise AssertionError(f"{label} {name} float32: loss {r32['loss']} against "
                             f"{o32['loss']}; worst parameter at {worst:.3f} of its bound")
    a, b = (r["adam"]["final_params"] for r in ranks)
    if any(not torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{label} {name}: the ranks part after three Adam steps")
    for r in ranks:
        ran = {k for k, v in r["f32"]["launches"].items() if v}
        if ran != set(DP_MODELS[name]):
            raise AssertionError(f"{label} {name} rank {r['f32']['rank']}: launched {ran}, "
                                 f"its path is {DP_MODELS[name]}")
    print(f"phase 10 {label} {name}: float64 loss {r64['loss']:.9f} / {o64['loss']:.9f}, "
          f"params {dp_max_abs(r64, o64, 'params'):.3g} from one process; float32 loss "
          f"{r32['loss']:.7f} / {o32['loss']:.7f}, params {dp_max_abs(r32, o32, 'params'):.3g} "
          f"(worst leaf at {worst:.3f} of 2e-5 + 2x its float32 noise, largest noise "
          f"{dp_max_abs(o32, o64, 'params'):.3g}); FPS picks equal; ranks bit-equal after 3 "
          f"Adam steps; launches a rank {ranks[0]['f32']['launches']}", flush=True)


@contextlib.contextmanager
def visible_cards(cards: str | None):
    """The ranks started in the block see only `cards`
    (CUDA_VISIBLE_DEVICES; None: every card). This process's own CUDA
    context is made already and keeps its cards."""
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    if cards is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = cards
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def dp_two_ranks(device, batch, smi: str, label: str, cards: str | None) -> dict:
    """Phase 10 (b) or (c): two ranks (`parallel.spawn`, one process a rank,
    seeing `cards`: one card, gloo; two, NCCL), 4 rows a rank, against the
    one-process step at B = 8, from the same weights and batch, for each
    model of DP_MODELS; step ms, device ms and peak MiB of a rank beside
    the one-process step's."""
    from pointseg_torch.parallel import Mesh, spawn

    side = rank_side()
    train_run, train_runs = side.train_run, side.train_runs
    specs = {(name, kind): spec for name in DP_MODELS
             for kind, spec in dp_specs(name, batch).items()}
    one = {key: train_run(Mesh(device=device), spec) for key, spec in specs.items()}
    torch.cuda.empty_cache()
    t0 = time.time()
    with visible_cards(cards):  # one run of the ranks for every model
        ranks = spawn(train_runs, 2, (specs,), device=device.type, timeout=DP_RANK_TIMEOUT)
    print(f"phase 10 {label}: the ranks' run {time.time() - t0:.1f} s")
    out = {}
    for name in DP_MODELS:
        dp_check(name, {kind: one[(name, kind)] for kind in ("f32", "f64", "adam")},
                 [{kind: rank[(name, kind)] for kind in ("f32", "f64", "adam")}
                  for rank in ranks], label)
        r = [rank[(name, "f32")] for rank in ranks]
        o = one[(name, "f32")]
        print(f"phase 10 {label}: {smi}; {name} step ms one process (B = 8) {o['step_ms']:.3f}, "
              f"a rank (4 rows) {[round(x['step_ms'], 3) for x in r]}; device ms "
              f"{o['device_ms']:.3f}, a rank {[round(x['device_ms'], 3) for x in r]}; peak MiB "
              f"{o['peak_mib']:.1f}, a rank {[round(x['peak_mib'], 1) for x in r]}; "
              f"collectives a step {r[0]['collectives']:.0f}, host ms in them a rank "
              f"{[round(x['collective_ms'], 3) for x in r]}, NCCL kernels' device ms a rank "
              f"{[round(x['nccl_ms'], 3) for x in r]}", flush=True)
        out[name] = {"one": o, "ranks": r}
    return out


def dp_rooms(device) -> None:
    """Phase 10 (d): whole-room streaming of PointNet++ on one room of
    20,000 points (window 4096, overlap 512, seed 1), each group of 8
    windows shared by two ranks on the card, against unsharded. With
    running statistics the windows' sums are the same additions (a point
    lies in at most two windows): equal predictions, confidences within
    1e-5. With batch statistics each group's statistics are summed in
    another order, which the BatchNorms magnify (a CPU rehearsal at window
    1024 read 8.7e-5): averaged logits within 1e-3 and equal predictions
    outside near-ties (`near_tie_check`)."""
    from pointseg_torch.parallel import Mesh, spawn

    room_run = rank_side().room_run
    rng = np.random.default_rng(0)
    points = np.concatenate([rng.random((DP_ROOM_POINTS, 3)) * np.array([5.0, 5.0, 3.0]),
                             rng.random((DP_ROOM_POINTS, 3))], axis=1).astype(np.float32)
    for mode in ("running", "batch"):
        spec = dict(model="PointNet++", seed=1, points=points, window_size=DP_WINDOW[0],
                    overlap=DP_WINDOW[1], bn_stats=mode)
        want = room_run(Mesh(device=device), spec)
        label = f"phase 10 (d): a room of {DP_ROOM_POINTS} points, window groups on two ranks"
        for r in spawn(room_run, 2, (spec,), device=device.type, timeout=DP_RANK_TIMEOUT):
            if mode == "batch":
                near_tie_check(f"{label}, --bn-stats batch", r["logits"], want["logits"], 1e-3)
                continue
            flips = int((r["preds"] != want["preds"]).sum())
            conf = float(np.abs(r["conf"] - want["conf"]).max())
            if flips or conf > 1e-5:
                raise AssertionError(f"{label}: {flips} predictions differ, confidence "
                                     f"{conf:.3g}")
            print(f"{label}, --bn-stats running: predictions equal, confidences within "
                  f"{conf:.3g}", flush=True)


def data_parallel_phase(device, workdir: str, smi: str, batch) -> dict:
    """Phase 10."""
    t0 = time.time()
    cards = torch.cuda.device_count()
    out = {"world_one": {}}
    if cards == 1:
        out["world_one"], first = dp_world_one(device, workdir, batch, smi)
    else:
        print(f"phase 10 (a): world size 1 not run: with {cards} cards visible "
              f"`--data-parallel` starts {cards} ranks (phase 10 (e)); the run without the "
              f"flag only, for (e)'s first-step loss")
        (_, _, first), _ = path_run("phase 10 (a) train PointNet++ no flag",
                                    DP_MODELS["PointNet++"],
                                    lambda: dp_cli_epoch(device, workdir, "plain", ()))
    torch.cuda.empty_cache()
    out["gloo"] = dp_two_ranks(device, batch, smi, "(b) gloo, two ranks on one card",
                               str(device.index or 0))
    if cards >= 2:
        out["nccl"] = dp_two_ranks(device, batch, smi, "(c) NCCL, two cards", None)
    else:
        print("phase 10 (c): not run (one card; two cards with NCCL need two)")
    with visible_cards(str(device.index or 0)):
        dp_rooms(device)
    out["cli"] = dp_cli_ranks(device, workdir, first)
    print(f"phase 10: {time.time() - t0:.1f} s")
    return out


# Phase 11: the placements of `pointseg/parallel/mesh.py` that no CLI flag
# reaches (M10): a (data, model) = (2, 2) mesh with tensor parallelism, the
# point-sharded forward, the row-sharded compact store and the multichip dry
# run. Four ranks: gloo sharing the one card, or one NCCL rank a card on four.
PLACEMENT_MODELS = {  # full width -> the kernels of its train step
    "PointNet++": ("fps", "ball_query", "three_nn", "gather_rows"),
    "DeepGraphCnn": ("knn", "edge_reduce"),
}
# the JAX package's `sharded_param_fraction` of each model on a model axis of
# 2 (`pointseg.parallel.sharded_param_fraction` of the JAX model's params, on
# the CPU; `tests/test_torch_mesh.py` holds the port's to the same numbers)
JAX_TP_FRACTIONS = {"PointNet++": 0.9870639531881582, "DeepGraphCnn": 0.9864078515139785}
PLACEMENT_RANKS = 4
PLACEMENT_SHAPE = (2, 2)
POINT_CLOUD = 65_536  # the largest eval bucket
STORE_BLOCK = 10_920  # points a block of the timing table: 25,000 blocks of all S3DIS
PLACEMENT_TIMEOUT = 600  # seconds for one run of the ranks
TP_KERNELS = ("fps", "ball_query", "three_nn", "knn", "gather_rows", "gather_rows_flat",
              "edge_reduce")


def tp_side():
    """`tests/torch_tp_ranks.py`, the rank-side runs phase 11 shares with
    `tests/test_torch_tensor_parallel.py` (on `sys.path` as `rank_side`
    puts it)."""
    rank_side()
    import torch_tp_ranks

    return torch_tp_ranks


def placement_jobs(batch, store_case) -> dict:
    """Phase 11's jobs: (a) one SGD step of each model in float64 and in
    float32 (then 5 steps timed) on the 2 x 2 mesh; (b) the point-sharded
    forward of one cloud on four ranks; (c) the synthetic store's batches
    and the timing table's, row-sharded over the four ranks."""
    common = dict(seed=3, shape=PLACEMENT_SHAPE, batch=tuple(t.cpu().numpy() for t in batch),
                  optimizer="sgd", lr=1e-3, steps=1)
    jobs = {}
    for name in PLACEMENT_MODELS:
        jobs[f"f64 {name}"] = ("train", dict(common, model=name, dtype=torch.float64))
        jobs[f"f32 {name}"] = ("train", dict(common, model=name, timed=5))
    cloud = np.concatenate([block_cloud(np.random.default_rng(11), 1, POINT_CLOUD),
                            np.random.default_rng(12).random((1, POINT_CLOUD, 6))], axis=-1)
    jobs["points"] = ("points", dict(model="PointNet++", seed=5, points=cloud.astype(np.float32),
                                     axes=("data", "model"), shape=(PLACEMENT_RANKS, 1),
                                     axis="data"))
    jobs["store"] = ("store", store_case)
    jobs["store timing"] = ("store_timing", dict(rows=S3DIS_ROWS, block=STORE_BLOCK, seed=7,
                                                 batch_size=8, npoints=4096, warmup=3, reps=20))
    return jobs


def synthetic_store_case(workdir: str) -> dict:
    """The synthetic dataset's training blocks (areas 1-5, as phase 4's
    store holds them), a block of the first block's points appended so that
    the rows divide by the ranks, with two batches of given block ids and
    uniforms and two drawn from a seed, B = 8, N = 4096."""
    from pointseg_torch.data import device as dev
    from pointseg_torch.data.datasets import BlockDataset

    pts, labs, counts = dev._load_raw_blocks(
        BlockDataset(f"{workdir}/data", {1, 2, 3, 4, 5}, sampling=None, seed=0), 8)
    counts = np.asarray(counts, np.int64)
    pad = (-len(pts)) % PLACEMENT_RANKS
    if pad:
        pts = np.concatenate([pts, pts[:pad]])
        labs = np.concatenate([labs, labs[:pad]])
        counts = np.append(counts, pad)
    rng = np.random.default_rng(13)
    draws = [(rng.permutation(len(counts))[:8], rng.random((8, 4096), dtype=np.float32))
             for _ in range(2)]
    return dict(layout="compact", points=pts, labels=labs, counts=counts, num_classes=14,
                draws=draws, seed=4, batch_size=8, npoints=4096, steps=2)


def placement_launches(r: dict) -> dict:
    return {k: r["launches"][k] for k in TP_KERNELS}


def placement_check_steps(one: dict, ranks: list, label: str) -> dict:
    """(a): in float64 the gathered parameters of every rank within 1e-12 of
    the one-process step; in float32 within 2e-5 plus twice the leaf's
    float32-to-float64 distance (phase 10's bound); each rank launched its
    model's kernels; the sharded fraction JAX's."""
    out = {}
    for name, path in PLACEMENT_MODELS.items():
        o64, o32 = one[f"f64 {name}"], one[f"f32 {name}"]
        keys = o64["param_keys"]
        worst64 = worst32 = 0.0
        for r in ranks:
            r64, r32 = r[f"f64 {name}"], r[f"f32 {name}"]
            for k in keys:
                worst64 = max(worst64, float((r64["state"][k] - o64["state"][k]).abs().max()))
                noise = float((o32["state"][k].double() - o64["state"][k]).abs().max())
                gap = float((r32["state"][k].double() - o32["state"][k].double()).abs().max())
                worst32 = max(worst32, gap / (2e-5 + 2.0 * noise))
            ran = {k for k, v in r32["launches"].items() if v}
            if ran != set(path):
                raise AssertionError(f"{label} {name} rank {r32['rank']}: launched {ran}, its "
                                     f"path is {path}")
        if worst64 > 1e-12 or worst32 > 1.0:
            raise AssertionError(f"{label} {name}: float64 parameters {worst64:.3g} from one "
                                 f"process (bound 1e-12); float32 worst leaf at {worst32:.3f} "
                                 f"of its bound")
        fraction = ranks[0][f"f32 {name}"]["fraction"]
        if fraction != JAX_TP_FRACTIONS[name]:
            raise AssertionError(f"{label} {name}: sharded fraction {fraction!r}, JAX's "
                                 f"{JAX_TP_FRACTIONS[name]!r}")
        r = [x[f"f32 {name}"] for x in ranks]
        print(f"phase 11 {label} {name}: float64 params {worst64:.3g} from one process (bound "
              f"1e-12), loss {ranks[0][f'f64 {name}']['loss']:.9f} / {o64['loss']:.9f}; float32 "
              f"worst leaf at {worst32:.3f} of 2e-5 + 2x its float32 noise; sharded fraction "
              f"{fraction:.6f}, JAX's {JAX_TP_FRACTIONS[name]:.6f}; placed tensors "
              f"{len(r[0]['placed'])}", flush=True)
        print(f"phase 11 {label}: {name} step ms one process (B = 8) {o32['step_ms']:.3f}, a "
              f"rank {[round(x['step_ms'], 3) for x in r]}; device ms {o32['device_ms']:.3f}, a "
              f"rank {[round(x['device_ms'], 3) for x in r]}; collectives a step "
              f"{[round(x['collectives'], 1) for x in r]} holding "
              f"{[round(x['collective_ms'], 3) for x in r]} host ms; peak MiB "
              f"{o32['peak_mib']:.1f}, a rank {[round(x['peak_mib'], 1) for x in r]}; launches "
              f"a rank (one step) {[placement_launches(x) for x in r]}", flush=True)
        out[name] = {"one": o32, "ranks": r, "worst64": worst64, "worst32": worst32}
    return out


def placement_check_points(one: dict, ranks: list, label: str) -> dict:
    """(b): the ranks' logits within 2e-4 of the unsharded forward's and
    every selection equal (FPS on every rank; ball query and 3-NN rank by
    rank)."""
    split = sorted((r["points"] for r in ranks), key=lambda r: r["index"])
    got = torch.cat([r["logits"] for r in split], 1)
    gap = float((got - one["logits"]).abs().max())
    counted = 0
    for kind, calls in one["picks"].items():
        for i, want in enumerate(calls):
            if kind == "fps":
                same = all(torch.equal(r["picks"][kind][i], want) for r in split)
            else:
                same = torch.equal(torch.cat([r["picks"][kind][i] for r in split], 1), want)
            if not same:
                raise AssertionError(f"{label}: {kind} call {i} differs from the unsharded one")
            counted += 1
    if gap > 2e-4 or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: logits {gap:.3g} from the unsharded forward (2e-4)")
    for r in split:
        ran = {k for k, v in r["launches"].items() if v}
        if ran != set(PLACEMENT_MODELS["PointNet++"]):
            raise AssertionError(f"{label}: a rank launched {ran}")
    print(f"phase 11 {label}: PointNet++ eval forward of (1, {POINT_CLOUD}, 9), a quarter a "
          f"rank: {counted} selections equal to the unsharded forward's, logits within "
          f"{gap:.3g} (bound 2e-4); launches a rank {[placement_launches(r) for r in split]}, "
          f"unsharded {placement_launches(one)}", flush=True)
    return {"gap": gap, "selections": counted}


def placement_check_store(one: dict, timing_one: dict, ranks: list, label: str,
                          smi: str) -> dict:
    """(c): every batch of the sharded synthetic store bit-equal to the
    unsharded store's; each rank launched kernel 8 once a batch on its
    shard; the timing table's ms a batch and each rank's resident bytes."""
    batches = 0
    for r in (x["store"] for x in ranks):
        for got, want in zip(r["given"] + r["drawn"], one["given"] + one["drawn"]):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label}: a sharded batch differs from the unsharded one")
            batches += 1
        if r["launches"]["gather_rows_flat"] != 4 or sum(r["launches"].values()) != 4:
            raise AssertionError(f"{label}: a rank launched {r['launches']} for 4 batches")
    t = [x["store timing"] for x in ranks]
    for r in t:
        if r["launches"]["gather_rows_flat"] != 20 or not r["finite"]:
            raise AssertionError(f"{label}: timing table launches {r['launches']}")
    print(f"phase 11 {label}: {batches} batches of the synthetic compact store (B = 8, N = "
          f"4096) sharded over {PLACEMENT_RANKS} ranks, each bit-equal to the unsharded store's;"
          f" kernel 8 launched once a batch a rank on its shard", flush=True)
    print(f"phase 11 {label}: {smi}; the compact store of {S3DIS_ROWS} rows: ms a sampled batch "
          f"(8 x 4096) unsharded {timing_one['ms']:.3f}, sharded a rank "
          f"{[round(r['ms'], 3) for r in t]} (its all-reduce {[round(r['collective_ms'], 3) for r in t]}"
          f" host ms); resident bytes unsharded {timing_one['nbytes']}, a rank "
          f"{[r['nbytes'] for r in t]}; kernel 8 launches a rank in 20 batches "
          f"{[r['launches']['gather_rows_flat'] for r in t]}", flush=True)
    return {"one": timing_one, "ranks": t}


def placement_phase(device, workdir: str, smi: str, batch) -> dict:
    """Phase 11: (a)-(c) in one run of four ranks (one process a rank,
    `parallel.spawn`), each against this process's one-process run of the
    same job; (d) `dryrun_multichip(4)` through its own ranks."""
    from pointseg_torch.multichip import dryrun_multichip
    from pointseg_torch.parallel import Mesh, spawn

    t0 = time.time()
    side = tp_side()
    jobs = placement_jobs(batch, synthetic_store_case(workdir))
    one = {}
    for name, (task, spec) in jobs.items():
        one[name] = side.TASKS[task](Mesh(device=device), spec)
        torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    shared = cards < PLACEMENT_RANKS
    label = "gloo, four ranks on one card" if shared else "NCCL, one rank a card"
    t1 = time.time()
    with visible_cards(str(device.index or 0) if shared else None):
        ranks = spawn(side.suite, PLACEMENT_RANKS, (jobs,), device="cuda",
                      timeout=PLACEMENT_TIMEOUT)
    print(f"phase 11: the ranks' run ({label}) {time.time() - t1:.1f} s; collectives a rank "
          f"{[r['collectives']['calls'] for r in ranks]}", flush=True)
    out = {"label": label}
    out["steps"] = placement_check_steps(one, ranks, f"(a) {label}")
    out["points"] = placement_check_points(one["points"], ranks, f"(b) {label}")
    out["store"] = placement_check_store(one["store"], one["store timing"], ranks,
                                         f"(c) {label}", smi)
    t1 = time.time()
    with visible_cards(str(device.index or 0) if shared else None):
        line = dryrun_multichip(PLACEMENT_RANKS, device="cuda", timeout=PLACEMENT_TIMEOUT)
    if not line.startswith(f"dryrun_multichip({PLACEMENT_RANKS}): dp=2 x tp=2 train steps ok"):
        raise AssertionError(f"(d): {line}")
    print(f"phase 11 (d) {label}: {time.time() - t1:.1f} s", flush=True)
    out["dryrun"] = line
    print(f"phase 11: {time.time() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if sys.argv[1:]:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2
    started = time.time()
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
    selection_times(device)
    selection_splits(device)
    one_kernel_a_repeat_call(device)
    knn_kernels(device, record)
    gather_kernels(device, record)
    edge_reduce_kernels(device, record)
    gather_flat_kernels(device, record, seed=7)
    torch.cuda.empty_cache()
    pointnext_xl_groupings(device)
    streams_and_graphs(device)

    phase("4. trainers")
    workdir = tempfile.mkdtemp(prefix="pointseg_smoke_")
    try:
        states, launches, batch = trainer_phase(device, workdir)
        phase("5. output against the CPU")
        output_phase(states, batch)
        phase("6. checkpoint, resume and evaluate")
        eval_launches = checkpoint_phase(device, workdir, smi, states, batch)
        phase("7. measurement commands")
        readings = measurement_phase(device, workdir, smi)
        phase("8. bf16")
        bf16 = bf16_phase(device, workdir, smi, states, batch)
        phase("9. the remaining entry points")
        launches["knn_2l"] = remaining_entry_points_phase(device, workdir)
        phase("10. data parallel")
        dp = data_parallel_phase(device, workdir, smi, batch)
        phase("11. placements (M10)")
        placements = placement_phase(device, workdir, smi, batch)
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
          f"queries, forced onto kernel 6); launches are one epoch and its "
          f"evaluation (ball_query_2l: no registered model's path, which queries no ball "
          f"past K = 32; knn_2l: the enhanced DGCNN trainer's epoch at k = 40; "
          f"gather_rows: the PointNet++ epoch, its ms PointNet++'s "
          f"12 gathers; edge_reduce: the DeepGraphCnn epoch, both kernels, its ms a training "
          f"step's forward and backward kernel; gather_rows_flat: one "
          f"PointNet++ epoch from the flat device store, two "
          f"launches a step, its ms the 36-byte and the 1-byte gather of a batch from "
          f"{SYNTHETIC_ROWS} rows); tie flips "
          f"{({k: r['flips'] for k, r in record.rows.items()})}")
    print(f"summary: {smi}; phase 6 launches a block batch (2 blocks, buckets 16384 and 65536) "
          f"and a whole-room window group (8 windows of 4096 points): {eval_launches}")
    for (model_name, mode), r in readings.items():
        print(f"summary: {smi}; benchmark {model_name} {mode} (B=8, N=4096, N(0, 1) points): "
              f"mean {1e3 * r['mean_s']:.3f} ms (min {1e3 * r['min_s']:.3f}, max "
              f"{1e3 * r['max_s']:.3f}), {r['points_per_sec']:.0f} points/s, launches a call "
              f"{r['launches_a_call']}")
    for key, r in bf16["gathers"].items():
        print(f"summary: {smi}; gather_rows on {key} at {len(BF16_GATHERS)} shapes (SA groupings "
              f"of PointNet++, MSG and PointNeXt, DGCNN's two): kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, torch.gather {r['library_ms']:.4f} ms")
    for (model_name, mode), r in bf16["benchmark"].items():
        print(f"summary: {smi}; benchmark --bf16 {model_name} {mode}: mean "
              f"{1e3 * r['mean_s']:.3f} ms, {r['points_per_sec']:.0f} points/s, launches a "
              f"call {r['launches_a_call']}")
    for label, times in dp["world_one"].items():
        print(f"summary: {smi}; train PointNet++ {label} (world size 1) step ms "
              f"{[round(r['step_ms'], 3) for r in times]}, device ms "
              f"{[round(r['device_ms'], 3) for r in times]}")
    for backend in ("gloo", "nccl"):
        for name, r in dp.get(backend, {}).items():
            print(f"summary: {smi}; {name} two ranks ({backend}) against one process at B = 8: "
                  f"step ms {[round(x['step_ms'], 3) for x in r['ranks']]} / "
                  f"{r['one']['step_ms']:.3f}, device ms "
                  f"{[round(x['device_ms'], 3) for x in r['ranks']]} / "
                  f"{r['one']['device_ms']:.3f}, peak MiB "
                  f"{[round(x['peak_mib'], 1) for x in r['ranks']]} / {r['one']['peak_mib']:.1f}"
                  f", collectives a step {r['ranks'][0]['collectives']:.0f} holding "
                  f"{[round(x['collective_ms'], 3) for x in r['ranks']]} host ms a rank")
    r = dp["cli"]
    print(f"summary: {smi}; train PointNet++ --data-parallel on {r['world']} ranks "
          f"({r['backend']}): first-step loss {r['first']:.7f} / {r['want_first']:.7f} in one "
          f"process, epoch {r['epoch_s']:.1f} s, the ranks' run {r['seconds']:.1f} s")
    for name, r in placements["steps"].items():
        print(f"summary: {smi}; {name} 2 x 2 ({placements['label']}) against one process at "
              f"B = 8: step ms {[round(x['step_ms'], 3) for x in r['ranks']]} / "
              f"{r['one']['step_ms']:.3f}, device ms "
              f"{[round(x['device_ms'], 3) for x in r['ranks']]} / {r['one']['device_ms']:.3f}, "
              f"peak MiB {[round(x['peak_mib'], 1) for x in r['ranks']]} / "
              f"{r['one']['peak_mib']:.1f}, collectives a step "
              f"{r['ranks'][0]['collectives']:.0f} holding "
              f"{[round(x['collective_ms'], 3) for x in r['ranks']]} host ms a rank; float64 "
              f"{r['worst64']:.3g} from one process")
    r = placements["store"]
    print(f"summary: {smi}; compact store of {S3DIS_ROWS} rows, ms a sampled batch sharded "
          f"over 4 ranks {[round(x['ms'], 3) for x in r['ranks']]} / unsharded "
          f"{r['one']['ms']:.3f}; resident bytes a rank {r['ranks'][0]['nbytes']} / "
          f"{r['one']['nbytes']}")
    print(f"summary: {placements['dryrun']}")
    print(f"summary: whole script {time.time() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
