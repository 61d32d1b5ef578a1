"""Command-line interface of the port (every subcommand of
`pointseg/cli.py`: `train`, `prepare`, `evaluate`, `export`, `doctor`,
`import-torch`, `benchmark` and `train-legacy`).

    python -m pointseg_torch train PointNet++ [--synthetic] [--data-dir D]
        [--epochs E] [--device cuda] [--model-dir saved_models] ...
    python -m pointseg_torch train <model> --resume CKPT_DIR_OR_FILE
        [--lr-schedule constant|cosine|warmup_cosine] [--warmup-steps W]
        [--grad-clip C]
    python -m pointseg_torch train PointNeXt|PointNeXt-B|PointNeXt-L|PointNet++MSG ...
    python -m pointseg_torch train DeepGraphCnn [--static-graph] ...
    python -m pointseg_torch train <model> --device-data
        [--device-store auto|flat|compact|host] [--pack-cache DIR] [--scan-steps K]
    python -m pointseg_torch train <model> --accum-steps K
    python -m pointseg_torch train <model> --profile DIR
    python -m pointseg_torch train <model> --bf16
    python -m pointseg_torch train <model> --save-confusion
    python -m pointseg_torch train <model> --data-parallel
    torchrun --nproc-per-node N -m pointseg_torch train <model> --data-parallel
    python -m pointseg_torch prepare [--stage all|raw|chunks|index|blocks] ...
    python -m pointseg_torch evaluate --model-path CKPT --data-path D
        [--whole-rooms [--stream device|host]] [--bn-stats running|batch] [--bf16] ...
    python -m pointseg_torch export CKPT --out F.pt2 [--batch-size 1] [--npoints 4096]
        [--platforms cuda|cpu]
    python -m pointseg_torch import-torch --torch-checkpoint F.pt --model M --out-dir D
    python -m pointseg_torch benchmark [--model PointNet++] [--mode train|inference]
        [--batch-size 8] [--num-points 4096] [--runs 30] [--warmup 5] [--bf16]
    python -m pointseg_torch train-legacy <model> [--data-dir test_data] [--cut 1000] ...
    python -m pointseg_torch doctor

Defaults are the reference configuration: Adam lr 1e-3, 10 epochs, batch
8 (test 2), 4096 points, test area 6, 14 classes. `train` writes a
checkpoint and its `config.json` sidecar after every epoch into
`<model-dir>/<model>/<timestamp>`; `evaluate` and `export` read the model
name, `--static-graph` and `--bf16` from that sidecar. `--bf16` computes
activations in bfloat16 with float32 parameters, gradients, Adam state
and logits (`create_model(name, dtype=torch.bfloat16)`), as the JAX
package's `--bf16` does; TF32 stays off. `train --data-parallel` shards
each batch over data-parallel ranks and computes what one process computes
(`pointseg_torch/parallel/`; `train_from_args` says how the ranks start).
The port carries every flag of the JAX CLI. `--device cuda`
(the default of every subcommand that computes: `train`, `evaluate`,
`benchmark`, `import-torch`, `train-legacy`, and `export`'s
`--platforms`) without a CUDA device raises; the port never moves work
to the CPU by itself. `prepare` is numpy only and takes the JAX
package's flags alone.
The JAX package's environment switch POINTSEG_BQ_FILLER selects the
ball-query filler here too (`filler_switch`). Its two-level selection
switch has no counterpart: each op picks its CUDA kernel from the call's
shape (`pointseg_torch/ops/ballquery.py`, `ops/knn.py`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
from datetime import datetime

import torch

from pointseg_torch.data.s3dis import NUM_S3DIS_CLASSES, S3DIS_CLASSES, S3DIS_CLASSES_13

# pointseg_torch.models.MODELS: the JAX package's model names and the port's PointNeXt-XL
MODEL_CHOICES = ["PointNet", "PointNet++", "PointNet++MSG", "PointNeXt",
                 "PointNeXt-B", "PointNeXt-L", "PointNeXt-XL", "DeepGraphCnn", "DGCNN"]
DGCNN_NAMES = ("DeepGraphCnn", "DGCNN")

EVAL_BUCKETS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
BF16_HELP = "Compute in bfloat16 (parameters, gradients and Adam state stay float32)."


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", choices=MODEL_CHOICES, help="Name of the model to train.")
    p.add_argument("--data-dir", default="S3DIS_blocks")
    p.add_argument("--synthetic", action="store_true",
                   help="Generate a synthetic block dataset in --data-dir "
                        "unless it exists (no S3DIS needed).")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--lr-schedule", choices=["constant", "cosine", "warmup_cosine"],
                   default="constant",
                   help="constant reproduces the reference's fixed-rate Adam; the others "
                        "decay over epochs x steps an epoch.")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-clip", type=float, default=None,
                   help="Global-norm gradient clipping.")
    p.add_argument("--train-batch-size", type=int, default=8)
    p.add_argument("--test-batch-size", type=int, default=2)
    p.add_argument("--train-sampling", type=int, default=4096)
    p.add_argument("--test-sampling", type=int, default=None)
    p.add_argument("--test-pad-to", type=int, default=None,
                   help="Static pad size for unsampled test blocks.")
    p.add_argument("--test-areas", type=int, nargs="+", default=[6])
    p.add_argument("--test-pad-mode", choices=["repeat", "zero"], default="repeat",
                   help="Filler for padded eval batches: 'repeat' the block's "
                        "points (default) or 'zero' (the reference's).")
    p.add_argument("--num-workers", type=int, default=4,
                   help="Parallel host block readers (0 = serial).")
    p.add_argument("--device-store", choices=["auto", "flat", "compact", "host"],
                   default="auto",
                   help="With --device-data: force a store layout instead of the "
                        "budget-driven auto chain.")
    p.add_argument("--device-data", action="store_true",
                   help="Keep the whole train split resident in device memory and "
                        "sample blocks/points there (no per-step host I/O or copy; "
                        "with-replacement point sampling). The store lives on --device.")
    p.add_argument("--pack-cache", default=None, metavar="DIR",
                   help="With --device-data: persist the packed device store here, "
                        "keyed by a dataset fingerprint. A hit skips the raw block "
                        "load and the pack, so restarts go straight to the upload. "
                        "Implies compact-first in auto layout (the compact store is "
                        "what gets cached; it samples bit-identically).")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="With --device-data: run the epoch's (sample -> train step) "
                        "iterations with no host read between them and fetch the "
                        "stacked metrics once an epoch (same batches and random "
                        "streams as K=1). Eager PyTorch has no K-step program to fuse; "
                        "K > 1 only selects this path.")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="Gradient accumulation: K consecutive loader batches -> ONE "
                        "optimizer update (mean of micro-batch grads; effective batch "
                        "K*B at single-batch peak memory). Host loaders only; "
                        "mutually exclusive with --scan-steps.")
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--log-dir", default="saved_runs")
    p.add_argument("--model-dir", default="saved_models",
                   help="Checkpoints go to <model-dir>/<model>/<timestamp>.")
    p.add_argument("--resume", default=None, help="Checkpoint dir or file to resume from.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)
    p.add_argument("--static-graph", action="store_true",
                   help="DGCNN models: compute the kNN graph once on xyz and "
                        "reuse it in every EdgeConv.")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the kernels' path) or 'cpu' "
                        "(plain PyTorch versions, for small runs and tests).")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Trace the whole training run with torch.profiler (every host "
                        "thread, the program's spans pointseg_torch.*, and the card's "
                        "kernels on --device cuda) into DIR/trace.json, a Chrome trace.")
    p.add_argument("--save-confusion", action="store_true",
                   help="Draw each epoch's evaluation confusion matrix into "
                        "<log dir>/confusion/confusion_epoch_{n}.png (needs matplotlib; "
                        "without it nothing is written).")
    p.add_argument("--data-parallel", action="store_true",
                   help="Shard each batch over data-parallel ranks, with the result of one "
                        "process: under torchrun its ranks, else one rank a visible card "
                        "(one card, or --device cpu: one rank). NCCL when every rank has a "
                        "card of its own, else gloo.")


def filler_switch(model: str) -> dict:
    """Model arguments from the JAX package's process-wide filler switch,
    read from the environment as it reads it: POINTSEG_BQ_FILLER
    ("repeat", the default, or "index": what fills a sparse ball, which
    changes the output; `pointseg/ops/ballquery.py::filler_mode`; any
    other value is refused). The ball-query models take it as `filler`;
    PointNet and the DGCNNs, which query no ball, take nothing."""
    filler = os.environ.get("POINTSEG_BQ_FILLER", "repeat")
    if filler not in ("repeat", "index"):
        raise SystemExit(f"POINTSEG_BQ_FILLER must be 'repeat' or 'index', got {filler!r}")
    if model == "PointNet" or model in DGCNN_NAMES:
        return {}
    return {"filler": filler}


def resolve_device(name: str) -> torch.device:
    """The `--device` value as a torch device; 'cuda' needs a CUDA device."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is false. "
                           "Pass --device cpu to run the plain PyTorch versions.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def _device_train_loader(args: argparse.Namespace, device: torch.device, say=print):
    """(train loader, mode) of `--device-data`: the device-resident store, by
    the policy chain flat store -> 16 B/point compact store -> chunked
    host prefetcher (`pointseg_torch/data/device.py`). Evaluation keeps the
    host loader: it needs whole blocks, not samples. Under
    `--data-parallel` every rank holds a store of its own, samples the
    global batch and keeps its rows. `say` prints."""
    from pointseg_torch.data.datasets import BlockDataset
    from pointseg_torch.data.device import device_store_or_host_loader

    train_areas = {1, 2, 3, 4, 5, 6} - set(args.test_areas)
    raw_ds = BlockDataset(args.data_dir, train_areas, sampling=None, seed=args.seed)
    if args.pack_cache and args.device_store in ("flat", "host"):
        say(f"note: --pack-cache is ignored with --device-store "
            f"{args.device_store} (only the compact store packs)")
    loader, data_mode = device_store_or_host_loader(
        raw_ds, args.train_batch_size, args.train_sampling, seed=args.seed, device=device,
        num_workers=max(args.num_workers, 4), layout=args.device_store,
        pack_cache=args.pack_cache)
    if data_mode in ("device", "compact"):
        store = loader.store
        say(f"Device-resident train split ({data_mode}): {store.num_blocks} blocks, "
            f"{store.nbytes / 1e6:.1f} MB on {device}.")
    elif args.device_store == "host":
        say("Device store layout forced to host; using the chunked host prefetcher.")
    else:
        why = loader.policy_reason
        say("Device store unavailable" + (f" ({why})" if why else "")
            + "; using the chunked host prefetcher.")
    return loader, data_mode


def train_from_args(args: argparse.Namespace):
    """Runs the `train` subcommand; returns (TrainState, records).

    `--data-parallel` (`pointseg_torch/parallel/`): under `torchrun` this
    process is its rank of torchrun's group; standalone it runs one rank a
    visible card, started by `parallel.spawn` where there are two or more
    (this process then returns (None, rank 0's records)), and in this
    process on one card or the CPU (a mesh of one rank, the one-process
    step). A rank that cannot join, fails or dies fails the command; the
    run never falls back to one process."""
    from pointseg_torch import parallel

    if args.device_data and args.accum_steps > 1:
        # fail before the (possibly long) store build: the accumulation
        # path stacks batches on the host
        raise SystemExit("--accum-steps requires a host loader; drop "
                         "--device-data or --accum-steps")
    device = resolve_device(args.device)
    if not args.data_parallel:
        return _train(args, device, None)
    if parallel.under_torchrun():
        mesh = parallel.create_mesh(device)
        try:
            return _train(args, mesh.device, mesh)
        finally:
            parallel.close_mesh(mesh)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards == 1:
        return _train(args, device, parallel.Mesh(device=device))
    return None, spawn_training(args, cards)[0]["records"]


def spawn_training(args: argparse.Namespace, world_size: int,
                   timeout: float | None = None) -> list[dict]:
    """`train --data-parallel` on `world_size` new ranks, one a card of
    `args.device`'s type (CPU ranks, gloo, share this process's threads),
    within `timeout` seconds (None: no limit); returns each rank's
    {"records", "launches"} (its kernel launch counts), in rank order."""
    from pointseg_torch import parallel

    parallel.refuse_indivisible(args.train_batch_size, parallel.Mesh(world_size=world_size))
    threads = max(1, torch.get_num_threads() // world_size) if args.device == "cpu" else None
    return parallel.spawn(_train_rank, world_size, (args,), device=args.device,
                          timeout=timeout, threads=threads)


def _train_rank(mesh, args: argparse.Namespace) -> dict:
    """One rank of `spawn_training`: its records and kernel launches."""
    from pointseg_torch.ops import _kernels

    records = _train(args, mesh.device, mesh)[1]
    return {"records": records, "launches": dict(_kernels.LAUNCHES)}


def _train(args: argparse.Namespace, device: torch.device, mesh):
    """The `train` subcommand in this process: one process (`mesh` None)
    or one rank of `mesh`, whose rank 0 alone prints, logs and writes."""
    from pointseg_torch import parallel
    from pointseg_torch.data import synthetic
    from pointseg_torch.data.datasets import create_block_dataloaders
    from pointseg_torch.io.checkpoint import restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.runtime import is_oom_error, oom_advice
    from pointseg_torch.train.logging import rank_logger, save_records
    from pointseg_torch.train.loop import train_model
    from pointseg_torch.train.state import STEP_GRAPHS, create_train_state

    main = mesh is None or mesh.rank == 0
    say = print if main else _quiet
    if mesh is not None:
        parallel.refuse_indivisible(args.train_batch_size, mesh)
    switches = filler_switch(args.model)
    model_kwargs = dict(switches)
    if args.static_graph:
        if args.model not in DGCNN_NAMES:
            raise SystemExit("--static-graph only applies to DGCNN models")
        model_kwargs["static_graph"] = True
    torch.manual_seed(args.seed)  # weight init and dropout
    model = create_model(args.model, num_classes=NUM_S3DIS_CLASSES, dtype=_dtype(args.bf16),
                         **model_kwargs)
    _no_tf32()

    if args.synthetic and main and not os.path.exists(args.data_dir):
        print(f"Generating synthetic block dataset at {args.data_dir} ...")
        synthetic.make_block_dataset(args.data_dir, rooms_per_area=2,
                                     points_per_room=20000, seed=args.seed, rgb_u8=True)
    parallel.barrier(mesh)  # the other ranks read what rank 0 made

    run_name = os.path.join(args.model, datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    log_path = os.path.join(args.log_dir, run_name)
    ckpt_dir = os.path.join(args.model_dir, run_name)
    say(f"Starting training of model {args.model} on {device}.")
    train_loader, test_loader = create_block_dataloaders(
        data_dir=args.data_dir,
        test_areas=set(args.test_areas),
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size,
        train_sampling=args.train_sampling,
        test_sampling=args.test_sampling,
        test_pad_to=args.test_pad_to,
        test_buckets=None if args.test_pad_to else EVAL_BUCKETS,
        seed=args.seed,
        num_workers=args.num_workers,
        test_pad_mode=args.test_pad_mode,
    )
    data_mode = "host loader"
    if args.device_data:
        train_loader, data_mode = _device_train_loader(args, device, say)
    say(f"Initialized train dataloader with areas {set(range(1, 7)) - set(args.test_areas)}, "
        f"and test dataloader with areas {set(args.test_areas)}.")
    say("-" * 15)

    state = create_train_state(
        model, device=device, learning_rate=args.learning_rate, seed=args.seed,
        schedule=args.lr_schedule, total_steps=args.epochs * max(len(train_loader), 1),
        warmup_steps=args.warmup_steps, grad_clip=args.grad_clip)
    if args.resume:
        restore_train_state(args.resume, state)
        say(f"Resumed from step {state.step}.")
    config = {k: v for k, v in vars(args).items() if not callable(v) and k != "func"}
    config["data_mode"] = data_mode  # "device", "compact", "host" or "host loader"
    config["filler"] = switches.get("filler")  # None: the model queries no ball
    if mesh is not None:
        # every rank walks the global batches and keeps its rows
        state = parallel.shard_state(mesh, state)
        train_loader = parallel.ShardedLoader(train_loader, mesh)
        config["world_size"] = mesh.world_size
        say(f"Data-parallel over {mesh.world_size} device(s).")
    logger = rank_logger(log_path, 0 if mesh is None else mesh.rank)
    profiler = contextlib.nullcontext()
    if args.profile and main:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # every thread: the host loader's reader threads open spans too
        profiler = torch.profiler.profile(
            activities=activities,
            experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True))
    try:
        with profiler:
            state, records = train_model(
                state, train_loader, test_loader, num_epochs=args.epochs,
                log_interval=args.log_interval, logger=logger,
                num_classes=NUM_S3DIS_CLASSES, ckpt_dir=ckpt_dir, config=config,
                confusion_dir=(os.path.join(log_path, "confusion")
                               if args.save_confusion else None),
                scan_steps=args.scan_steps, accum_steps=args.accum_steps)
    except Exception as e:
        if is_oom_error(e):
            print(oom_advice(args.train_batch_size, args.train_sampling))
        raise
    finally:
        logger.close()
    if not main:
        return state, records
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"Profiler trace written to {args.profile}")
    print("Train steps: " + ", ".join(f"{n} {kind}" for kind, n in STEP_GRAPHS.items()))
    save_records(log_path, "records", records)
    print(f"View logs under: {log_path} (metrics.csv / metrics.jsonl)")
    print(f"Model checkpoints saved to: {ckpt_dir}.")
    return state, records


def _quiet(*args, **kwargs) -> None:
    """`print` of a data-parallel rank other than 0."""


def _no_tf32() -> None:
    """TF32 would round the distances that selections compare."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dtype(bf16: bool) -> torch.dtype:
    """The models' compute dtype for `--bf16`."""
    return torch.bfloat16 if bf16 else torch.float32


def _add_evaluate_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-path", required=True, help="Checkpoint dir or file.")
    p.add_argument("--data-path", required=True)
    p.add_argument("--model", default=None, choices=MODEL_CHOICES + [None],
                   help="Default: the model of the checkpoint's config sidecar.")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--sampling", type=int, default=None)
    p.add_argument("--test-areas", type=int, nargs="+", default=[6])
    p.add_argument("--save-results", default=None)
    p.add_argument("--num-classes", type=int, default=14, choices=[13, 14],
                   help="13 for legacy-stack checkpoints.")
    p.add_argument("--pad-mode", choices=["repeat", "zero"], default="repeat",
                   help="Eval-batch padding filler (see train --test-pad-mode).")
    p.add_argument("--whole-rooms", action="store_true",
                   help="Whole-room sliding-window eval over chunked data.")
    p.add_argument("--window-size", type=int, default=4096)
    p.add_argument("--overlap", type=int, default=512)
    p.add_argument("--stream", choices=["device", "host"], default="device",
                   help="whole-room windows: 'device' keeps each room on the device and "
                        "runs its windows 8 at a time there (one copy each way a room); "
                        "'host' is the reference-shaped per-window loop.")
    p.add_argument("--bn-stats", choices=["running", "batch"], default="running",
                   help="BatchNorm statistics at eval time: 'running' (the checkpoint's "
                        "averages, reference parity) or 'batch' (the eval batch's own, "
                        "test-time adaptation; train/state.py::bn_adapted_model).")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the kernels' path) or 'cpu' (plain PyTorch "
                        "versions).")
    p.add_argument("--bf16", action="store_true",
                   help=BF16_HELP + " Default: the training run's setting in the config "
                        "sidecar; a checkpoint loads either way.")


def whole_room_forward(model: torch.nn.Module, bn_stats: str = "running"):
    """(points (G, W, 6), lengths (G,)) -> logits: the rooms' xyz + rgb
    windows get the blocks' three relative coordinates (x - min_x - 0.5,
    y - min_y - 0.5, z - mid_z) from the min and max of each window's
    valid points (padding kept out by +-1e30), then the model runs in
    eval mode with running or batch BatchNorm statistics."""
    from pointseg_torch.train.loss import length_mask
    from pointseg_torch.train.state import bn_adapted_model

    model.eval()
    run = bn_adapted_model(model) if bn_stats == "batch" else model

    @torch.no_grad()
    def forward9(points: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        m = length_mask(lengths, points.shape[1])[..., None]
        xyz = points[..., :3]
        vmin = torch.where(m, xyz, 1e30).amin(dim=1, keepdim=True)
        vmax = torch.where(m, xyz, -1e30).amax(dim=1, keepdim=True)
        center = torch.cat([vmin[..., 0:1] + 0.5, vmin[..., 1:2] + 0.5,
                            (vmin[..., 2:3] + vmax[..., 2:3]) / 2], dim=-1)
        return run(torch.cat([points, xyz - center], dim=-1))

    return forward9


def evaluate_from_args(args: argparse.Namespace) -> dict:
    """Runs the `evaluate` subcommand; returns its results."""
    from pointseg_torch.data.datasets import (
        ChunkedRoomDataset,
        ListLoader,
        create_block_dataloaders,
    )
    from pointseg_torch.train.loop import evaluate
    from pointseg_torch.train.state import make_eval_step
    from pointseg_torch.utils.evaluation import evaluate_rooms

    device = resolve_device(args.device)
    num_classes = args.num_classes
    class_names = S3DIS_CLASSES[:num_classes]
    state, model_name, use_bf16 = _model_from_sidecar(args.model_path, args.model, num_classes,
                                                      args.bf16, device)
    print(f"Loaded {model_name} from {args.model_path} (step {state.step})"
          f"{', computing in bfloat16' if use_bf16 else ''}.")

    if args.whole_rooms:
        ds = ChunkedRoomDataset(args.data_path, args.test_areas, require_index_file=False)
        results = evaluate_rooms(whole_room_forward(state.model, args.bn_stats),
                                 ListLoader(ds, batch_size=1), class_names,
                                 window_size=args.window_size, overlap=args.overlap,
                                 stream=args.stream, device=device)
        if args.save_results:
            with open(args.save_results, "w") as f:
                json.dump(results, f, indent=2)
            print(f"Results saved to {args.save_results}")
        return results

    _, test_loader = create_block_dataloaders(
        data_dir=args.data_path,
        test_areas=set(args.test_areas),
        test_batch_size=args.batch_size,
        train_sampling=args.sampling or 4096,
        test_sampling=args.sampling,
        test_buckets=EVAL_BUCKETS,
        test_pad_mode=args.pad_mode,
    )
    step_fn = make_eval_step(state.model, "batch") if args.bn_stats == "batch" else None
    results = evaluate(state, test_loader, num_classes=num_classes, step_fn=step_fn)

    print("\n=== Evaluation results ===")
    print(f"Overall accuracy:    {100.0 * results['accuracy']:.2f}%")
    print(f"Mean class accuracy: {100.0 * results['mean_class_accuracy']:.2f}%")
    print(f"Mean IoU:            {100.0 * results['mean_iou']:.2f}%")
    print("Per-class accuracy / IoU:")
    for name, acc, iou in zip(class_names, results["class_accuracies"], results["ious"]):
        print(f"  {name:<10s} {100.0 * float(acc):6.2f}%  {100.0 * float(iou):6.2f}%")

    if args.save_results:
        out = {
            "accuracy": results["accuracy"],
            "mean_class_accuracy": results["mean_class_accuracy"],
            "class_accuracies": {n: float(v)
                                 for n, v in zip(class_names, results["class_accuracies"])},
            "mean_iou": results["mean_iou"],
            "ious": {n: float(v) for n, v in zip(class_names, results["ious"])},
            "confusion": results["confusion"].tolist(),
        }
        with open(args.save_results, "w") as f:
            json.dump(out, f, indent=2)
        print(f"Results saved to {args.save_results}")
    return results


def _add_benchmark_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="PointNet++", choices=MODEL_CHOICES)
    p.add_argument("--mode", choices=["train", "inference"], default="train")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--runs", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the kernels' path, timed with CUDA events) or "
                        "'cpu' (plain PyTorch versions, host clock).")
    p.add_argument("--bf16", action="store_true", help=BF16_HELP)


def benchmark_from_args(args: argparse.Namespace) -> dict:
    """Runs the `benchmark` subcommand: `--runs` timed train steps (Adam
    1e-3) or eval-mode forwards of a freshly initialised model on one
    batch of N(0, 1) points with random one-hot labels, as the JAX
    package's `benchmark` makes them (`np.random.default_rng(0)`); prints
    and returns {model, mode, B, N, mean_s, std_s, min_s, max_s, fps,
    num_runs, points_per_sec}."""
    import numpy as np

    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step
    from pointseg_torch.utils.benchmark import benchmark_points_per_sec

    device = resolve_device(args.device)
    torch.manual_seed(0)  # weight init and dropout
    model = create_model(args.model, num_classes=NUM_S3DIS_CLASSES, dtype=_dtype(args.bf16),
                         **filler_switch(args.model))
    _no_tf32()
    B, N = args.batch_size, args.num_points
    rng = np.random.default_rng(0)
    points = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32)).to(device)
    labels = torch.from_numpy(np.eye(NUM_S3DIS_CLASSES, dtype=np.uint8)[
        rng.integers(0, NUM_S3DIS_CLASSES, size=(B, N))]).to(device)
    lengths = torch.full((B,), N, dtype=torch.int32, device=device)
    state = create_train_state(model, device=device, learning_rate=1e-3, seed=0)

    if args.mode == "train":
        def call():
            train_step(state, points, labels, lengths)
    else:
        model.eval()

        def call():
            with torch.inference_mode():
                model(points)

    stats = benchmark_points_per_sec(call, points_per_call=B * N, num_runs=args.runs,
                                     warmup=args.warmup, device=device)
    result = {"model": args.model, "mode": args.mode, "B": B, "N": N, **stats}
    print(json.dumps(result))
    return result


def doctor_from_args(args: argparse.Namespace) -> None:
    """Runs the `doctor` subcommand: versions, the cards, nvcc, whether
    the kernel library builds and loads, the selection kernels' shape
    rule, the filler switch and the native ETL parser. Exits with 1 where a card is present and the
    kernels fail to build or load."""
    import pointseg_torch
    from pointseg_torch.data.native import get_lib
    from pointseg_torch.ops import _kernels

    print(f"pointseg_torch {pointseg_torch.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none (a CPU build)'}")
    card = torch.cuda.is_available()
    if card:
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired):
            smi = []
        for i in range(torch.cuda.device_count()):
            shown = smi[i] if i < len(smi) else "nvidia-smi: not available"
            print(f"cuda:{i}: {torch.cuda.get_device_name(i)} [{shown}]")
    else:
        print("cuda: unavailable (torch.cuda.is_available() is false; --device cpu runs the "
              "plain PyTorch versions)")
    try:
        nvcc = _kernels._nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
        print(f"nvcc: {nvcc} ({version[-1] if version else 'no version printed'})")
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        print(f"nvcc: not found ({e})")
    failed = False
    if card:
        try:
            _kernels.library()
            print(f"CUDA kernels: built and loaded ({_kernels.build()})")
        except Exception as e:  # any build or load failure is the report
            print(f"CUDA kernels: FAILED to build or load: {e}")
            failed = True
    else:
        print("CUDA kernels: not built (no card)")
    print("selection kernels: by shape (ball query: flat at K <= 32, two-level past it; kNN: "
          "flat at k <= 32 and F <= 512, two-level past either)")
    try:
        print(f"ball-query filler mode: {filler_switch('PointNet++')['filler']}")
    except SystemExit as e:
        print(f"filler switch refused by train and evaluate: {e}")
    print(f"native ETL parser: "
          f"{'available' if get_lib() is not None else 'unavailable (Python fallback)'}")
    if failed:
        raise SystemExit(1)


def _add_prepare_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--stage", choices=["all", "raw", "chunks", "index", "blocks"],
                   default="all")
    p.add_argument("--input-path", default="data/s3dis")
    p.add_argument("--areas-path", default="data")
    p.add_argument("--chunked-path", default="data_chunked")
    p.add_argument("--blocks-path", default="S3DIS_blocks")
    p.add_argument("--n-chunks", type=int, default=10)
    p.add_argument("--force", action="store_true")


def prepare_from_args(args: argparse.Namespace) -> None:
    """Runs the `prepare` subcommand: the offline ETL raw S3DIS -> areas ->
    chunks -> chunk index -> blocks, over the port's copies of the data
    layer (`data/prepare.py`, `data/blocks.py`); numpy only."""
    from pointseg_torch.data.blocks import preprocess_dataset
    from pointseg_torch.data.prepare import precompute_chunk_index, prepare_s3dis, split_chunks

    stage = args.stage
    if stage in ("all", "raw"):
        prepare_s3dis(args.input_path, args.areas_path)
    if stage in ("all", "chunks"):
        split_chunks(args.areas_path, args.chunked_path, n_chunks=args.n_chunks)
    if stage in ("all", "index"):
        precompute_chunk_index(args.chunked_path, force_recompute=args.force)
    if stage in ("all", "blocks"):
        preprocess_dataset(args.chunked_path, args.blocks_path)


def _add_export_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("model_path", help="Checkpoint file or directory.")
    p.add_argument("--out", required=True, help="Output artifact path (torch.export, .pt2).")
    p.add_argument("--model", default=None, choices=MODEL_CHOICES + [None],
                   help="Default: the model of the checkpoint's config sidecar.")
    p.add_argument("--num-classes", type=int, default=NUM_S3DIS_CLASSES)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--npoints", type=int, default=4096,
                   help="Serving shape: export one artifact per bucket.")
    p.add_argument("--bf16", action="store_true",
                   help=BF16_HELP + " Default: the training run's setting in the sidecar.")
    p.add_argument("--platforms", "--device", dest="platforms", default="cuda",
                   help="The device the artifact is traced on and runs on: 'cuda' "
                        "(default; the kernels' path) or 'cpu'. One only: a torch.export "
                        "artifact has one device.")


def _export_device(platforms: str) -> torch.device:
    """`--platforms` as the one device of the trace."""
    names = [p for p in platforms.split(",") if p]
    if len(names) != 1:
        raise SystemExit(f"--platforms {platforms}: a torch.export artifact is for one device; "
                         "export once for each of them")
    if names[0] not in ("cuda", "cpu"):
        raise SystemExit(f"--platforms {platforms}: pointseg_torch exports for 'cuda' or "
                         "'cpu' (a TPU artifact comes from the JAX package's export)")
    return resolve_device(names[0])


def _model_from_sidecar(model_path: str, model: str | None, num_classes: int, bf16: bool,
                        device: torch.device):
    """(TrainState restored from a checkpoint, model name, bf16): the model
    named by `model` or the config sidecar, built with the filler switch,
    the sidecar's `--static-graph` for a DGCNN and its `--bf16` unless
    `bf16` is given."""
    from pointseg_torch.io.checkpoint import load_config, restore_train_state
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    ckpt_dir = model_path if os.path.isdir(model_path) else os.path.dirname(model_path)
    config = load_config(ckpt_dir) or {}
    use_bf16 = bf16 or bool(config.get("bf16"))  # the training run's, unless given
    model_name = model or config.get("model", "PointNet++")
    model_kwargs = filler_switch(model_name)
    if config.get("static_graph") and model_name in DGCNN_NAMES:
        model_kwargs["static_graph"] = True  # the graph mode the model was trained in
    net = create_model(model_name, num_classes=num_classes, dtype=_dtype(use_bf16),
                       **model_kwargs)
    _no_tf32()
    state = restore_train_state(model_path, create_train_state(net, device=device))
    return state, model_name, use_bf16


def export_from_args(args: argparse.Namespace) -> bytes:
    """Runs the `export` subcommand: the checkpoint's eval-mode forward at
    (--batch-size, --npoints, 9) as a `torch.export` artifact in --out,
    with the weights left out (`pointseg_torch/io/export_aot.py`); returns
    the artifact's bytes."""
    from pointseg_torch.io.export_aot import export_forward

    device = _export_device(args.platforms)
    state, model_name, use_bf16 = _model_from_sidecar(args.model_path, args.model,
                                                      args.num_classes, args.bf16, device)
    example = torch.zeros((args.batch_size, args.npoints, 9), device=device)
    blob = export_forward(state.model, example, device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"Exported {model_name} (B={args.batch_size}, N={args.npoints}, "
          f"platforms={device.type}{', bf16' if use_bf16 else ''}) -> {args.out} "
          f"({len(blob) / 1024:.0f} KB)")
    return blob


IMPORT_CHOICES = ["PointNet", "PointNet++", "PointNeXt", "DGCNN", "DeepGraphCnn"]


def _add_import_torch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--torch-checkpoint", required=True,
                   help="Reference .pt file holding a state_dict (torch.save(model."
                        "state_dict(), path)); a pickled model object is refused.")
    p.add_argument("--model", required=True, choices=IMPORT_CHOICES,
                   help="Model family the checkpoint belongs to (DeepGraphCnn = the "
                        "colour-branch DGCNN of the main CLI; DGCNN = the plain variant).")
    p.add_argument("--out-dir", required=True,
                   help="Destination checkpoint directory (with a config.json sidecar, so "
                        "`evaluate --model-path <out-dir>` finds the model).")
    p.add_argument("--num-classes", type=int, default=14, choices=[13, 14])
    p.add_argument("--num-points", type=int, default=4096,
                   help="Accepted as the JAX package's command line has it, where it sizes "
                        "an example input; no parameter shape depends on it, and the port "
                        "builds its models without one.")
    p.add_argument("--device", default="cuda",
                   help="Where the model is built and saved from: 'cuda' (default) or 'cpu'.")


def import_torch_from_args(args: argparse.Namespace) -> str:
    """Runs the `import-torch` subcommand: a reference PyTorch state_dict
    becomes a port checkpoint at step 0 with the sidecar {model,
    num_classes, imported_from}. The port keeps the reference's keys but
    in the DGCNNs, and its Linear weights drop the reference's 1x1
    convolution dims (`io/torch_import.py`); the result loads with
    `load_state_dict(strict=True)`. Read with
    `torch.load(weights_only=True)`: a pickled model object would need the
    reference's classes and unpickling runs their code, so it is refused
    with a message. Returns the checkpoint's path."""
    import pickle

    from pointseg_torch.io.checkpoint import save_checkpoint
    from pointseg_torch.io.torch_import import from_reference_state_dict
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state

    device = resolve_device(args.device)
    ask = ("; save the model's state_dict instead (torch.save(model.state_dict(), path)) and "
           "import that file")
    try:
        state_dict = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise SystemExit(f"{args.torch_checkpoint} holds a pickled object, not a state_dict "
                         f"({str(e).splitlines()[0]}){ask}") from e
    if not isinstance(state_dict, dict) or not all(
            isinstance(v, torch.Tensor) for v in state_dict.values()):
        raise SystemExit(f"{args.torch_checkpoint} holds a {type(state_dict).__name__}, not a "
                         f"state_dict of tensors{ask}")
    model = create_model(args.model, num_classes=args.num_classes)
    model.load_state_dict(from_reference_state_dict(args.model, state_dict, model), strict=True)
    state = create_train_state(model, device=device)
    config = {"model": args.model, "num_classes": args.num_classes,
              "imported_from": os.path.abspath(args.torch_checkpoint)}
    path = save_checkpoint(args.out_dir, state, step=0, config=config)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Imported {args.model} ({n_params:,} params) from {args.torch_checkpoint}\n"
          f"  -> {path}")
    print(f"Evaluate it with: python -m pointseg_torch evaluate --model-path {args.out_dir} "
          f"--data-path <blocks> --num-classes {args.num_classes}")
    return path


def _add_train_legacy_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", choices=MODEL_CHOICES)
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--cut", type=int, default=1000)
    p.add_argument("--sampling", type=float, default=None)
    p.add_argument("--num-classes", type=int, default=13, choices=[13, 14])
    p.add_argument("--no-index", action="store_true")
    p.add_argument("--test-on-train", action="store_true")
    p.add_argument("--records-dir", default="saved_training/history")
    p.add_argument("--records-filename", default="records")
    p.add_argument("--seed", type=int, default=0,
                   help="Fixes the weights, the FPS generator and the point sampling.")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the kernels' path) or 'cpu' (plain PyTorch "
                        "versions).")


def train_legacy_from_args(args: argparse.Namespace):
    """Runs the `train-legacy` subcommand: the legacy/chunked stack
    (`pointseg_torch/train/legacy.py`) on 6-feature (xyz + rgb) chunked
    rooms, the model built for that width; returns (TrainState, records)."""
    from pointseg_torch.data.datasets import create_chunked_dataloaders
    from pointseg_torch.models import create_model
    from pointseg_torch.train.legacy import train_model as legacy_train
    from pointseg_torch.train.state import create_train_state

    device = resolve_device(args.device)
    mapping = S3DIS_CLASSES_13 if args.num_classes == 13 else S3DIS_CLASSES
    train_loader, test_loader = create_chunked_dataloaders(
        args.data_dir, batch_size=args.batch_size, require_index_file=not args.no_index)
    if args.test_on_train:
        test_loader = train_loader  # the reference's small-excerpt mode
    torch.manual_seed(args.seed)  # weight init and dropout
    model = create_model(args.model, num_classes=len(mapping), in_dim=6,
                         **filler_switch(args.model))
    _no_tf32()
    state = create_train_state(model, device=device, learning_rate=args.learning_rate,
                               seed=args.seed)
    return legacy_train(state, train_loader, test_loader, mapping, epochs=args.epochs,
                        print_records=True, records_dir=args.records_dir,
                        records_filename=args.records_filename, cut=args.cut,
                        sampling=args.sampling, seed=args.seed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pointseg_torch",
        description="pointseg's PyTorch / CUDA port: trains, evaluates, exports and "
                    "benchmarks PointNet, PointNet++ (SSG and MSG), PointNeXt (-B, -L, -XL) and "
                    "the DGCNNs.")
    sub = parser.add_subparsers(dest="command", required=True)
    train = sub.add_parser("train", help="Train a model on block data.")
    _add_train_args(train)
    train.set_defaults(func=train_from_args)
    evaluate = sub.add_parser("evaluate", help="Evaluate a checkpoint.")
    _add_evaluate_args(evaluate)
    evaluate.set_defaults(func=evaluate_from_args)
    benchmark = sub.add_parser("benchmark", help="Micro-benchmark a model.")
    _add_benchmark_args(benchmark)
    benchmark.set_defaults(func=benchmark_from_args)
    doctor = sub.add_parser("doctor", help="Environment and kernel diagnostics.")
    doctor.set_defaults(func=doctor_from_args)
    prepare = sub.add_parser("prepare", help="Offline ETL: raw S3DIS -> blocks.")
    _add_prepare_args(prepare)
    prepare.set_defaults(func=prepare_from_args)
    export = sub.add_parser("export", help="Export a checkpoint's forward as a torch.export "
                                           "serving artifact.")
    _add_export_args(export)
    export.set_defaults(func=export_from_args)
    import_torch = sub.add_parser("import-torch", help="Convert a reference PyTorch .pt "
                                                       "state_dict to a pointseg_torch "
                                                       "checkpoint.")
    _add_import_torch_args(import_torch)
    import_torch.set_defaults(func=import_torch_from_args)
    legacy = sub.add_parser("train-legacy", help="Legacy/chunked-stack trainer.")
    _add_train_legacy_args(legacy)
    legacy.set_defaults(func=train_legacy_from_args)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0
