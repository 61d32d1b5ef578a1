"""Command-line interface of the port (the `train` subcommand of
`pointseg/cli.py`).

    python -m pointseg_torch train PointNet++ [--synthetic] [--data-dir D]
        [--epochs E] [--device cuda] ...
    python -m pointseg_torch train PointNeXt|PointNeXt-B|PointNeXt-L|PointNet++MSG ...
    python -m pointseg_torch train DeepGraphCnn [--static-graph] ...
    python -m pointseg_torch train <model> --device-data
        [--device-store auto|flat|compact|host] [--pack-cache DIR] [--scan-steps K]
    python -m pointseg_torch train <model> --accum-steps K

Defaults are the reference configuration: Adam lr 1e-3, 10 epochs, batch
8 (test 2), 4096 points, test area 6, 14 classes. Flags of the JAX
trainer that the port does not carry yet are accepted by the parser only
to be refused with a pointer to ROADMAP.md. `--device cuda` without a
CUDA device raises; the port never moves work to the CPU by itself.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from pointseg_torch.data.s3dis import NUM_S3DIS_CLASSES

# the JAX package's model names; pointseg_torch.models says which are ported
MODEL_CHOICES = ["PointNet", "PointNet++", "PointNet++MSG", "PointNeXt",
                 "PointNeXt-B", "PointNeXt-L", "DeepGraphCnn", "DGCNN"]
DGCNN_NAMES = ("DeepGraphCnn", "DGCNN")

# JAX trainer flags not carried yet: (flag, argparse kwargs)
_NOT_PORTED = (
    ("--bf16", dict(action="store_true")),
    ("--resume", dict(default=None)),
    ("--model-dir", dict(default=None)),
    ("--data-parallel", dict(action="store_true")),
    ("--warmup-steps", dict(type=int, default=0)),
    ("--grad-clip", dict(type=float, default=None)),
    ("--profile", dict(default=None)),
    ("--save-confusion", dict(action="store_true")),
)


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", choices=MODEL_CHOICES, help="Name of the model to train.")
    p.add_argument("--data-dir", default="S3DIS_blocks")
    p.add_argument("--synthetic", action="store_true",
                   help="Generate a synthetic block dataset in --data-dir "
                        "unless it exists (no S3DIS needed).")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--lr-schedule", default="constant",
                   help="Only 'constant' (the reference's fixed-rate Adam) is ported.")
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--static-graph", action="store_true",
                   help="DGCNN models: compute the kNN graph once on xyz and "
                        "reuse it in every EdgeConv.")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; the kernels' path) or 'cpu' "
                        "(plain PyTorch versions, for small runs and tests).")
    for flag, kwargs in _NOT_PORTED:
        p.add_argument(flag, help=argparse.SUPPRESS, **kwargs)


def _refuse_unported(args: argparse.Namespace) -> None:
    given = [flag for flag, kwargs in _NOT_PORTED
             if getattr(args, flag[2:].replace("-", "_")) != kwargs.get("default",
                                                                       False)]
    if args.lr_schedule != "constant":
        given.append(f"--lr-schedule {args.lr_schedule}")
    if given:
        raise SystemExit(f"not yet ported to pointseg_torch: {', '.join(given)}; "
                         "see ROADMAP.md for the order of the port")


def resolve_device(name: str) -> torch.device:
    """The `--device` value as a torch device; 'cuda' needs a CUDA device."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is false. "
                           "Pass --device cpu to run the plain PyTorch versions.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def _device_train_loader(args: argparse.Namespace, device: torch.device):
    """(train loader, mode) of `--device-data`: the device-resident store, by
    the policy chain flat store -> 16 B/point compact store -> chunked
    host prefetcher (`pointseg_torch/data/device.py`). Evaluation keeps the
    host loader: it needs whole blocks, not samples."""
    from pointseg_torch.data.datasets import BlockDataset
    from pointseg_torch.data.device import device_store_or_host_loader

    train_areas = {1, 2, 3, 4, 5, 6} - set(args.test_areas)
    raw_ds = BlockDataset(args.data_dir, train_areas, sampling=None, seed=args.seed)
    if args.pack_cache and args.device_store in ("flat", "host"):
        print(f"note: --pack-cache is ignored with --device-store "
              f"{args.device_store} (only the compact store packs)")
    loader, data_mode = device_store_or_host_loader(
        raw_ds, args.train_batch_size, args.train_sampling, seed=args.seed, device=device,
        num_workers=max(args.num_workers, 4), layout=args.device_store,
        pack_cache=args.pack_cache)
    if data_mode in ("device", "compact"):
        store = loader.store
        print(f"Device-resident train split ({data_mode}): {store.num_blocks} blocks, "
              f"{store.nbytes / 1e6:.1f} MB on {device}.")
    elif args.device_store == "host":
        print("Device store layout forced to host; using the chunked host prefetcher.")
    else:
        why = loader.policy_reason
        print("Device store unavailable" + (f" ({why})" if why else "")
              + "; using the chunked host prefetcher.")
    return loader, data_mode


def train_from_args(args: argparse.Namespace):
    """Runs the `train` subcommand; returns (TrainState, records)."""
    from pointseg_torch.data import synthetic
    from pointseg_torch.data.datasets import create_block_dataloaders
    from pointseg_torch.models import create_model
    from pointseg_torch.train.logging import MetricsLogger, save_records
    from pointseg_torch.train.loop import train_model
    from pointseg_torch.train.state import create_train_state

    _refuse_unported(args)
    if args.device_data and args.accum_steps > 1:
        # fail before the (possibly long) store build: the accumulation
        # path stacks batches on the host
        raise SystemExit("--accum-steps requires a host loader; drop "
                         "--device-data or --accum-steps")
    device = resolve_device(args.device)
    model_kwargs = {}
    if args.static_graph:
        if args.model not in DGCNN_NAMES:
            raise SystemExit("--static-graph only applies to DGCNN models")
        model_kwargs["static_graph"] = True
    torch.manual_seed(args.seed)  # weight init and dropout
    model = create_model(args.model, num_classes=NUM_S3DIS_CLASSES, **model_kwargs)
    # TF32 would round the distances that selections compare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.synthetic and not os.path.exists(args.data_dir):
        print(f"Generating synthetic block dataset at {args.data_dir} ...")
        synthetic.make_block_dataset(args.data_dir, rooms_per_area=2,
                                     points_per_room=20000, seed=args.seed, rgb_u8=True)

    run_name = os.path.join(args.model, datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    log_path = os.path.join(args.log_dir, run_name)
    print(f"Starting training of model {args.model} on {device}.")
    train_loader, test_loader = create_block_dataloaders(
        data_dir=args.data_dir,
        test_areas=set(args.test_areas),
        train_batch_size=args.train_batch_size,
        test_batch_size=args.test_batch_size,
        train_sampling=args.train_sampling,
        test_sampling=args.test_sampling,
        test_pad_to=args.test_pad_to,
        test_buckets=None if args.test_pad_to else
        (1024, 2048, 4096, 8192, 16384, 32768, 65536),
        seed=args.seed,
        num_workers=args.num_workers,
        test_pad_mode=args.test_pad_mode,
    )
    data_mode = "host loader"
    if args.device_data:
        train_loader, data_mode = _device_train_loader(args, device)
    print(f"Initialized train dataloader with areas {set(range(1, 7)) - set(args.test_areas)}, "
          f"and test dataloader with areas {set(args.test_areas)}.")
    print("-" * 15)

    state = create_train_state(model, device=device, learning_rate=args.learning_rate,
                               seed=args.seed)
    config = {k: v for k, v in vars(args).items() if not callable(v) and k != "func"}
    config["data_mode"] = data_mode  # "device", "compact", "host" or "host loader"
    logger = MetricsLogger(log_path)
    try:
        state, records = train_model(
            state, train_loader, test_loader, num_epochs=args.epochs,
            log_interval=args.log_interval, logger=logger,
            num_classes=NUM_S3DIS_CLASSES, config=config,
            scan_steps=args.scan_steps, accum_steps=args.accum_steps)
    finally:
        logger.close()
    save_records(log_path, "records", records)
    print(f"View logs under: {log_path} (metrics.csv / metrics.jsonl)")
    return state, records


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pointseg_torch",
        description="pointseg's PyTorch / CUDA port: trains PointNet++ (SSG and MSG), "
                    "PointNeXt (-B, -L) and the DGCNNs.")
    sub = parser.add_subparsers(dest="command", required=True)
    train = sub.add_parser("train", help="Train a model on block data.")
    _add_train_args(train)
    train.set_defaults(func=train_from_args)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    args.func(args)
    return 0
