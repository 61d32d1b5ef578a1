"""Entry points of the compile check and the multi-device dry run (port of
`__graft_entry__.py`: `entry` and `dryrun_multichip`).

    python -c "from pointseg_torch.multichip import dryrun_multichip; dryrun_multichip(4)"
    python -c "from pointseg_torch.multichip import dryrun_multichip; \\
               dryrun_multichip(4, device='cpu')"

The first starts four ranks on the visible cards (one a card where there
are four, else sharing them), the second four on the CPU; a script that
calls `dryrun_multichip(4)` under `torchrun --nproc-per-node 4` runs one
rank a process.

`dryrun_multichip(n)` runs, on n ranks, every placement of
`pointseg_torch/parallel/`: a (dp, tp) = (n / tp, tp) mesh (tp = 2 for
an even n >= 4, else 1) on which PointNet++, PointNet, PointNeXt and
DeepGraphCnn (the JAX dry run's geometry-only DGCNN, k = 8, emb 128) each
take one Adam step placed by `shard_state_tp` at B = 2n, N = 128; a
point-sharded PointNet++ forward of (1, 512 n, 9) over the data axis with
the step's weights; a whole room of 900 points by the streaming path,
its window groups over all n ranks; and a `CompactDeviceStore` of n x 64
canonical points row-sharded over all n ranks, a batch sampled from it
feeding a PointNet++ step. Rank 0 prints one line, worded as the JAX
package's, and every rank returns it. The ranks start by
`parallel.spawn` (one process a rank: gloo on the CPU and where ranks
share a card, NCCL with a card a rank), unless this process is a rank of
`torchrun` already. It runs on the card unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from pointseg_torch import parallel

C = 14


def entry(device: torch.device | str = "cuda"):
    """(forward, example args): the eval-mode forward of the flagship model
    (PointNet++ SSG, the reference's `train.py` path) on a (4, 4096, 9)
    batch, random weights from seed 0."""
    from pointseg_torch.models import create_model

    B, N = 4, 4096
    device = torch.device(device)
    torch.manual_seed(0)
    model = create_model("PointNet++", num_classes=C).to(device).eval()
    rng = np.random.default_rng(0)
    points = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32)).to(device)

    @torch.no_grad()
    def forward(points):
        return model(points)

    return forward, (points,)


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     timeout: float | None = 1200.0) -> str:
    """The dry run on `n_devices` ranks (module docstring); returns (and
    rank 0 prints) its summary line."""
    if parallel.under_torchrun():
        mesh = parallel.create_mesh(device)
        try:
            line = _dryrun_rank(mesh, n_devices)
        finally:
            parallel.close_mesh(mesh)
        if mesh.global_rank == 0:
            print(line, flush=True)
        return line
    device = torch.device(device)
    threads = None
    if device.type == "cpu":  # the ranks share the host's cores
        threads = max(1, torch.get_num_threads() // n_devices)
    lines = parallel.spawn(_dryrun_rank, n_devices, (n_devices,), device=device.type,
                           timeout=timeout, threads=threads)
    print(lines[0], flush=True)
    return lines[0]


def _canonical_store_points(rng, n_blocks: int, per: int):
    from pointseg_torch.data.blocks import augment_points

    raw = np.empty((n_blocks * per, 6), np.float32)
    raw[:, :3] = rng.uniform(0, 8, size=(n_blocks * per, 3))
    raw[:, 3:] = rng.integers(0, 256, size=(n_blocks * per, 3))
    return np.concatenate([augment_points(raw[i * per:(i + 1) * per])
                           for i in range(n_blocks)])


def _dryrun_rank(world: parallel.Mesh, n_devices: int) -> str:
    from pointseg_torch.data.device import CompactDeviceStore
    from pointseg_torch.models import create_model
    from pointseg_torch.train.state import create_train_state, train_step
    from pointseg_torch.utils.sliding_window import predict_single_scene_device

    if world.size != n_devices:
        raise ValueError(f"need {n_devices} ranks, have {world.size}")
    device = world.device
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = parallel.create_mesh(device, axes=("data", "model"), shape=(n_devices // tp, tp))
    flat = mesh.flat()

    B, N = 2 * n_devices, 128
    rng = np.random.default_rng(0)
    points = rng.normal(size=(B, N, 9)).astype(np.float32)
    labels = np.eye(C, dtype=np.uint8)[rng.integers(0, C, size=(B, N))]
    lengths = np.full((B,), N, np.int32)
    batch = tuple(torch.from_numpy(a) for a in (points, labels, lengths))

    models = {"PointNet++": ("PointNet++", {}), "PointNet": ("PointNet", {}),
              "PointNeXt": ("PointNeXt", {}), "DeepGraphCnn": ("DGCNN", dict(k=8, emb_dims=128))}
    losses, tp_fractions, flagship = {}, {}, None
    for label, (name, kwargs) in models.items():
        torch.manual_seed(0)
        state = create_train_state(create_model(name, num_classes=C, **kwargs), device=device)
        tp_fractions[label] = round(parallel.sharded_param_fraction(state.model, mesh), 3)
        state = parallel.shard_state_tp(mesh, state)
        rows = tuple(t.to(device) for t in parallel.shard_batch(mesh, batch))
        loss = float(train_step(state, *rows)["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{label}: non-finite loss {loss}")
        losses[label] = loss
        if label == "PointNet++":
            flagship = state

    # the point axis split over the data axis, the weights tensor-parallel as stepped
    big = torch.from_numpy(rng.normal(size=(1, 512 * n_devices, 9)).astype(np.float32))
    logits = parallel.forward_points(flagship.model, parallel.shard_points(mesh, big.to(device)),
                                     mesh)
    logits = parallel.gather_points(mesh, logits)
    if tuple(logits.shape) != (1, 512 * n_devices, C):
        raise AssertionError(f"point-sharded logits of shape {tuple(logits.shape)}")

    # whole-room streaming with the window groups over every rank: each rank
    # forwards other windows, so it takes the step's weights whole
    whole = create_model("PointNet++", num_classes=C).to(device)
    whole.load_state_dict(parallel.full_state_dict(flagship.model))
    whole.eval()
    room = rng.normal(size=(900, 9)).astype(np.float32)

    @torch.no_grad()
    def fwd(p, lengths):
        return whole(p)

    preds, conf = predict_single_scene_device(fwd, room, window_size=128, overlap=32,
                                              num_classes=C, device=device, mesh=flat)
    if preds.shape != (900,) or not np.isfinite(conf).all():
        raise AssertionError("window-sharded room eval")

    # the compact store's packed table row-sharded over every rank, a sampled
    # batch feeding the flagship step
    n_blocks, per = n_devices, 64
    spts = _canonical_store_points(rng, n_blocks, per)
    slabs = rng.integers(0, C, size=spts.shape[0]).astype(np.uint8)
    store = CompactDeviceStore(spts, slabs, np.full(n_blocks, per, np.int64), num_classes=C,
                               mesh=flat)
    generator = torch.Generator(device=device)
    generator.manual_seed(1)
    order = store.epoch_order(generator, batch_size=B)
    sampled = store.sample(order, 0, generator, B, N)
    metrics = train_step(flagship, *parallel.shard_batch(mesh, sampled))
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("non-finite loss from the sharded store's batch")

    loss_str = ", ".join(f"{k} loss={v:.4f}" for k, v in losses.items())
    tp_str = ", ".join(f"{k}={v:.1%}" for k, v in tp_fractions.items())
    return (f"dryrun_multichip({n_devices}): dp={n_devices // tp} x tp={tp} "
            f"train steps ok ({loss_str}), point-sharded eval ok, "
            f"window-sharded streaming room eval ok, sharded compact-store "
            f"sampling -> train step ok; "
            f"TP-sharded param fraction: {tp_str}")
