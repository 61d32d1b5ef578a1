"""pointseg_torch: pointseg ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`pointseg/`), which stays unchanged
and is the reference the port is tested against. Its module names
mirror `pointseg/`: `ops/` (geometric primitives; FPS, ball query,
3-NN, kNN and the row gather are hand-written CUDA kernels in `csrc/`),
`nn/`, `models/`, `train/`, `io/` (weight import, checkpoints), `utils/`
(whole-room evaluation), `data/`, `parallel/` and `cli.py`. Tensors are
channels-last at every public function, as in the JAX package. The port
imports nothing of `pointseg`: `data/` is its own copy of the numpy
data layer.

Ported so far: training (checkpoints, resume, rate schedules, gradient
clipping, `--profile`, `--bf16`, `--save-confusion`) and evaluation
(blocks and whole rooms) of all eight registry models (PointNet,
PointNet++ SSG and MSG, PointNeXt and its -B and -L depths, DGCNN with
and without the colour branch), serving export (`io/export_aot.py`),
reference checkpoint import, the legacy stack (`train/legacy.py`,
`train/enhanced.py`), data-parallel training (`parallel/`, `train
--data-parallel`) and every subcommand and flag of the JAX CLI.
"""

__version__ = "0.1.0"
