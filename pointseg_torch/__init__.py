"""pointseg_torch: pointseg ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`pointseg/`), which stays unchanged
and is the reference the port is tested against. Its module names
mirror `pointseg/`: `ops/` (geometric primitives; FPS, ball query,
3-NN, kNN and the row gather are hand-written CUDA kernels in `csrc/`),
`nn/`, `models/`, `train/`, `io/`, `data/` and `cli.py`. Tensors are
channels-last at every public function, as in the JAX package. The port
imports nothing of `pointseg`: `data/` is its own copy of the numpy
data layer.

Ported so far: training and evaluation of PointNet++ (SSG and MSG),
PointNeXt (and its -B and -L depths) and DGCNN with and without the
colour branch (ROADMAP.md lists the rest).
"""

__version__ = "0.1.0"
