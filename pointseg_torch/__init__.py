"""pointseg_torch: pointseg ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`pointseg/`), which stays unchanged
and is the reference the port is tested against. Its module names
mirror `pointseg/`: `ops/` (geometric primitives; FPS, ball query and
3-NN are hand-written CUDA kernels in `csrc/`), `nn/`, `models/`,
`train/`, `io/` and `cli.py`. Tensors are channels-last at every public
function, as in the JAX package. The numpy data layer is shared:
`pointseg.data` is the only part of `pointseg` the port imports.

Ported so far: PointNet++ SSG training and evaluation (ROADMAP.md lists
the rest).
"""

__version__ = "0.1.0"
