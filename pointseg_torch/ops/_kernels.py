"""Build, load and launch the port's hand-written CUDA kernels.

Counterpart of `pointseg/ops/dispatch.py`, with one rule: a tensor on
the CPU goes to the op's plain PyTorch version, a tensor on a CUDA
device goes to the kernel, and any other device raises. There is no
switch and no fallback: a kernel that fails to build or launch raises.

The sources in `pointseg_torch/csrc/` are compiled at first use by
`nvcc`, one process per source and all at once, and linked into one
shared library with a plain C interface, loaded with `ctypes`. The
library goes to `build/pointseg_torch/<hash>/` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is compiled once. Each C entry point
takes device pointers, ints, the index of the tensors' device and the
current CUDA stream of that device, launches without synchronising and
returns `cudaGetLastError()`.

What a launch costs the host, and why it is built the way it is. The
small kernels (FPS at the deep stages, the ball queries, 3-NN, the row
gathers) run 2-70 us on an H100, so a model of the PointNet++ family is
bound by how fast the host can launch them, and a call that costs more
host time than `torch.index_select`'s dispatch (15-17 us on the H100's
host) loses to it under CUDA events however fast its kernel is. `launch`
therefore does nothing that does not depend on its arguments: the entry
points are bound once, at load, into `_ENTRY_POINTS` (no attribute
lookup on the library per call); the device is made current inside the C
entry point, by `DeviceScope` of `csrc/launch.cuh`, which switches only
when another device is current (a Python `with torch.cuda.device(...)`
costs 3-5 us a call); and the stream comes as a raw handle from
`torch._C._cuda_getCurrentRawStream` (0.2 us), the accessor Triton's
launcher uses, instead of a `torch.cuda.Stream` object built per call
(5-6 us). What remains of a flat-gather call's 19 us is the output's
allocation (5-7 us, which `index_select` pays too), the ctypes call
itself (6 us: it converts each argument by its `argtypes` entry, and
holds the CUDA launch) and the wrapper's checks and pointer reads (3
us). These figures are the measured split of that call in microseconds
a call over 10,000 calls, beside `index_select` and an empty Python
call, on the fastest host of four NVIDIA H100 80GB HBM3 machines (the
slowest took 1.5 times as long for every part). The launch goes to PyTorch's current
stream of the tensors' device, so it orders with the PyTorch work around
it, runs on a stream chosen with `torch.cuda.stream` and is captured by
`torch.cuda.graph`.

`LAUNCHES` counts, per kernel, the launches that returned without error;
`chip_smoke.py` reads it to show that the training path ran the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fps.cu", "ballquery.cu", "threenn.cu", "knn.cu", "gather.cu", "edgereduce.cu")
HEADERS = ("launch.cuh",)  # included by every source
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pointseg_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"fps": 0, "ball_query": 0, "ball_query_2l": 0, "three_nn": 0,
            "knn": 0, "knn_2l": 0, "gather_rows": 0, "gather_rows_flat": 0,
            "edge_reduce": 0}  # edge_reduce: its forward and its backward kernel

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_SIGNATURES = {  # every entry point ends with (device index, stream)
    # coords, start, mask, out, dist_scratch, B, N, C, threads
    "pointseg_fps": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2, repeat,
    # groups, warps, slices
    "pointseg_ball_query": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2, depth, repeat,
    # groups, warps, slices
    "pointseg_ball_query_2l": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                               _P),
    # tgt, src, src_mask, out_d, out_i, B, N, M, targets, warps
    "pointseg_three_nn": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, norms_scratch, mask, out, B, N, F, K, include_self
    "pointseg_knn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, norms_scratch, mask, out, B, N, F, K, include_self, depth
    "pointseg_knn_2l": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # table, coords, idx, out, out_coords, B, N, M, row_bytes, coord_row_bytes
    "pointseg_gather_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P),
    # table, idx, out, R, M, row_bytes
    "pointseg_gather_rows_flat": (_P, _P, _P, _L, _L, _L, _I, _P),
    # table, idx, out_max, out_min, out_sum, out_sq, count_max, count_min, B, M, N, K, C,
    # dtype
    "pointseg_edge_reduce": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # table, idx, max, min, count_max, count_min, g_max, g_min, g_sum, g_sq, grad, B, M,
    # N, K, C, dtype
    "pointseg_edge_reduce_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _P),
}

_library: ctypes.CDLL | None = None
# symbol -> the bound C function, argument types set; filled by `library()`
_ENTRY_POINTS: dict = {}
# device index -> raw handle of PyTorch's current stream there; set by `library()`
_raw_stream = None


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain
    version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"pointseg_torch ops run on 'cpu' or 'cuda', not {t.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def _check_nvcc(cmd: list[str], returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc exited with {returncode}:\n{' '.join(cmd)}\n{log}")


def build() -> Path:
    """Compiles the kernels unless this exact build exists; returns the
    shared library's path. Processes that build at once (the ranks of a
    data-parallel run) take turns on a lock file beside the library: the
    first builds, the others find its library and compile nothing."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libpointseg_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():
            _compile(out_dir, lib)
    return lib


def _compile(out_dir: Path, lib: Path) -> None:
    """Compiles every source at once and links them into `lib`."""
    nvcc, tag = _nvcc(), os.getpid()
    objects = [out_dir / f".partial-{tag}-{name}.o" for name in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
                for name, obj in zip(SOURCES, objects)]
    tmp = out_dir / f".partial-{tag}.so"
    try:
        running = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for cmd in compiles]
        logs = [proc.communicate()[0] for proc in running]  # waits for every compile
        for cmd, proc, log in zip(compiles, running, logs):
            _check_nvcc(cmd, proc.returncode, log)
        link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj in objects)]
        result = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, result.returncode, result.stdout + result.stderr)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a reader never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call). Loading binds
    every entry point, with its argument types, into `_ENTRY_POINTS`, and
    picks the stream accessor."""
    global _library, _raw_stream
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = lib[name]
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _ENTRY_POINTS[name] = fn
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _library = lib
    return _library


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Calls C entry point `symbol` on the current stream of `device` (a
    tensor's: it has an index) and counts the launch under `kernel`;
    raises on a CUDA error. Does not synchronise."""
    if _library is None:
        library()
    index = device.index
    err = _ENTRY_POINTS[symbol](*args, index, _raw_stream(index))
    if err != 0:
        raise torch.cuda.CudaError(err)
    LAUNCHES[kernel] += 1


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raises unless `t` is a contiguous CUDA tensor of `dtype` and
    `shape` (None in `shape` matches any size)."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if len(t.shape) != len(shape) or any(
            want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: need shape {shape}, got {tuple(t.shape)}")
