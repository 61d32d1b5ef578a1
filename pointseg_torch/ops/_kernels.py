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
takes device pointers, ints and the current CUDA stream, launches without
synchronising and returns `cudaGetLastError()`.

`LAUNCHES` counts, per kernel, the launches that returned without error;
`chip_smoke.py` reads it to show that the training path ran the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fps.cu", "ballquery.cu", "threenn.cu", "knn.cu", "gather.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pointseg_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"fps": 0, "ball_query": 0, "three_nn": 0,
            "knn": 0, "knn_2l": 0, "gather_rows": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # coords, start, mask, out, dist_scratch, B, N, C, stream
    "pointseg_fps": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2, stream
    "pointseg_ball_query": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # tgt, src, src_mask, out_d, out_i, B, N, M, stream
    "pointseg_three_nn": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, norms_scratch, mask, out, B, N, F, K, include_self, stream
    "pointseg_knn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, norms_scratch, mask, out, B, N, F, K, include_self, depth, stream
    "pointseg_knn_2l": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # table, idx, out, B, N, M, C, stream
    "pointseg_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_library: ctypes.CDLL | None = None


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain
    version); raises for any other device."""
    if t.device.type == "cuda":
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
    shared library's path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libpointseg_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
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
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Calls C entry point `symbol` on `device`'s current stream and
    counts the launch under `kernel`; raises on a CUDA error."""
    fn = getattr(library(), symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
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
