"""ctypes bindings for the native (C++) ETL parser (the port's copy of
`pointseg/data/native.py`; both build the same `native/parser.cpp`).

The shared library is built on demand from native/parser.cpp with g++
(cached next to the source). All entry points degrade gracefully: if
the toolchain or library is unavailable, callers fall back to the pure-
Python parser (pointseg_torch.data.prepare._parse_annotation_file).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "parser.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libpointseg_parser.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib() -> ctypes.CDLL | None:
    """Loads (building if needed) the native parser; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.ps_count_lines.argtypes = [ctypes.c_char_p]
            lib.ps_count_lines.restype = ctypes.c_long
            lib.ps_parse_xyzrgb.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
            ]
            lib.ps_parse_xyzrgb.restype = ctypes.c_long
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def parse_annotation_file(path: str) -> np.ndarray | None:
    """Parses an `x y z r g b` annotation file natively.

    Returns (N, 6) float32, or None if the native library is
    unavailable (callers fall back to the Python parser).
    """
    lib = get_lib()
    if lib is None:
        return None
    n_lines = lib.ps_count_lines(path.encode())
    if n_lines < 0:
        raise IOError(f"native parser failed to read {path}")
    if n_lines == 0:
        return np.zeros((0, 6), np.float32)
    buf = np.empty((n_lines, 6), np.float32)
    n = lib.ps_parse_xyzrgb(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_lines,
    )
    if n < 0:
        raise IOError(f"native parser failed to read {path}")
    return buf[:n].copy()
