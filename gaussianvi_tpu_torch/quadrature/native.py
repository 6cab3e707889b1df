"""ctypes bindings for the native C++ sparse-grid generator.

Counterpart of ``gaussianvi_tpu/quadrature/native.py``.  The port builds its
own copy of the generator, ``gaussianvi_tpu_torch/csrc/spgh.cpp``, with
``g++`` at first use into ``gaussianvi_tpu_torch/_build/`` under a name keyed
on the source's hash (as ``kernels/_build.py`` does for the CUDA library),
building in a temporary directory and renaming the library into place, so
processes building at once never load a half-written file.  Without a
compiler the library is unavailable: :func:`available` is False and the
generators raise, as in the JAX package; nothing falls back silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "spgh.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libspgh_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile the library if it is not built yet; None without ``g++``
    or when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", lib, str(SOURCE)],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
        os.replace(lib, out)
    return out


@functools.cache
def load_library():
    """Load (building if necessary) the native library; None if unavailable."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.spgh_count.restype = ctypes.c_int64
    lib.spgh_count.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.spgh_generate.restype = ctypes.c_int64
    lib.spgh_generate.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.spgh_gh1d.restype = ctypes.c_int64
    lib.spgh_gh1d.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def available() -> bool:
    return load_library() is not None


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError("native spgh library unavailable (no g++?)")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def sparse_gh_native(dim: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Native (dim, k) sparse rule; raises if the library is unavailable."""
    lib = _require()
    n = lib.spgh_count(dim, k)
    if n < 0:
        raise ValueError(f"invalid (dim, k) = ({dim}, {k})")
    nodes = np.empty((n, dim), np.float64)
    weights = np.empty(n, np.float64)
    got = lib.spgh_generate(dim, k, _ptr(nodes), _ptr(weights), n)
    if got != n:
        raise RuntimeError(f"spgh_generate returned {got}, expected {n}")
    return nodes, weights


def gh_1d_native(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Native 1-D probabilists' rule; raises if the library is unavailable."""
    lib = _require()
    nodes = np.empty(degree, np.float64)
    weights = np.empty(degree, np.float64)
    got = lib.spgh_gh1d(degree, _ptr(nodes), _ptr(weights))
    if got != degree:
        raise RuntimeError(f"spgh_gh1d returned {got}")
    return nodes, weights
