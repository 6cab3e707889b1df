"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

``nvcc`` compiles the sources into ``gaussianvi_tpu_torch/_build/`` at first
use, under a name keyed on a hash of the sources and flags, so a fresh
checkout builds once and an edited source rebuilds.  The library has a
plain C interface and is loaded with ``ctypes`` (no PyTorch headers: the
build takes seconds, not minutes).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # dtype, s, diag, off, covd, covo, ld, fpiv, gpiv, nb, n, stream
    "gvi_gbp": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # dtype, s, diag, off, rhs, x, lfac, nb, n, stream
    "gvi_solve": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # dtype, d, cost, with_moments, mu, cov, nodes, weights, params,
    # e_phi, e_xmu, e_xxt, count, m, np, nonneg, rdim, stream
    "gvi_quad": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _P),
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libgvi_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the library if it is not built yet; return its path.

    Compiles into a temporary file and renames it into place, so processes
    building at once never load a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise for a failed launch (the C entry returns cudaGetLastError)."""
    if err == -1:
        raise ValueError(f"{name}: no kernel instantiated for these sizes")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
