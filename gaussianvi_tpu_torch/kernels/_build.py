"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

``nvcc`` compiles the sources into ``gaussianvi_tpu_torch/_build/`` at first
use, under a name keyed on a hash of the sources and flags, so a fresh
checkout builds once and an edited source rebuilds.  Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, and one more
call links the objects.  ``-Xptxas -v`` is on: what ptxas says of every
kernel (registers, spills) is kept beside the library
(:func:`ptxas_report`).  The library has a plain C interface and is loaded
with ``ctypes`` (no PyTorch headers: the build takes seconds, not
minutes).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the entry points' dtype codes
DTYPES = {torch.float32: 0, torch.float64: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# the quadrature entries' operands (csrc/quad.cuh quad_entry): mu, mu_sb,
# mu_sk, cov, cov_sb, cov_sk, nodes, weights, params, period, field, rows,
# cols, depth, e_phi, e_xmu, e_xxt, count, k, m, np
QUAD_OPERANDS = (_P, _L, _L, _P, _L, _L, _P, _P, _P, _L, _P, _I, _I, _I, _P,
                 _P, _P, _L, _I, _I, _I)
SIGNATURES = {
    # dtype, s, diag, off, covd, covo, ld, scratch, nb, n, arena, stream
    "gvi_gbp": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    # dtype, s, ops (d0, o0, v0, x0, d1, o1, v1, x1), scratch, units,
    # units1, n, arena, stream
    "gvi_solve": (_I, _I, _P, _P, _I, _I, _I, _L, _P),
    # dtype, s, ops (pd, po, dpd, dpo, mu, dmu, trials), covd, covo, ld,
    # scratch, nb, nt, n, arena, n_lin, lin_ptrs, lin_ints, stream
    "gvi_gbp_trials": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P,
                       _P, _P),
    # dtype, d, cost, with_moments, then QUAD_OPERANDS, nonneg, rdim,
    # quant, group_shift, threads, stream
    "gvi_quad": (_I, _I, _I, _I, *QUAD_OPERANDS, _I, _I, _I, _I, _I, _P),
    # dtype, d, cost, then QUAD_OPERANDS, rdim, group_shift, threads, stream
    "gvi_fused_moments": (_I, _I, _I, *QUAD_OPERANDS, _I, _I, _I, _P),
    # dtype, s, cost, np, mu, dmu, pd, po, dpd, dpo, trials, ld, scratch,
    # nb, n, nt, warps, groups, arena, n_nl, nl_ptrs, nl_ints, n_lin,
    # lin_ptrs, lin_ints, stream
    "gvi_fused_trials": (_I, _I, _I, _I, *(_P,) * 9, _I, _I, _I, _I, _I, _L,
                         _I, _P, _P, _I, _P, _P, _P),
    # dtype, s, cost, np, mu, pd, po, temp, covd, covo, ld, dpd, dpo, dmu,
    # dfb, vdmu, vdd, vdo, scratch, nb, n, warps, chain, n_nl, nl_ptrs,
    # nl_ints, n_lin, lin_ptrs, lin_ints, stream
    "gvi_fused_grad": (_I, _I, _I, _I, *(_P,) * 15, _I, _I, _I, _L,
                       _I, _P, _P, _I, _P, _P, _P),
}
# the split pair of the fused gradient kernel takes the same arguments
# (mode "accum": null covd .. dfb, writes vdmu, vdd, vdo; mode "solve" reads
# them; mode "full": null)
SIGNATURES["gvi_fused_grad_accum"] = SIGNATURES["gvi_fused_grad"]
SIGNATURES["gvi_fused_grad_solve"] = SIGNATURES["gvi_fused_grad"]


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


def _run(procs) -> str:
    """Wait for every ``(cmd, Popen)``; raise with the output of the first
    that failed, else return all their output."""
    failed, outputs = None, []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
    return "".join(outputs)


def build() -> Path:
    """Compile the library if it is not built yet; return its path.

    Builds in a temporary directory and renames the library into place, so
    processes building at once never load a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        log = _run(procs)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))])
        Path(tmp, "ptxas.txt").write_text(log)
        os.replace(os.path.join(tmp, "ptxas.txt"), out.with_suffix(".ptxas"))
        os.replace(lib, out)
    return out


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_KERNEL = re.compile(r"\d+([a-z_]+(?:_s6)?_kernel)I([fd])")
# the cost functor a kernel instance was built for (csrc/costs.cuh)
_COSTS = {"RangeCost": "range", "PlanarSdfCost": "planar_sdf",
          "Sdf3dCost": "sdf3d", "PlanarPatchCost": "planar_patch",
          "Sdf3dPatchCost": "sdf3d_patch"}


def ptxas_report() -> list[dict]:
    """Registers and spill bytes of every kernel of the built library, from
    the ``-Xptxas -v`` output of its build: ``[{kernel, dtype, ints, cost,
    registers, spill_stores, spill_loads}]`` with ``ints`` the integer
    and bool template arguments as mangled (block size, mode, ...; the
    block size 6 put first for a kernel of the s = 6 layout, which takes
    none) and
    ``cost`` the cost functor's name in ``KERNEL_COSTS`` (None for a
    kernel without one)."""
    log = build().with_suffix(".ptxas").read_text()
    rows, row = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            k = _KERNEL.search(name)
            kernel = k.group(1) if k else name
            ints = [int(x) for x in re.findall(r"L[ib](\d+)E", name)]
            if kernel.endswith("_s6_kernel"):   # its block size is no argument
                ints = [6, *ints]
            row = dict(
                kernel=kernel,
                dtype={"f": "float32", "d": "float64"}[k.group(2)] if k else "",
                ints=ints,
                cost=next((v for c, v in _COSTS.items() if c in name), None),
                registers=None, spill_stores=None, spill_loads=None)
            rows.append(row)
            continue
        if row is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
            row = None
    return rows


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


def current_stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the entry points
    take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise for a failed launch (the C entry returns cudaGetLastError)."""
    if err == -1:
        raise ValueError(f"{name}: no kernel instantiated for these sizes")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
