"""Chain kernels: GBP covariance + log det (K1) and block-Thomas solve (K2).

Counterpart of ``gaussianvi_tpu/kernels/chain_lanes.py``.  Each wrapper
takes the JAX shapes with any leading batch axes (problems, or line-search
trials x problems), launches the CUDA kernel (``csrc/chain.cu``, one thread
per chain) for GPU tensors and runs the plain PyTorch version for CPU
tensors.  The kernel's log det is Kahan-compensated and its plain version
(``ops.blocktridiag``) is not, so the two agree to rounding, not bitwise.

``<wrapper>.launches`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import math

import torch

from ..ops.blocktridiag import BlockTridiag
from ..ops.blocktridiag import gbp_covariance_logdet as _gbp_plain
from ..ops.blocktridiag import solve as _solve_plain
from . import _build

BLOCK_SIZES = (2, 4)     # instantiated state-block sizes s
_DTYPES = {torch.float32: 0, torch.float64: 1}


def gbp_covariance_logdet_plain(diag, off):
    """Plain version of K1: ``ops.blocktridiag.gbp_covariance_logdet``."""
    return _gbp_plain(BlockTridiag(diag, off))


def solve_plain(diag, off, b):
    """Plain version of K2: ``ops.blocktridiag.solve``."""
    return _solve_plain(BlockTridiag(diag, off), b)


def _lanes(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[*lead, ...] -> batch-last contiguous [elements, nb]."""
    return x.reshape(nb, -1).t().contiguous()


def _unlanes(x: torch.Tensor, shape) -> torch.Tensor:
    return x.t().reshape(shape)


def _check(name, diag, off, *others):
    if diag.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {diag.dtype} not supported "
                         "(float32 or float64)")
    s = diag.shape[-1]
    if s not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size s={s} not instantiated "
                         f"(have {BLOCK_SIZES})")
    n = diag.shape[-3]
    lead = diag.shape[:-3]
    if off.shape != (*lead, max(n - 1, 0), s, s):
        raise ValueError(f"{name}: off shape {tuple(off.shape)} does not "
                         f"match diag {tuple(diag.shape)}")
    for t in (off, *others):
        if t.device != diag.device or t.dtype != diag.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    return lead, n, s


def gbp_covariance_logdet_lanes(diag: torch.Tensor, off: torch.Tensor):
    """K1: ``diag [..., N, s, s]``, ``off [..., N-1, s, s]`` ->
    ``(cov_diag [..., N, s, s], cov_off [..., N-1, s, s], logdet [...])``."""
    if diag.device.type == "cpu":
        return gbp_covariance_logdet_plain(diag, off)
    lead, n, s = _check("gbp_covariance_logdet_lanes", diag, off)
    nb = math.prod(lead)
    d_l = _lanes(diag, nb)
    o_l = _lanes(off, nb) if n > 1 else d_l
    covd = torch.empty_like(d_l)
    covo = torch.empty(((n - 1) * s * s, nb), dtype=diag.dtype,
                       device=diag.device)
    ld = torch.empty((nb,), dtype=diag.dtype, device=diag.device)
    fpiv = torch.empty_like(d_l)
    gpiv = torch.empty_like(d_l)
    err = _build.load().gvi_gbp(
        _DTYPES[diag.dtype], s, d_l.data_ptr(), o_l.data_ptr(),
        covd.data_ptr(), covo.data_ptr(), ld.data_ptr(), fpiv.data_ptr(),
        gpiv.data_ptr(), nb, n,
        torch.cuda.current_stream(diag.device).cuda_stream,
    )
    _build.check(err, "gvi_gbp")
    gbp_covariance_logdet_lanes.launches += 1
    return (_unlanes(covd, diag.shape), _unlanes(covo, off.shape),
            ld.reshape(lead))


def solve_lanes(diag: torch.Tensor, off: torch.Tensor, b: torch.Tensor):
    """K2: SPD block-tridiagonal solve, ``b [..., N, s]`` -> ``x [..., N, s]``."""
    if diag.device.type == "cpu":
        return solve_plain(diag, off, b)
    lead, n, s = _check("solve_lanes", diag, off, b)
    if b.shape != (*lead, n, s):
        raise ValueError(f"solve_lanes: rhs shape {tuple(b.shape)} does not "
                         f"match diag {tuple(diag.shape)}")
    nb = math.prod(lead)
    d_l = _lanes(diag, nb)
    o_l = _lanes(off, nb) if n > 1 else d_l
    b_l = _lanes(b, nb)
    x = torch.empty_like(b_l)
    lfac = torch.empty_like(d_l)
    err = _build.load().gvi_solve(
        _DTYPES[diag.dtype], s, d_l.data_ptr(), o_l.data_ptr(),
        b_l.data_ptr(), x.data_ptr(), lfac.data_ptr(), nb, n,
        torch.cuda.current_stream(diag.device).cuda_stream,
    )
    _build.check(err, "gvi_solve")
    solve_lanes.launches += 1
    return _unlanes(x, b.shape)


gbp_covariance_logdet_lanes.launches = 0
solve_lanes.launches = 0
