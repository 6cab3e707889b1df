"""Chain kernels: GBP covariance + log det (K1) and block-Thomas solve (K2).

Counterpart of ``gaussianvi_tpu/kernels/chain_lanes.py``.  Each wrapper
takes the JAX shapes with any leading batch axes (problems, or line-search
trials x problems), launches the CUDA kernel for GPU tensors and runs the
plain PyTorch version for CPU tensors.  Two layouts (``csrc/chain.cuh``):
up to s = 6, 2s lanes per chain or pair of chains and the warp's chains in
shared memory (s in {2, 4, 6} in ``csrc/chain.cu``, s = 1 in
``csrc/chain_wide.cu``); at s = 14 (``WIDE_BLOCK_SIZES``,
``csrc/chain_wide.cu``) a warp per chain or pair, a half warp per
recursion or system, a lane per column, beside a fixed work area in
shared memory.  Operands are
read problem-major as they are and outputs are allocated in their final
shape: nothing is copied or re-laid per call.  The kernel's log det is
Kahan-compensated and its plain version (``ops.blocktridiag``) is not, so
the two agree to rounding, not bitwise.

K2 has two entry points: :func:`solve_lanes` (any batch of systems, each
with its own right-hand side) and :func:`solve_pair_lanes` (the NGD step's
main system and its SPD fallback against one right-hand side, which the
kernel reads once).  Both count their launches on ``solve_lanes.launches``;
``gbp_covariance_logdet_lanes.launches`` counts K1's (never plain-version
calls).

K1 has a trial form at s = 14, :func:`gbp_trials_lanes`: the batched line
search's T x B chains from the iterate, its direction and the T steps,
each trial's precision formed inside the kernel (the ``[T, B, N, s, s]``
batch never exists) and the linear factors' costs read from the
covariance blocks it has just written; its launches count on
``gbp_trials_lanes.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops.blocktridiag import BlockTridiag
from ..ops.blocktridiag import gbp_covariance_logdet as _gbp_plain
from ..ops.blocktridiag import solve as _solve_plain
from ..utils.profiling import span
from . import _build
from .fused_trials import (
    SMEM_LIMIT,
    BlockPlan,
    linear_args,
    linear_costs_plain,
    mat_pitch,
    vec_pitch,
)

BLOCK_SIZES = (1, 2, 4, 6, 14)  # instantiated state-block sizes s
WIDE_BLOCK_SIZES = (14,)         # a warp per chain or pair (chain_wide.cu)


def covers(s: int, dtype: torch.dtype) -> str | None:
    """Why K1 and K2 do not cover chains of block size ``s`` in ``dtype``,
    or None where they do.  The engine resolves ``chain_impl="auto"`` by
    it, and the wrappers check it before a launch."""
    if dtype not in _build.DTYPES:
        return f"dtype {dtype} not supported (float32 or float64)"
    if s not in BLOCK_SIZES:
        return f"block size s={s} not instantiated (have {BLOCK_SIZES})"
    return None


def chains_per_warp(s: int) -> int:
    """Chains (K1) or pairs (K2) a warp carries: 2s lanes each (at s = 6
    two, the warp's last 8 lanes repeating its first; at s = 1 sixteen),
    or one in the wide layout."""
    return 1 if s in WIDE_BLOCK_SIZES else 32 // (2 * s)


def wide_mat(s: int) -> int:
    """Shared-memory words of an s x s block in the wide layout
    (csrc/chain_wide.cu Wide::kMat): column-major, columns s + 1 apart."""
    return s * (s + 1)


def chain_work_elems(s: int, solve: bool) -> int:
    """The wide layout's fixed work area of a warp, always in shared memory
    (Wide::kGbpWork, kSolveWork, both halves); none in the other layout."""
    if s not in WIDE_BLOCK_SIZES:
        return 0
    return 2 * (wide_mat(s) if solve else 4 * wide_mat(s) + s + 1)


def slot_pitch(base: int, slots: int, itemsize: int) -> int:
    """Values from one of a warp's ``slots`` arrays of ``base`` values to
    the next (csrc/chain.cu slot_pitch): padded so that the arrays start
    32 / slots banks apart."""
    bank = 32 * 4 // itemsize
    return base + (bank // slots - base) % bank


def gbp_warp_elems(n: int, s: int, itemsize: int) -> int:
    """Arena of one K1 warp (csrc/chain.cuh gbp_warp_elems, chain_wide.cu
    gbp_wide_elems): both pivot arrays of its chains."""
    if s in WIDE_BLOCK_SIZES:
        return 2 * n * wide_mat(s)
    c = chains_per_warp(s)
    return c * 2 * slot_pitch(n * mat_pitch(s), c, itemsize)


def solve_warp_elems(n: int, s: int, itemsize: int) -> int:
    """Arena of one K2 warp (csrc/chain.cuh solve_warp_elems): D, B, the
    factors, right-hand side and solution of both systems of its pairs; in
    the wide layout (chain_wide.cu solve_wide_elems) each system's factors,
    their reciprocal diagonals and the eliminated right-hand side."""
    if s in WIDE_BLOCK_SIZES:
        return 2 * n * (wide_mat(s) + 2 * (s + 1))
    c2, m, v = 2 * chains_per_warp(s), mat_pitch(s), vec_pitch(s)
    return c2 * (2 * slot_pitch(n * m, c2, itemsize)
                 + slot_pitch((n - 1) * m, c2, itemsize)
                 + 2 * slot_pitch(n * v, c2, itemsize))


def chain_plan(elems: int, itemsize: int, work: int = 0) -> BlockPlan:
    """One-warp blocks whose arenas of ``elems`` values lie in shared
    memory beside ``work`` values of work area, or, for a chain too long
    for it, in a global scratch."""
    smem = (work + elems) * itemsize
    scratch = smem > SMEM_LIMIT
    return BlockPlan(1, elems, work * itemsize if scratch else smem, scratch)


def gbp_plan(n: int, s: int, itemsize: int) -> BlockPlan:
    """K1's plan for chains of ``n`` blocks of size ``s``."""
    return chain_plan(gbp_warp_elems(n, s, itemsize), itemsize,
                      chain_work_elems(s, False))


def solve_plan(n: int, s: int, itemsize: int) -> BlockPlan:
    """K2's plan for systems of ``n`` blocks of size ``s``."""
    return chain_plan(solve_warp_elems(n, s, itemsize), itemsize,
                      chain_work_elems(s, True))


def gbp_covariance_logdet_plain(diag, off):
    """Plain version of K1: ``ops.blocktridiag.gbp_covariance_logdet``."""
    return _gbp_plain(BlockTridiag(diag, off))


def solve_plain(diag, off, b):
    """Plain version of K2: ``ops.blocktridiag.solve``."""
    return _solve_plain(BlockTridiag(diag, off), b)


def solve_pair_plain(d0, o0, d1, o1, b):
    """Plain version of the pair: both systems stacked, one call."""
    x = solve_plain(torch.stack([d0, d1]), torch.stack([o0, o1]),
                    b.expand(2, *b.shape))
    return x[0], x[1]


def _check(name, diag, off, *others):
    why = covers(diag.shape[-1], diag.dtype)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    s = diag.shape[-1]
    n = diag.shape[-3]
    lead = diag.shape[:-3]
    if n < 1 or off.shape != (*lead, n - 1, s, s):
        raise ValueError(f"{name}: off shape {tuple(off.shape)} does not "
                         f"match diag {tuple(diag.shape)}")
    for t in (off, *others):
        if t.device != diag.device or t.dtype != diag.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    return lead, n, s


def _scratch(plan, count, s, like):
    """The global arena of every warp a launch over ``count`` chains or
    pairs takes, where the plan puts it there."""
    if not plan.scratch:
        return None
    warps = -(-count // chains_per_warp(s))
    return torch.empty((warps * plan.arena,), dtype=like.dtype,
                       device=like.device)


def _ptr(x):
    return None if x is None else x.data_ptr()


def gbp_covariance_logdet_lanes(diag: torch.Tensor, off: torch.Tensor):
    """K1: ``diag [..., N, s, s]``, ``off [..., N-1, s, s]`` ->
    ``(cov_diag [..., N, s, s], cov_off [..., N-1, s, s], logdet [...])``."""
    if diag.device.type == "cpu":
        return gbp_covariance_logdet_plain(diag, off)
    with span("gvi.kernel.gbp_covariance_logdet"):
        return _gbp_kernel(diag, off)


def _gbp_kernel(diag, off):
    lead, n, s = _check("gbp_covariance_logdet_lanes", diag, off)
    nb = math.prod(lead)
    # the blocks are read in 16-byte pieces where they stay in device memory
    diag, off = (x.contiguous() if x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format) for x in (diag, off))
    covd, covo = torch.empty_like(diag), torch.empty_like(off)
    ld = torch.empty(lead, dtype=diag.dtype, device=diag.device)
    plan = gbp_plan(n, s, diag.element_size())
    scratch = _scratch(plan, nb, s, diag)
    err = _build.load().gvi_gbp(
        _build.DTYPES[diag.dtype], s, diag.data_ptr(), off.data_ptr(),
        covd.data_ptr(), covo.data_ptr(), ld.data_ptr(), _ptr(scratch), nb, n,
        plan.arena, _build.current_stream(diag.device))
    _build.check(err, "gvi_gbp")
    gbp_covariance_logdet_lanes.launches += 1
    return covd, covo, ld


def _solve_launch(systems, units, units1, n, s):
    """One K2 launch: ``systems`` are (d0, o0, v0, x0, d1, o1, v1, x1),
    contiguous; pair u takes chain u of system 0 and, for u < units1, of
    system 1."""
    like = systems[0]
    size = like.element_size()
    plan = solve_plan(n, s, size)
    scratch = _scratch(plan, units, s, like)
    ops = (ctypes.c_void_p * 8)(*(x.data_ptr() for x in systems))
    err = _build.load().gvi_solve(
        _build.DTYPES[like.dtype], s, ops, _ptr(scratch), units, units1, n,
        plan.arena, _build.current_stream(like.device))
    _build.check(err, "gvi_solve")
    solve_lanes.launches += 1


def solve_lanes(diag: torch.Tensor, off: torch.Tensor, b: torch.Tensor):
    """K2: SPD block-tridiagonal solve, ``b [..., N, s]`` -> ``x [..., N,
    s]``."""
    if diag.device.type == "cpu":
        return solve_plain(diag, off, b)
    with span("gvi.kernel.solve"):
        return _solve_kernel(diag, off, b)


def _solve_kernel(diag, off, b):
    # the flattened chains go to the kernel as two halves, pair u solving
    # chain u and chain u + ceil(count / 2)
    lead, n, s = _check("solve_lanes", diag, off, b)
    if b.shape != (*lead, n, s):
        raise ValueError(f"solve_lanes: rhs shape {tuple(b.shape)} does not "
                         f"match diag {tuple(diag.shape)}")
    count = math.prod(lead)
    half = (count + 1) // 2
    d = diag.contiguous().view(count, n, s, s)
    o = off.contiguous().view(count, n - 1, s, s)
    r = b.contiguous().view(count, n, s)
    x = torch.empty((count, n, s), dtype=b.dtype, device=b.device)
    _solve_launch((d, o, r, x, d[half:], o[half:], r[half:], x[half:]), half,
                  count - half, n, s)
    return x.view(b.shape)


def solve_pair_lanes(d0, o0, d1, o1, b):
    """K2 on the NGD step's pair: the systems ``(d0, o0)`` and ``(d1, o1)``
    (``[..., N, s, s]``, ``[..., N-1, s, s]``) against the one right-hand
    side ``b [..., N, s]`` -> ``(x0, x1)``, one launch, ``b`` read once."""
    if d0.device.type == "cpu":
        return solve_pair_plain(d0, o0, d1, o1, b)
    with span("gvi.kernel.solve"):
        return _solve_pair_kernel(d0, o0, d1, o1, b)


def _solve_pair_kernel(d0, o0, d1, o1, b):
    lead, n, s = _check("solve_pair_lanes", d0, o0, d1, o1, b)
    if d1.shape != d0.shape or b.shape != (*lead, n, s):
        raise ValueError(f"solve_pair_lanes: shapes {tuple(d0.shape)}, "
                         f"{tuple(d1.shape)}, rhs {tuple(b.shape)} differ")
    count = math.prod(lead)
    ops = [x.contiguous() for x in (d0, o0, b, d1, o1)]
    x0, x1 = torch.empty_like(ops[2]), torch.empty_like(ops[2])
    _solve_launch((*ops[:3], x0, *ops[3:], ops[2], x1), count, count, n, s)
    return x0, x1


def gbp_trials_plain(pd, po, dpd, dpo, mu, dmu, trials, lin_specs,
                     lin_arrays):
    """Plain version of K1's trial form: the trial precisions formed as
    the separate route forms them (``inference/optimize.py``: ``(prec +
    dprec.scale(steps)).symmetrize()``), the plain K1 on them and the
    residual-form linear costs from its blocks
    (``fused_trials.linear_costs_plain``)."""
    steps = trials.reshape(-1, 1)
    t_prec = (BlockTridiag(pd, po)
              + BlockTridiag(dpd, dpo).scale(steps)).symmetrize()
    cd, co, ld = gbp_covariance_logdet_plain(t_prec.diag, t_prec.off)
    t_mu = mu + steps[..., None, None] * dmu
    fc = linear_costs_plain(t_mu, cd, cd[..., :-1, :, :], cd[..., 1:, :, :],
                            co, lin_specs, lin_arrays)
    return cd, co, ld, fc


def gbp_trials_lanes(pd, po, dpd, dpo, mu, dmu, trials, lin_specs,
                     lin_arrays):
    """K1's trial form at s = 14: the iterate's precision ``pd [B, N, s,
    s]``, ``po [B, N-1, s, s]``, the step's ``dpd``, ``dpo``, the means
    ``mu``, ``dmu [B, N, s]``, the steps ``trials [T]`` and the linear
    batches' operands in residual form (``kernels/fused_trials.py``) ->
    ``(cov_diag [T, B, N, s, s], cov_off [T, B, N-1, s, s], logdet [T,
    B], fc tuple of [T, B, K])``.  The covariance and log det are K1's on
    the trial precisions ``sym(Lambda + s_t dLambda)``, bit for bit; the
    costs are the linear batches' at the trial means ``mu + s_t dmu``.
    CUDA tensors launch the kernel (s in ``WIDE_BLOCK_SIZES``); CPU
    tensors run :func:`gbp_trials_plain`."""
    if pd.device.type == "cpu":
        return gbp_trials_plain(pd, po, dpd, dpo, mu, dmu, trials, lin_specs,
                                lin_arrays)
    with span("gvi.kernel.gbp_trials"):
        return _gbp_trials_kernel(pd, po, dpd, dpo, mu, dmu, trials,
                                  lin_specs, lin_arrays)


def _gbp_trials_kernel(pd, po, dpd, dpo, mu, dmu, trials, lin_specs,
                       lin_arrays):
    name = "gbp_trials_lanes"
    lead, n, s = _check(name, pd, po, dpd, dpo, mu, dmu, trials)
    if s not in WIDE_BLOCK_SIZES or len(lead) != 1:
        raise ValueError(f"{name}: the trial form takes [B, N, s, s] chains "
                         f"at s in {WIDE_BLOCK_SIZES}, got {tuple(pd.shape)}")
    b = lead[0]
    if (dpd.shape != pd.shape or dpo.shape != po.shape
            or mu.shape != (b, n, s) or dmu.shape != mu.shape
            or trials.ndim != 1 or trials.shape[0] < 1):
        raise ValueError(f"{name}: direction, means or trials do not match "
                         f"the iterate {tuple(pd.shape)}")
    nt = trials.shape[0]
    ops = [x.contiguous() for x in (pd, po, dpd, dpo, mu, dmu, trials)]
    lin = linear_args(name, ops[4], lin_specs, lin_arrays, nt * b)
    covd = torch.empty((nt, *pd.shape), dtype=pd.dtype, device=pd.device)
    covo = torch.empty((nt, *po.shape), dtype=pd.dtype, device=pd.device)
    ld = torch.empty((nt, b), dtype=pd.dtype, device=pd.device)
    plan = gbp_plan(n, s, pd.element_size())
    scratch = _scratch(plan, nt * b, s, pd)
    err = _build.load().gvi_gbp_trials(
        _build.DTYPES[pd.dtype], s,
        (ctypes.c_void_p * 7)(*(x.data_ptr() for x in ops)),
        covd.data_ptr(), covo.data_ptr(), ld.data_ptr(), _ptr(scratch), b, nt,
        n, plan.arena, lin.n, lin.ptrs, lin.ints,
        _build.current_stream(pd.device))
    _build.check(err, "gvi_gbp_trials")
    gbp_trials_lanes.launches += 1
    return covd, covo, ld, tuple(f.view(nt, b, -1) for f in lin.fc)


gbp_covariance_logdet_lanes.launches = 0
solve_lanes.launches = 0
gbp_trials_lanes.launches = 0
