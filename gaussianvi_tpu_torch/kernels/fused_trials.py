"""Fused line-search trial evaluation (K5): every trial of one NGD
iteration, chain + quadrature + linear costs, in one kernel.

Counterpart of ``gaussianvi_tpu/kernels/fused_trials.py``.  The inputs are
the current iterate and the step direction at width B; the T trial
iterates ``mu + s_t dmu``, ``sym(Lambda + s_t dLambda)`` exist only inside
the kernel.  Below s = 6 (``csrc/fused_trials.cu``) a block takes a
problem: the chain in shared memory, the trials' serial sweeps side by
side in a few warps, the (trial, edge) items over all threads, each edge's
covariance blocks going straight to the factors of that state and edge.
At s = 6 (``csrc/fused_trials_s6.cu``) the entry launches two passes: K1's
layout over the T x B trial chains with the linear factors' costs, whose
marginal covariances go to a scratch (:func:`trial_s6_block_elems`), then
a lane a (trial, problem, state) item for E[phi].  The outputs are the log
det ``[T, B]`` and one ``[T, B, K]`` cost array per factor batch,
nonlinear batches first, then linear.

The kernels take every operand problem-major, as the engine holds it: no
operand is copied or re-laid per call.  What a call adds is the block plan
(:func:`trial_plan`: trials held at once, the arena's size, shared memory
or, for a chain too long for it, a global scratch, whose size
:func:`trial_scratch_elems` gives) and each batch's per-state index
(:func:`state_index`, built once and kept on the start tensor).

Factor operands (built once per graph by ``inference.engine.LocalEngine``,
shared with the fused gradient kernel):

* nonlinear batch ``(start [K], nodes [M, s], weights [M], params
  [B, K, P])``, and a fifth entry, the cost's field (one tensor all
  problems read in place, :func:`nl_field`), for a cost that reads one;
  described by :class:`NLTrialSpec`; its cost is a CUDA functor named by
  ``kernel_cost`` (``kernels/quad.py`` KERNEL_COSTS), one for all the
  nonlinear batches of a launch;
* linear batch ``(start [K], a [B, Ka, blocks, s, s], lam [B, Ka, r,
  nb * s], pm [B, Ka, r], prec_c [B, Ka, r, r])`` in the residual form of
  :func:`linear_residual_form` (``blocks``: A for an anchor, A11, A22, A12
  for an edge), described by :class:`LinTrialSpec`.

``start`` reaches the kernels as a per-state index (:func:`state_index`)
for every batch, a slice of states too: one code path finds the factors at
a state.  Every cost carries the guards of the separate path
(``factors/moments.py``); the JAX kernel guards only the log det.
``trial_costs_lanes.launches`` counts kernel launches (never plain-version
calls); at s = 6 :data:`trials_s6_sweep` and :data:`trials_s6_costs`
count its two passes, one each a launch.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..factors.moments import expectation_phi, guard_linear_cost
from ..inference.graph import take_states
from ..ops.blocktridiag import BlockTridiag, gbp_edge_covariance
from ..utils.profiling import span
from . import _build
from .quad import (
    KERNEL_COSTS,
    WINDOW_COSTS,
    cost_form,
    field_covers,
    field_dims,
    quant_flag,
)

BLOCK_SIZES = (2, 4, 6)  # instantiated state-block sizes s (local dim d = s)
MAX_BATCHES = 4          # per kind (csrc/fused.cuh kMaxBatches)
# pointers and ints per nonlinear batch (csrc/fused.cuh kNLPtrs, kNLInts):
# nodes, weights, params, index, fc, field; k, m, nonneg, rdim, field rows,
# field cols, field depth, quant (offsets rounded through bfloat16)
NL_PTRS, NL_INTS = 6, 8
SMEM_LIMIT = 232448      # dynamic shared memory of a block on sm_90, bytes
SMEM_TARGET = 72 * 1024  # per block, so that three blocks share an SM
TRIAL_WARPS = 4          # csrc/fused_trials.cuh kTrialWarps
# threads of a block of K5's second pass at s = 6 (csrc/fused_trials_s6.cu
# kTrialCostThreads)
TRIAL_COST_THREADS = 128


class NLTrialSpec(NamedTuple):
    """Static description of one nonlinear (nb == 1) factor batch."""

    cost: str                    # kernel cost name (KERNEL_COSTS)
    k: int                       # factors in the batch
    m: int                       # rule nodes
    slice_offset: int | None     # start == offset + arange(k); None -> start
    # configuration-marginal rule (zero-padded nodes): the trial E[phi] is
    # exact as is; the gradient adds the closed-form lift
    rdim: int | None = None
    nonneg: bool = False         # nonneg_cost: the 4096-ulp band applies


class LinTrialSpec(NamedTuple):
    """Static description of one linear factor batch in residual form."""

    nb: int                      # 1 (anchor) or 2 (edge)
    k: int
    ka: int                      # 1 if uniform over K else k
    r: int                       # residual rank (lam rows)
    slice_offset: int | None


def nl_field(arrays):
    """The field of a nonlinear batch's operands ``(start, nodes, weights,
    params[, field])``, or None for a cost that reads none."""
    return arrays[4] if len(arrays) > 4 else None


def linear_residual_form(lam, psi, target_mu, target_prec, constant):
    """``(A, pm, prec_c)`` with

        cost = <A, Sig> + (lam mu - pm)^T prec_c (lam mu - pm)

    equal to ``factors.moments.linear_cost``: the constant folded into A
    and prec_c, A symmetrized.  The residual is evaluated as written, never
    expanded into the mu-quadratic, which cancels in float32.  Row axes
    (any leading axes): ``A [..., Ka, d, d]``, ``pm [..., Ka, r]``,
    ``prec_c [..., Ka, r, r]``."""
    c = constant[..., None, None]
    a = torch.einsum("...kra,...krs,...ksb->...kab", lam, target_prec, lam)
    a = 0.5 * (a + a.transpose(-1, -2)) * c
    pm = torch.einsum("...krt,...kt->...kr", psi, target_mu)
    prec_c = 0.5 * (target_prec + target_prec.transpose(-1, -2)) * c
    return a, pm, prec_c


def residual_weights(lam, pm, prec_c, mu_e):
    """``(r, w)`` with ``r = lam mu_e - pm`` and ``w = prec_c r``;
    ``mu_e [..., K, d]`` against rows ``[B, Ka, ...]`` (Ka in {1, K})."""
    res = (lam @ mu_e[..., None])[..., 0] - pm
    return res, (prec_c @ res[..., None])[..., 0]


def edge_blocks(joint_cov, s: int):
    """Per-edge ``(Sig_ii, Sig_jj, Sig_ij)`` and per-state covariance
    ``[..., N, s, s]`` from the edges' joint covariances: state i < N-1
    takes edge i's ``Sig_ii``, the last state edge N-2's ``Sig_jj``."""
    cii = joint_cov[..., :s, :s]
    cjj = joint_cov[..., s:, s:]
    cij = joint_cov[..., :s, s:]
    return cii, cjj, cij, torch.cat([cii, cjj[..., -1:, :, :]], dim=-3)


def edge_means(mu, start, slice_offset):
    """``[mu_i, mu_i+1]`` of every edge factor: ``[..., K, 2s]``."""
    return torch.cat([take_states(mu, start, slice_offset, 1),
                      take_states(mu, start, slice_offset, 1, 1)], dim=-1)


def trial_costs_plain(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                      lin_specs, nl_arrays, lin_arrays, eval_dtype=None):
    """Plain version of K5: ``(ld [T, B], fc tuple of [T, B, K])``.

    Trial iterates for all T at once, the plain GBP sweeps, guarded E[phi]
    on the gathered marginals (offsets rounded through ``eval_dtype``, in
    the kernel's order, where it is set) and the residual-form linear
    costs, each read from its edge's joint covariance as the kernel reads
    it."""
    st = trials.reshape(-1, 1, 1, 1)
    t_mu = mu + st * dmu                                   # [T, B, N, s]
    st = st[..., None]
    t_prec = BlockTridiag(pd + st * dpd, po + st * dpo).symmetrize()
    joint_cov, ld = gbp_edge_covariance(t_prec)
    cii, cjj, cij, cov = edge_blocks(joint_cov, mu.shape[-1])
    out = []
    for spec, arrays in zip(nl_specs, nl_arrays):
        start, nodes, weights, params = arrays[:4]
        off = spec.slice_offset
        out.append(expectation_phi(
            nodes, weights, take_states(t_mu, start, off, 1),
            take_states(cov, start, off, 2),
            cost_form(spec.cost, nl_field(arrays)), params, eval_dtype,
            nonneg=spec.nonneg, kernel_order=eval_dtype is not None))
    return ld, (*out, *linear_costs_plain(t_mu, cov, cii, cjj, cij,
                                          lin_specs, lin_arrays))


def linear_costs_plain(t_mu, cov, cii, cjj, cij, lin_specs, lin_arrays):
    """The guarded residual-form costs of the linear batches, one ``[...,
    K]`` tensor each, at the means ``t_mu [..., N, s]``: an anchor's from
    its state's block of ``cov [..., N, s, s]``, an edge's from its
    ``Sig_ii``, ``Sig_jj``, ``Sig_ij`` (``cii``, ``cjj``, ``cij`` ``[...,
    N-1, s, s]``: the edges' joint covariances, or the chain's
    neighbouring blocks)."""
    out = []
    for spec, (start, a, lam, pm, prec_c) in zip(lin_specs, lin_arrays):
        off = spec.slice_offset
        if spec.nb == 1:
            mu_e = take_states(t_mu, start, off, 1)
            tr = torch.sum(a[..., 0, :, :] * take_states(cov, start, off, 2),
                           dim=(-2, -1))
        else:
            mu_e = edge_means(t_mu, start, off)
            tr = (torch.sum(a[..., 0, :, :] * take_states(cii, start, off, 2),
                            dim=(-2, -1))
                  + torch.sum(a[..., 1, :, :]
                              * take_states(cjj, start, off, 2), dim=(-2, -1))
                  + 2.0 * torch.sum(a[..., 2, :, :]
                                    * take_states(cij, start, off, 2),
                                    dim=(-2, -1)))
        res, w = residual_weights(lam, pm, prec_c, mu_e)
        out.append(guard_linear_cost(torch.sum(res * w, dim=-1) + tr))
    return tuple(out)


# ---------------------------------------------------------------------------
# kernel launch (shared with kernels/fused_gradient.py)
# ---------------------------------------------------------------------------

def mat_pitch(s: int) -> int:
    """Arena words of an s x s block (csrc/fused.cuh Pitch::kMat): one
    more than it holds, so a warp's lanes fall on different banks."""
    return s * s + 1


def vec_pitch(s: int) -> int:
    """Arena words of an s-vector (Pitch::kVec)."""
    return s + 1


class BlockPlan(NamedTuple):
    """How a fused kernel lays its chains on the card."""

    warps: int        # warps of a block (K6: one problem each)
    arena: int        # arena values per block (K6: per problem)
    smem: int         # dynamic shared memory of a block, bytes
    scratch: bool     # the arena lives in a global scratch, not in smem
    chunk: int = 0    # K5: trials the arena holds at once


def trial_arena_elems(n: int, s: int, chunk: int) -> int:
    """Arena of one K5 block (csrc/fused_trials.cuh trial_arena_elems): the
    staged pd, dpd, po, dpo, then F and G per trial held."""
    return (4 + 2 * chunk) * n * mat_pitch(s)


def trial_plan(name: str, n: int, s: int, nt: int, itemsize: int,
               fixed_bytes: int) -> BlockPlan:
    """K5's blocks.  Below s = 6, a block of ``TRIAL_WARPS`` warps a
    problem holds as many of the T trials at once as fit shared memory
    beside the rules (``fixed_bytes``); a chain that does not fit with one
    trial goes to a global scratch.  At s = 6, the first pass's plan: K1's
    one-warp blocks (``chain.gbp_plan``) over all T trials at once; the
    second pass takes the rules alone."""
    if fixed_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: rules of {fixed_bytes} bytes "
                         f"exceed the {SMEM_LIMIT} bytes of shared memory")
    if s == 6:
        from .chain import gbp_plan   # chain.py imports this module

        return gbp_plan(n, s, itemsize)._replace(chunk=nt)

    def plan(chunk, scratch):
        arena = trial_arena_elems(n, s, chunk)
        smem = fixed_bytes + (0 if scratch else arena * itemsize)
        return BlockPlan(TRIAL_WARPS, arena, smem, scratch, chunk)

    for chunk in range(nt, 0, -1):
        found = plan(chunk, False)
        if found.smem <= SMEM_LIMIT:
            return found
    return plan(nt, True)


def trial_s6_block_elems(chains: int, n: int) -> int:
    """The scratch that carries K5's marginal covariances from its first
    pass to its second at s = 6 (csrc/fused_trials_s6.cu
    trial_s6_block_elems): per trial chain, Sig_ii of its ``n`` states."""
    return chains * n * 36


def trial_s6_grids(b: int, n: int, nt: int) -> tuple[int, int]:
    """Blocks of K5's two passes at s = 6: one-warp blocks of two trial
    chains each (csrc/chain.cuh chain_blocks), then the ``nt * b * n``
    (trial, problem, state) items over blocks of ``TRIAL_COST_THREADS``."""
    return -(-nt * b // 2), -(-nt * b * n // TRIAL_COST_THREADS)


def trial_scratch_elems(plan: BlockPlan, b: int, n: int, s: int,
                        nt: int) -> int:
    """Values of the global scratch a K5 launch over ``b`` problems takes
    (0: none): below s = 6 the blocks' arenas where ``plan.scratch``; at
    s = 6 the marginal covariances, then the first pass's arenas where
    ``plan.scratch``."""
    if s != 6:
        return b * plan.arena if plan.scratch else 0
    warps = trial_s6_grids(b, n, nt)[0]
    return (trial_s6_block_elems(nt * b, n)
            + (warps * plan.arena if plan.scratch else 0))


def state_index(start: torch.Tensor, n: int) -> torch.Tensor:
    """The per-state index of a batch's starts, int32 ``[n + 1 + K]``:
    offsets ``[n + 1]`` into the factors ordered by state (ascending k
    within a state) ``[K]``, so that the factors at state i are
    ``order[offs[i]:offs[i + 1]]``.  Built once per start tensor and
    kept on it."""
    cached = getattr(start, "_gvi_state_index", None)
    if cached is not None and cached[:2] == (start._version, n):
        return cached[2]
    order = torch.argsort(start, stable=True)
    counts = torch.bincount(start, minlength=n)[:n]
    offs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    index = torch.cat([offs, order]).to(torch.int32)
    start._gvi_state_index = (start._version, n, index)
    return index


def check_state(name, mu, pd, po, *same):
    """Validate the iterate blocks; returns ``(B, N, s)``."""
    if mu.dtype not in _build.DTYPES:
        raise ValueError(f"{name}: dtype {mu.dtype} not supported "
                         "(float32 or float64)")
    if mu.ndim != 3:
        raise ValueError(f"{name}: mu must be [B, N, s], got "
                         f"{tuple(mu.shape)}")
    b, n, s = mu.shape
    if s not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size s={s} not instantiated "
                         f"(have {BLOCK_SIZES})")
    if n < 2:
        raise ValueError(f"{name}: the fused kernels need N >= 2 states")
    want = {"pd": (b, n, s, s), "po": (b, n - 1, s, s)}
    for key, t in (("pd", pd), ("po", po)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, "
                             f"expected {want[key]}")
    for t in (pd, po, *same):
        if t.device != mu.device or t.dtype != mu.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    return b, n, s


def covers(s: int, dtype: torch.dtype, nl_specs, lin_specs,
           trials: bool = True) -> str | None:
    """Why the fused kernels (K5, or K6 for ``trials=False``) do not cover
    factor batches of these specs on chains of block size ``s`` in
    ``dtype``, or None where they do.  The engine checks it before any call
    (``fused_operands``), the wrappers before a launch; the global-scratch
    route takes any chain length, so the rules are the one size that can
    fail.  K5 refuses the patch mode's costs (``quad.WINDOW_COSTS``), as
    the JAX package's trial kernel refuses its prep batches: a window
    follows the factor's mean, and the trials' means exist only inside
    the kernel."""
    if dtype not in _build.DTYPES:
        return f"dtype {dtype} not supported (float32 or float64)"
    if s not in BLOCK_SIZES:
        return f"block size s={s} not instantiated (have {BLOCK_SIZES})"
    if len(nl_specs) > MAX_BATCHES or len(lin_specs) > MAX_BATCHES:
        return (f"at most {MAX_BATCHES} nonlinear and {MAX_BATCHES} linear "
                "batches")
    costs = {sp.cost for sp in nl_specs} or {"range"}
    if len(costs) != 1 or not costs <= set(KERNEL_COSTS):
        return (f"the nonlinear batches must share one kernel cost of "
                f"{sorted(KERNEL_COSTS)}, got {sorted(costs)}")
    cost = costs.pop()
    if trials and cost in WINDOW_COSTS:
        return (f"cost {cost!r} reads windows that follow the factors' "
                "means; the trial kernel forms the trial means in-kernel "
                "(the patch mode takes the separate trial costs)")
    if s not in KERNEL_COSTS[cost][2]:
        return f"cost {cost!r} not instantiated for d={s}"
    why = linear_covers(s, lin_specs)
    if why is not None:
        return why
    rules = sum(sp.m * (s + 1) for sp in nl_specs) * dtype.itemsize
    if rules > SMEM_LIMIT:
        return (f"rules of {rules} bytes exceed the {SMEM_LIMIT} bytes of "
                "shared memory")
    return None


def linear_covers(s: int, lin_specs) -> str | None:
    """Why the kernels that take linear batches in residual form (K5, K6,
    K1's trial form) do not cover batches of these specs on chains of
    block size ``s``, or None where they do."""
    if len(lin_specs) > MAX_BATCHES:
        return f"at most {MAX_BATCHES} linear batches"
    for sp in lin_specs:
        if sp.nb not in (1, 2) or not 1 <= sp.r <= 2 * s or sp.ka not in (
                1, sp.k):
            return (f"linear batch {sp} not supported (nb 1 or 2, "
                    "1 <= r <= 2s, ka 1 or k)")
    return None


class FactorArgs(NamedTuple):
    """The factor operands as the C entry points take them."""

    cost: int
    n_params: int
    n_nl: int
    nl_ptrs: ctypes.Array
    nl_ints: ctypes.Array
    n_lin: int
    lin_ptrs: ctypes.Array
    lin_ints: ctypes.Array
    keep: list           # tensors the pointers refer to
    fc: tuple            # per batch [rows, K] cost outputs (trial kernel)
    fixed_bytes: int     # shared memory of the rules


def factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays,
                rows: int | None = None, eval_dtype=None,
                trials: bool = True) -> FactorArgs:
    """Check and pack the factor operands for a launch at ``mu [B, N, s]``:
    every per-problem operand as it is (problem-major, contiguous), each
    batch's per-state index, and a nonlinear batch's field (null and
    0 x 0 x 0 for a cost without one) and offset rounding (``eval_dtype``
    None or bfloat16).  ``rows`` (trial kernel, T * B): allocate
    ``[rows, K]`` cost outputs; ``trials``: for K5 (else K6)."""
    b, _, s = mu.shape
    quant = quant_flag(name, eval_dtype)
    dt, dev = mu.dtype, mu.device
    why = covers(s, dt, nl_specs, lin_specs, trials)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    cost = nl_specs[0].cost if nl_specs else "range"
    cost_id, _, dims, _ = KERNEL_COSTS[cost]
    n_params = dims[s]

    keep, fc, nl_ptrs, nl_ints, fixed = [], [], [], [], 0
    for sp, arrays in zip(nl_specs, nl_arrays):
        start, nodes, weights, params = arrays[:4]
        field = nl_field(arrays)
        _same(name, mu, nodes, (sp.m, s), "nodes")
        _same(name, mu, weights, (sp.m,), "weights")
        _same(name, mu, params, (b, sp.k, n_params), "kernel_params")
        why = field_covers(sp.cost, field, dt)
        if why is not None:
            raise ValueError(f"{name}: {why}")
        if field is not None:
            field = field.contiguous()
            if field.device != dev:
                raise ValueError(f"{name}: field on another device")
        fixed += sp.m * (s + 1) * mu.element_size()
        ops = [nodes.contiguous(), weights.contiguous(), params.contiguous(),
               _index_of(name, mu, sp, start)]
        ops.append(None if rows is None else
                   torch.empty((rows, sp.k), dtype=dt, device=dev))
        if rows is not None:
            fc.append(ops[-1])
        ops.append(field)
        keep += [t for t in ops if t is not None]
        nl_ptrs += [t.data_ptr() if t is not None else None for t in ops]
        nl_ints += [sp.k, sp.m, int(sp.nonneg),
                    s if sp.rdim is None else sp.rdim, *field_dims(field),
                    quant]
    lin = linear_args(name, mu, lin_specs, lin_arrays, rows)
    return FactorArgs(cost_id, n_params, len(nl_specs),
                      _array(ctypes.c_void_p, nl_ptrs),
                      _array(ctypes.c_int, nl_ints), lin.n, lin.ptrs,
                      lin.ints, keep + lin.keep, (*fc, *lin.fc), fixed)


class LinearArgs(NamedTuple):
    """The linear batches' operands as the C entry points take them."""

    n: int
    ptrs: ctypes.Array
    ints: ctypes.Array
    keep: list           # tensors the pointers refer to
    fc: tuple            # per batch [rows, K] cost outputs, where asked for


def _array(ctype, values):
    return (ctype * max(len(values), 1))(*values)


def _same(name, mu, t, shape, what):
    """``t`` has ``shape`` and ``mu``'s device and dtype, or raise."""
    if t.device != mu.device or t.dtype != mu.dtype:
        raise ValueError(f"{name}: {what} on another device/dtype")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _index_of(name, mu, sp, start):
    """The per-state index of a batch's ``start [K]`` on ``mu``'s
    chains."""
    if start.shape != (sp.k,) or start.device != mu.device:
        raise ValueError(f"{name}: start must be [{sp.k}] on {mu.device}")
    return state_index(start, mu.shape[1])


def linear_args(name, mu, lin_specs, lin_arrays,
                rows: int | None = None) -> LinearArgs:
    """Check and pack the linear batches' operands (residual form) for a
    launch at ``mu [B, N, s]``: each operand as it is (problem-major,
    contiguous) and the batch's per-state index; ``rows``: allocate
    ``[rows, K]`` cost outputs."""
    b, _, s = mu.shape
    keep, fc, ptrs, ints = [], [], [], []
    for sp, (start, a, lam, pm, prec_c) in zip(lin_specs, lin_arrays):
        _same(name, mu, a, (b, sp.ka, 3 if sp.nb == 2 else 1, s, s), "A")
        _same(name, mu, lam, (b, sp.ka, sp.r, sp.nb * s), "lam")
        _same(name, mu, pm, (b, sp.ka, sp.r), "pm")
        _same(name, mu, prec_c, (b, sp.ka, sp.r, sp.r), "prec_c")
        ops = [a.contiguous(), lam.contiguous(), pm.contiguous(),
               prec_c.contiguous(), _index_of(name, mu, sp, start)]
        if rows is not None:
            ops.append(torch.empty((rows, sp.k), dtype=mu.dtype,
                                   device=mu.device))
            fc.append(ops[-1])
        keep += ops
        ptrs += [t.data_ptr() for t in ops]
        ptrs += [None] * (6 - len(ops))
        ints += [sp.nb, sp.k, sp.ka, sp.r]
    return LinearArgs(len(lin_specs), _array(ctypes.c_void_p, ptrs),
                      _array(ctypes.c_int, ints), keep, tuple(fc))


def trial_costs_lanes(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                      lin_specs, nl_arrays, lin_arrays, eval_dtype=None):
    """K5: ``mu, dmu [B, N, s]``, ``pd, dpd [B, N, s, s]``, ``po, dpo
    [B, N-1, s, s]``, ``trials [T]`` and the factor operands (module
    docstring) -> ``(ld [T, B], fc tuple of [T, B, K])``, nonlinear batches
    first.  ``eval_dtype`` None or bfloat16: the sigma offsets rounded
    through it and back.  CUDA tensors launch the kernel; CPU tensors run
    :func:`trial_costs_plain`."""
    if mu.device.type == "cpu":
        return trial_costs_plain(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                                 lin_specs, nl_arrays, lin_arrays, eval_dtype)
    with span("gvi.kernel.fused_trials"):
        return _trial_costs_kernel(mu, dmu, pd, po, dpd, dpo, trials,
                                   nl_specs, lin_specs, nl_arrays, lin_arrays,
                                   eval_dtype)


def _trial_costs_kernel(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                        lin_specs, nl_arrays, lin_arrays, eval_dtype):
    name = "trial_costs_lanes"
    b, n, s = check_state(name, mu, pd, po, dmu, dpd, dpo, trials)
    if dmu.shape != mu.shape or dpd.shape != pd.shape or dpo.shape != po.shape:
        raise ValueError(f"{name}: direction shapes differ from the iterate's")
    if trials.ndim != 1 or trials.shape[0] < 1:
        raise ValueError(f"{name}: trials must be [T], T >= 1")
    nt = trials.shape[0]
    fa = factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays,
                     nt * b, eval_dtype)
    plan = trial_plan(name, n, s, nt, mu.element_size(), fa.fixed_bytes)
    # at s = 6 the blocks are read in 16-byte pieces (csrc/fused.cuh
    # load_block_vec)
    ops = [x.contiguous() if s != 6 or x.data_ptr() % 16 == 0 else
           x.clone(memory_format=torch.contiguous_format)
           for x in (mu, dmu, pd, po, dpd, dpo, trials)]
    ld = torch.empty((nt, b), dtype=mu.dtype, device=mu.device)
    elems = trial_scratch_elems(plan, b, n, s, nt)
    scratch = (torch.empty((elems,), dtype=mu.dtype, device=mu.device)
               if elems else None)
    err = _build.load().gvi_fused_trials(
        _build.DTYPES[mu.dtype], s, fa.cost, fa.n_params,
        *(x.data_ptr() for x in ops), ld.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, n, nt,
        plan.warps, plan.chunk, plan.arena, fa.n_nl, fa.nl_ptrs, fa.nl_ints, fa.n_lin,
        fa.lin_ptrs, fa.lin_ints, _build.current_stream(mu.device),
    )
    _build.check(err, "gvi_fused_trials")
    trial_costs_lanes.launches += 1
    if s == 6:
        trials_s6_sweep.launches += 1
        trials_s6_costs.launches += 1
    return ld, tuple(f.view(nt, b, -1) for f in fa.fc)


trial_costs_lanes.launches = 0
# K5's two passes at s = 6, counted beside its launches
# (``kernels.WRAPPERS``; both run under its span)
trials_s6_sweep = SimpleNamespace(launches=0)
trials_s6_costs = SimpleNamespace(launches=0)
