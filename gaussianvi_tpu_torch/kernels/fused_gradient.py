"""Fused NGD gradient step (K6): covariance + moments + joint
natural-gradient assembly + both block-Thomas solves in one kernel, or
split in two where the nonlinear factors are sharded over ranks.

Counterpart of ``gaussianvi_tpu/kernels/fused_gradient.py``.  The inputs
are the current iterate ``mu``, ``(prec_diag, prec_off)``, the per-problem
temperature and the factor operands the fused trial kernel takes
(``kernels/fused_trials.py``), all problem-major as the engine holds them:
nothing is copied or re-laid per call and every output is allocated in its
final shape.  Mode ``"full"`` (``csrc/fused_gradient.cu``, at s = 6
``csrc/fused_gradient_s6.cu``: a warp per problem, the chain in shared
memory, or in a global scratch where it is too long, :func:`grad_plan`)
returns the iterate's covariance blocks and log
det, ``dprec = Vddmu - Lambda``, and the solutions of ``Vddmu dmu = -Vdmu``
(NaN where Vddmu is indefinite) and of the SPD fallback
``Lambda dmu_fb = -Vdmu``.  The linear factors enter through the residual
form: ``Vdmu = 2 Lam^T prec_c (Lam mu - pm) / T``, ``Vddmu = 2 A / T``,
which equals the separate path for symmetric target precisions (every
library prior builds them so).

The factor-parallel path (``parallel/sharding.py``) runs the same program
as a pair: mode ``"accum"`` (``csrc/fused_gradient_accum.cu``, at s = 6
``csrc/fused_gradient_accum_s6.cu``) returns the
partial ``(Vdmu, Vddmu diag, Vddmu off)`` of the nonlinear factors it is
given, as views of one buffer (:class:`Partials`) so that they are summed
over the ranks in one all-reduce; mode ``"solve"``
(``csrc/fused_gradient_solve.cu``, at s = 6
``csrc/fused_gradient_solve_s6.cu``) takes that sum as ``seeds``, adds the
linear factors and returns what ``"full"`` returns.

Each mode's kernel launches are counted on its own wrapper (never
plain-version calls): ``gradient_lanes.launches`` for ``"full"``,
``gradient_accum_lanes.launches`` and ``gradient_solve_lanes.launches``
for the pair, whichever of the three functions was called.
"""

from __future__ import annotations

import math

import torch

from ..factors.moments import gh_moments, ngd_local_gradients
from ..inference.graph import scatter_gradients, take_states
from ..ops.blocktridiag import BlockTridiag, gbp_edge_covariance, solve
from ..utils.profiling import span
from . import _build
from .fused_trials import (
    SMEM_LIMIT,
    SMEM_TARGET,
    BlockPlan,
    check_state,
    edge_blocks,
    edge_means,
    factor_args,
    mat_pitch,
    nl_field,
    residual_weights,
    vec_pitch,
)
from .quad import cost_form


def _full_a(a, nb: int):
    """The residual form's A ``[..., Ka, 2s, 2s]`` (nb == 2, from its A11,
    A22, A12 blocks) or ``[..., Ka, s, s]`` (nb == 1)."""
    if nb == 1:
        return a[..., 0, :, :]
    top = torch.cat([a[..., 0, :, :], a[..., 2, :, :]], dim=-1)
    bot = torch.cat([a[..., 2, :, :].transpose(-1, -2), a[..., 1, :, :]],
                    dim=-1)
    return torch.cat([top, bot], dim=-2)


GRAD_WARPS = 4       # csrc/fused_gradient.cuh kGradWarps
# block sizes s each mode is instantiated at (csrc/fused_gradient.cuh
# launch_grad; the dtypes and costs are fused_trials.covers')
MODE_BLOCK_SIZES = {"full": (2, 4, 6), "accum": (2, 4, 6),
                    "solve": (2, 4, 6)}
# the patch mode's costs (quad.WINDOW_COSTS) are instantiated in modes
# "full" and "accum" only, at the planners' block sizes
WINDOW_BLOCK_SIZES = {"planar_patch": (4,), "sdf3d_patch": (6,)}


def covers(s: int, modes, costs=()) -> str | None:
    """Why K6 in every mode of ``modes`` does not cover chains of block
    size ``s`` with the nonlinear batches' kernel ``costs``, or None where
    it does (beside ``fused_trials.covers``, which both fused kernels
    share).  The engine resolves ``fused_gradient`` by it for the modes it
    runs, the wrapper checks it before a launch."""
    for mode in modes:
        if s not in MODE_BLOCK_SIZES[mode]:
            return (f"K6 mode {mode!r} not instantiated for s={s} (have "
                    f"{MODE_BLOCK_SIZES[mode]})")
        if mode == "solve":
            continue
        for cost in costs:
            if s not in WINDOW_BLOCK_SIZES.get(cost, (s,)):
                return (f"K6 mode {mode!r} not instantiated for cost "
                        f"{cost!r} at s={s} (have "
                        f"{WINDOW_BLOCK_SIZES[cost]})")
    return None


def grad_chain_elems(n: int, s: int) -> int:
    """Arena of one K6 problem (csrc/fused_gradient.cuh grad_chain_elems):
    pd, po, both pivot arrays, vdd, vdo as n blocks each; mu, vdmu and the
    two solves' vectors as n vectors each."""
    return n * (6 * mat_pitch(s) + 4 * vec_pitch(s))


# the K6 instances at s = 6 that run the lane-group layout, (itemsize,
# kernel cost, mode) (csrc/fused_gradient_s6.cuh GradS6Groups; the others
# run the lane-per-edge layout; "full" and "accum" of one (itemsize, cost)
# alike, so that "accum" + "solve" give "full"'s bits); mode "solve" runs
# the range cost's instance whatever the model
GRAD_S6_GROUPS = frozenset({
    (4, "sdf3d_patch", "full"), (8, "sdf3d_patch", "full"),
    (4, "sdf3d_patch", "accum"), (8, "sdf3d_patch", "accum"),
    (4, "sdf3d", "full"), (4, "sdf3d", "accum"), (4, "range", "solve"),
    (8, "range", "solve")})


def grad_groups(s: int, itemsize: int, cost: str, mode: str) -> bool:
    """Whether the K6 instance for ``(s, itemsize, cost, mode)`` runs the
    lane-group layout (``GRAD_S6_GROUPS``); ``cost`` the nonlinear
    batches' kernel cost, the range cost where there is none."""
    return s == 6 and (itemsize, cost, mode) in GRAD_S6_GROUPS


def grad_work_elems(s: int) -> int:
    """Shared work area of one K6 warp in the lane-group layout
    (csrc/fused_gradient_s6.cuh grad_s6_work_elems): an s x (s + 1) block
    for each of the warp's four lane groups."""
    return 4 * s * (s + 1)


def grad_plan(name: str, n: int, s: int, itemsize: int,
              fixed_bytes: int, cost: str = "range",
              mode: str = "full") -> BlockPlan:
    """K6's block for the instance of ``(cost, mode)``: 4, 2 or 1
    problems (warps) whose chains (with their work areas, in the
    lane-group layout) fit ``SMEM_TARGET`` beside the rules
    (``fixed_bytes``), else one problem in all of shared memory, else (a
    chain too long for that) the arena in a global scratch, the work
    areas staying in shared memory."""
    if fixed_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: rules of {fixed_bytes} bytes "
                         f"exceed the {SMEM_LIMIT} bytes of shared memory")
    chain = grad_chain_elems(n, s)
    work = grad_work_elems(s) if grad_groups(s, itemsize, cost, mode) else 0
    for warps in (GRAD_WARPS, 2, 1):
        smem = fixed_bytes + warps * (chain + work) * itemsize
        if smem <= (SMEM_TARGET if warps > 1 else SMEM_LIMIT):
            return BlockPlan(warps, chain, smem, False)
    return BlockPlan(GRAD_WARPS, chain,
                     fixed_bytes + GRAD_WARPS * work * itemsize, True)


# mode -> C entry point
_ENTRIES = {"full": "gvi_fused_grad", "accum": "gvi_fused_grad_accum",
            "solve": "gvi_fused_grad_solve"}


class Partials(tuple):
    """``(vdmu [B, N, s], vdd [B, N, s, s], vdo [B, N-1, s, s])``, the
    joint gradient accumulators, as views of the one tensor ``buffer``: an
    in-place sum of ``buffer`` over ranks sums all three."""

    buffer: torch.Tensor

    def __new__(cls, b, n, s, dtype, device, zero: bool):
        shapes = ((b, n, s), (b, n, s, s), (b, n - 1, s, s))
        sizes = [math.prod(sh) for sh in shapes]
        buffer = (torch.zeros if zero else torch.empty)(
            sum(sizes), dtype=dtype, device=device)
        parts = [p.view(sh) for p, sh in zip(buffer.split(sizes), shapes)]
        self = super().__new__(cls, parts)
        self.buffer = buffer
        return self


def _accumulate(mu, cov_diag, temperature, nl_specs, lin_specs, nl_arrays,
                lin_arrays, vdmu, vdd, eval_dtype=None):
    """Add every factor's local gradients into ``vdmu`` / ``vdd`` in place:
    the sigma-point moments with the marginal-rule lift (offsets rounded
    through ``eval_dtype``, in the kernel's order, where it is set) and the
    NGD local gradients of the nonlinear batches, the residual-form
    gradients of the linear ones."""
    b, _, s = mu.shape
    t = temperature[:, None, None]
    for spec, arrays in zip(nl_specs, nl_arrays):
        start, nodes, weights, params = arrays[:4]
        off = spec.slice_offset
        cov_k = take_states(cov_diag, start, off, 2)
        moments = gh_moments(nodes, weights, take_states(mu, start, off, 1),
                             cov_k, cost_form(spec.cost, nl_field(arrays)),
                             params, eval_dtype, rdim=spec.rdim,
                             kernel_order=eval_dtype is not None)
        vd_k, vdd_k = ngd_local_gradients(*moments, cov_k, temperature)
        scatter_gradients(start, 1, vd_k, vdd_k, vdmu, vdd, off)
    for spec, (start, a, lam, pm, prec_c) in zip(lin_specs, lin_arrays):
        off = spec.slice_offset
        mu_e = (take_states(mu, start, off, 1) if spec.nb == 1
                else edge_means(mu, start, off))
        _, w = residual_weights(lam, pm, prec_c, mu_e)
        vd_k = 2.0 * (lam.transpose(-1, -2) @ w[..., None])[..., 0] / t
        d = spec.nb * s
        vdd_k = (2.0 * _full_a(a, spec.nb) / t[..., None]).expand(
            b, spec.k, d, d)
        scatter_gradients(start, spec.nb, vd_k, vdd_k, vdmu, vdd, off)


def gradient_plain(mu, pd, po, temperature, nl_specs, lin_specs, nl_arrays,
                   lin_arrays, mode: str = "full", seeds=None,
                   eval_dtype=None):
    """Plain version of K6 in each mode.

    ``"full"`` / ``"solve"``: ``(cov_diag, cov_off, logdet, dprec_diag,
    dprec_off, dmu, dmu_fallback)`` from the plain GBP, the factors' local
    gradients scattered per state and edge (onto zeros, or onto a copy of
    ``seeds``), then both solves.  ``"accum"``: the :class:`Partials` of the
    factors given, nothing else."""
    b, n, s = mu.shape
    prec = BlockTridiag(pd, po)
    joint_cov, ld = gbp_edge_covariance(prec)
    _, _, cov_off, cov_diag = edge_blocks(joint_cov, s)
    acc = Partials(b, n, s, mu.dtype, mu.device, zero=True)
    vdmu, vdd = acc[0], BlockTridiag(acc[1], acc[2])
    if mode == "solve":
        for dst, src in zip(acc, seeds):
            dst.copy_(src)
    _accumulate(mu, cov_diag, temperature, nl_specs, lin_specs, nl_arrays,
                lin_arrays, vdmu, vdd, eval_dtype)
    if mode == "accum":
        return acc
    dprec = vdd - prec
    return (cov_diag, cov_off, ld, dprec.diag, dprec.off,
            solve(vdd, -vdmu), solve(prec, -vdmu))


def _check_mode(name, mode, seeds, nl_specs, lin_specs, mu):
    if mode not in _ENTRIES:
        raise ValueError(f"{name}: unknown mode {mode!r} (one of "
                         f"{tuple(_ENTRIES)})")
    if (mode == "solve") != (seeds is not None):
        raise ValueError(f"{name}: seeds go with mode 'solve', and only "
                         "with it")
    if mode == "accum" and lin_specs:
        raise ValueError(f"{name}: mode 'accum' takes nonlinear factors "
                         "only (the linear ones go to mode 'solve')")
    if mode == "solve":
        if nl_specs:
            raise ValueError(f"{name}: mode 'solve' takes linear factors "
                             "only (the nonlinear ones go to mode 'accum')")
        b, n, s = mu.shape
        want = ((b, n, s), (b, n, s, s), (b, n - 1, s, s))
        if len(seeds) != 3 or any(
                tuple(x.shape) != sh or x.dtype != mu.dtype
                or x.device != mu.device for x, sh in zip(seeds, want)):
            raise ValueError(f"{name}: seeds must be (vdmu, vdd, vdo) of "
                             f"shapes {want} with mu's dtype and device")


def gradient_lanes(mu, pd, po, temperature, nl_specs, lin_specs, nl_arrays,
                   lin_arrays, mode: str = "full", seeds=None,
                   eval_dtype=None):
    """K6: ``mu [B, N, s]``, ``pd [B, N, s, s]``, ``po [B, N-1, s, s]``,
    ``temperature [B]`` and the factor operands of
    ``kernels/fused_trials.py``.

    Modes ``"full"`` and ``"solve"`` (``seeds``: the summed ``(vdmu, vdd,
    vdo)`` of the ``"accum"`` calls, left untouched; linear operands only)
    -> ``(cov_diag [B, N, s, s], cov_off [B, N-1, s, s], logdet [B],
    dprec_diag, dprec_off, dmu [B, N, s], dmu_fallback [B, N, s])``.  Mode
    ``"accum"`` (nonlinear operands only) -> :class:`Partials`.
    ``eval_dtype`` None or bfloat16: the sigma offsets rounded through it
    and back.  CUDA tensors launch the mode's kernel; CPU tensors run
    :func:`gradient_plain`."""
    name = "gradient_lanes"
    _check_mode(name, mode, seeds, nl_specs, lin_specs, mu)
    if mu.device.type == "cpu":
        return gradient_plain(mu, pd, po, temperature, nl_specs, lin_specs,
                              nl_arrays, lin_arrays, mode, seeds, eval_dtype)
    with span(_SPANS[mode]):
        return _gradient_kernel(mu, pd, po, temperature, nl_specs, lin_specs,
                                nl_arrays, lin_arrays, mode, seeds,
                                eval_dtype)


def _gradient_kernel(mu, pd, po, temperature, nl_specs, lin_specs, nl_arrays,
                     lin_arrays, mode, seeds, eval_dtype):
    name = "gradient_lanes"
    b, n, s = check_state(name, mu, pd, po, temperature)
    why = covers(s, (mode,), {sp.cost for sp in nl_specs})
    if why is not None:
        raise ValueError(f"{name}: {why}")
    if temperature.shape != (b,):
        raise ValueError(f"{name}: temperature must be [{b}]")
    fa = factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays,
                     eval_dtype=eval_dtype, trials=False)
    plan = grad_plan(name, n, s, mu.element_size(), fa.fixed_bytes,
                     nl_specs[0].cost if nl_specs else "range", mode)
    ins = [x.contiguous() for x in (mu, pd, po, temperature)]
    dt, dev = mu.dtype, mu.device
    # the accumulators reach device memory only as the outputs of "accum"
    # and as the seeds of "solve", which the kernel reads and never writes
    if mode == "accum":
        acc = Partials(b, n, s, dt, dev, zero=False)
        outs = [None] * 7
    else:
        acc = ([x.contiguous() for x in seeds] if mode == "solve"
               else [None] * 3)
        outs = [torch.empty_like(ins[1]), torch.empty_like(ins[2]),
                torch.empty((b,), dtype=dt, device=dev),
                torch.empty_like(ins[1]), torch.empty_like(ins[2]),
                torch.empty_like(ins[0]), torch.empty_like(ins[0])]
    blocks = -(-b // plan.warps)
    scratch = (torch.empty((blocks * plan.warps * plan.arena,), dtype=dt,
                           device=dev) if plan.scratch else None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    entry = _ENTRIES[mode]
    err = getattr(_build.load(), entry)(
        _build.DTYPES[dt], s, fa.cost, fa.n_params, *map(ptr, ins),
        *map(ptr, outs), *map(ptr, acc), ptr(scratch), b, n, plan.warps,
        plan.arena, fa.n_nl, fa.nl_ptrs, fa.nl_ints, fa.n_lin, fa.lin_ptrs,
        fa.lin_ints, _build.current_stream(dev),
    )
    _build.check(err, entry)
    _COUNTED[mode].launches += 1
    return acc if mode == "accum" else tuple(outs)


def gradient_accum_lanes(mu, pd, po, temperature, nl_specs, nl_arrays,
                         eval_dtype=None):
    """K6 mode ``"accum"``: the :class:`Partials` of the nonlinear factors
    given (one rank's shard)."""
    return gradient_lanes(mu, pd, po, temperature, nl_specs, (), nl_arrays,
                          (), mode="accum", eval_dtype=eval_dtype)


def gradient_solve_lanes(mu, pd, po, temperature, seeds, lin_specs,
                         lin_arrays):
    """K6 mode ``"solve"``: the outputs of mode ``"full"`` from the summed
    partial gradients ``seeds`` and the linear factors."""
    return gradient_lanes(mu, pd, po, temperature, (), lin_specs, (),
                          lin_arrays, mode="solve", seeds=seeds)


_COUNTED = {"full": gradient_lanes, "accum": gradient_accum_lanes,
            "solve": gradient_solve_lanes}
# each mode's span is named after the wrapper that counts its launches
_SPANS = {"full": "gvi.kernel.fused_gradient",
          "accum": "gvi.kernel.fused_gradient_accum",
          "solve": "gvi.kernel.fused_gradient_solve"}
for _fn in _COUNTED.values():
    _fn.launches = 0
