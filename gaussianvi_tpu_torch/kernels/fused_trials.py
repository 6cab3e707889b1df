"""Fused line-search trial evaluation (K5): every trial of one NGD
iteration, chain + quadrature + linear costs, in one kernel.

Counterpart of ``gaussianvi_tpu/kernels/fused_trials.py``.  The inputs are
the current iterate and the step direction at width B; the T trial
iterates ``mu + s_t dmu``, ``sym(Lambda + s_t dLambda)`` exist only inside
the kernel (``csrc/fused_trials.cu``, one thread per (trial, problem)
pair).  The backward GBP sweep hands each edge's covariance blocks straight
to the factors of that state and edge, so nothing covariance-sized is
written: the outputs are the log det ``[T, B]`` and one ``[T, B, K]`` cost
array per factor batch, nonlinear batches first, then linear.

Factor operands (built once per graph by ``inference.engine.LocalEngine``,
shared with the fused gradient kernel):

* nonlinear batch ``(start [K], nodes [M, s], weights [M], params
  [B, K, P])``, described by :class:`NLTrialSpec`; its cost is a CUDA
  functor named by ``kernel_cost`` (``kernels/quad.py`` KERNEL_COSTS);
* linear batch ``(start [K], a [B, Ka, blocks, s, s], lam [B, Ka, r,
  nb * s], pm [B, Ka, r], prec_c [B, Ka, r, r])`` in the residual form of
  :func:`linear_residual_form` (``blocks``: A for an anchor, A11, A22, A12
  for an edge), described by :class:`LinTrialSpec`.

``start`` is read only when the spec's ``slice_offset`` is None.  Every
cost carries the guards of the separate path (``factors/moments.py``); the
JAX kernel guards only the log det.  ``trial_costs_lanes.launches`` counts
kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..factors.moments import expectation_phi, guard_linear_cost
from ..inference.graph import take_states
from ..ops.blocktridiag import BlockTridiag, gbp_edge_covariance
from . import _build
from .chain import lanes
from .quad import KERNEL_COSTS

BLOCK_SIZES = (2, 4)     # instantiated state-block sizes s (local dim d = s)
MAX_BATCHES = 4          # per kind (csrc/fused.cuh kMaxBatches)
_MAX_SMEM = 48 * 1024


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
                      lin_specs, nl_arrays, lin_arrays):
    """Plain version of K5: ``(ld [T, B], fc tuple of [T, B, K])``.

    Trial iterates for all T at once, the plain GBP sweeps, guarded E[phi]
    on the gathered marginals and the residual-form linear costs, each
    read from its edge's joint covariance as the kernel reads it."""
    st = trials.reshape(-1, 1, 1, 1)
    t_mu = mu + st * dmu                                   # [T, B, N, s]
    st = st[..., None]
    t_prec = BlockTridiag(pd + st * dpd, po + st * dpo).symmetrize()
    joint_cov, ld = gbp_edge_covariance(t_prec)
    cii, cjj, cij, cov = edge_blocks(joint_cov, mu.shape[-1])
    out = []
    for spec, (start, nodes, weights, params) in zip(nl_specs, nl_arrays):
        off = spec.slice_offset
        out.append(expectation_phi(
            nodes, weights, take_states(t_mu, start, off, 1),
            take_states(cov, start, off, 2), KERNEL_COSTS[spec.cost][1],
            params, nonneg=spec.nonneg))
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
    return ld, tuple(out)


# ---------------------------------------------------------------------------
# kernel launch (shared with kernels/fused_gradient.py)
# ---------------------------------------------------------------------------

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
    fc: tuple            # per batch [K, count] cost outputs (trial kernel)


def factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays,
                count: int | None = None) -> FactorArgs:
    """Check and pack the factor operands for a launch at ``mu [B, N, s]``.
    ``count`` (trial kernel): allocate ``[K, count]`` cost outputs."""
    b, _, s = mu.shape
    dt, dev = mu.dtype, mu.device
    if len(nl_specs) > MAX_BATCHES or len(lin_specs) > MAX_BATCHES:
        raise ValueError(f"{name}: at most {MAX_BATCHES} nonlinear and "
                         f"{MAX_BATCHES} linear batches")
    costs = {sp.cost for sp in nl_specs} or {"range"}
    if len(costs) != 1 or not costs <= set(KERNEL_COSTS):
        raise ValueError(f"{name}: the nonlinear batches must share one "
                         f"kernel cost of {sorted(KERNEL_COSTS)}, got "
                         f"{sorted(costs)}")
    cost = costs.pop()
    cost_id, _, dims = KERNEL_COSTS[cost]
    if s not in dims:
        raise ValueError(f"{name}: cost {cost!r} not instantiated for d={s}")
    n_params = dims[s]

    def same(t, shape, what):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: {what} on another device/dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} shape {tuple(t.shape)}, "
                             f"expected {shape}")

    def starts_of(sp, start):
        if sp.slice_offset is not None:
            return None
        if start.shape != (sp.k,) or start.device != dev:
            raise ValueError(f"{name}: start must be [{sp.k}] on {dev}")
        return start.to(torch.int32).contiguous()

    keep, fc, nl_ptrs, nl_ints, smem = [], [], [], [], 0
    for sp, (start, nodes, weights, params) in zip(nl_specs, nl_arrays):
        same(nodes, (sp.m, s), "nodes")
        same(weights, (sp.m,), "weights")
        same(params, (b, sp.k, n_params), "kernel_params")
        smem += sp.m * (s + 1) * mu.element_size()
        ops = [nodes.contiguous(), weights.contiguous(), lanes(params, b),
               starts_of(sp, start)]
        if count is not None:
            ops.append(torch.empty((sp.k, count), dtype=dt, device=dev))
            fc.append(ops[-1])
        keep += [t for t in ops if t is not None]
        nl_ptrs += [t.data_ptr() if t is not None else None for t in ops]
        nl_ptrs += [None] * (5 - len(ops))
        nl_ints += [sp.k, sp.m,
                    -1 if sp.slice_offset is None else sp.slice_offset,
                    int(sp.nonneg), s if sp.rdim is None else sp.rdim]
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: rules of {smem} bytes exceed shared memory")
    lin_ptrs, lin_ints = [], []
    for sp, (start, a, lam, pm, prec_c) in zip(lin_specs, lin_arrays):
        if sp.nb not in (1, 2) or not 1 <= sp.r <= 2 * s or sp.ka not in (
                1, sp.k):
            raise ValueError(f"{name}: linear batch {sp} not supported "
                             "(nb 1 or 2, 1 <= r <= 2s, ka 1 or k)")
        same(a, (b, sp.ka, 3 if sp.nb == 2 else 1, s, s), "A")
        same(lam, (b, sp.ka, sp.r, sp.nb * s), "lam")
        same(pm, (b, sp.ka, sp.r), "pm")
        same(prec_c, (b, sp.ka, sp.r, sp.r), "prec_c")
        ops = [lanes(a, b), lanes(lam, b), lanes(pm, b), lanes(prec_c, b),
               starts_of(sp, start)]
        if count is not None:
            ops.append(torch.empty((sp.k, count), dtype=dt, device=dev))
            fc.append(ops[-1])
        keep += [t for t in ops if t is not None]
        lin_ptrs += [t.data_ptr() if t is not None else None for t in ops]
        lin_ptrs += [None] * (6 - len(ops))
        lin_ints += [sp.nb, sp.k, sp.ka, sp.r,
                     -1 if sp.slice_offset is None else sp.slice_offset]

    def arr(ctype, values):
        return (ctype * max(len(values), 1))(*values)

    return FactorArgs(cost_id, n_params, len(nl_specs),
                      arr(ctypes.c_void_p, nl_ptrs), arr(ctypes.c_int, nl_ints),
                      len(lin_specs), arr(ctypes.c_void_p, lin_ptrs),
                      arr(ctypes.c_int, lin_ints), keep, tuple(fc))


def trial_costs_lanes(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                      lin_specs, nl_arrays, lin_arrays):
    """K5: ``mu, dmu [B, N, s]``, ``pd, dpd [B, N, s, s]``, ``po, dpo
    [B, N-1, s, s]``, ``trials [T]`` and the factor operands (module
    docstring) -> ``(ld [T, B], fc tuple of [T, B, K])``, nonlinear batches
    first.  CUDA tensors launch the kernel; CPU tensors run
    :func:`trial_costs_plain`."""
    if mu.device.type == "cpu":
        return trial_costs_plain(mu, dmu, pd, po, dpd, dpo, trials, nl_specs,
                                 lin_specs, nl_arrays, lin_arrays)
    name = "trial_costs_lanes"
    b, n, s = check_state(name, mu, pd, po, dmu, dpd, dpo, trials)
    if dmu.shape != mu.shape or dpd.shape != pd.shape or dpo.shape != po.shape:
        raise ValueError(f"{name}: direction shapes differ from the iterate's")
    if trials.ndim != 1 or trials.shape[0] < 1:
        raise ValueError(f"{name}: trials must be [T], T >= 1")
    nt = trials.shape[0]
    count = nt * b
    fa = factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays,
                     count)
    ops = [lanes(x, b) for x in (mu, dmu, pd, po, dpd, dpo)]
    trials_c = trials.contiguous()
    ld = torch.empty((count,), dtype=mu.dtype, device=mu.device)
    fpiv = torch.empty((n * s * s, count), dtype=mu.dtype, device=mu.device)
    err = _build.load().gvi_fused_trials(
        _build.DTYPES[mu.dtype], s, fa.cost, fa.n_params,
        *(x.data_ptr() for x in ops), trials_c.data_ptr(), ld.data_ptr(),
        fpiv.data_ptr(), b, n, nt, fa.n_nl, fa.nl_ptrs, fa.nl_ints, fa.n_lin,
        fa.lin_ptrs, fa.lin_ints,
        torch.cuda.current_stream(mu.device).cuda_stream,
    )
    _build.check(err, "gvi_fused_trials")
    trial_costs_lanes.launches += 1
    return (ld.reshape(nt, b),
            tuple(f.reshape(-1, nt, b).permute(1, 2, 0) for f in fa.fc))


trial_costs_lanes.launches = 0
