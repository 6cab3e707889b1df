"""Fused NGD gradient step (K6, mode "full"): covariance + moments + joint
natural-gradient assembly + both block-Thomas solves in one kernel.

Counterpart of ``gaussianvi_tpu/kernels/fused_gradient.py``.  The inputs
are the current iterate ``mu``, ``(prec_diag, prec_off)``, the per-problem
temperature and the factor operands the fused trial kernel takes
(``kernels/fused_trials.py``); the kernel (``csrc/fused_gradient.cu``, one
thread per problem) returns the iterate's covariance blocks and log det,
``dprec = Vddmu - Lambda``, and the solutions of ``Vddmu dmu = -Vdmu``
(NaN where Vddmu is indefinite) and of the SPD fallback
``Lambda dmu_fb = -Vdmu``.  The linear factors enter through the residual
form: ``Vdmu = 2 Lam^T prec_c (Lam mu - pm) / T``, ``Vddmu = 2 A / T``,
which equals the separate path for symmetric target precisions (every
library prior builds them so).

Modes "accum" and "solve" (the fp-sharded split pair) are not ported.
``gradient_lanes.launches`` counts kernel launches (never plain-version
calls).
"""

from __future__ import annotations

import torch

from ..factors.moments import gh_moments, ngd_local_gradients
from ..inference.graph import scatter_gradients, take_states
from ..ops.blocktridiag import BlockTridiag, gbp_edge_covariance, solve
from . import _build
from .chain import lanes, unlanes
from .fused_trials import (
    check_state,
    edge_blocks,
    edge_means,
    factor_args,
    residual_weights,
)
from .quad import KERNEL_COSTS


def _full_a(a, nb: int):
    """The residual form's A ``[..., Ka, 2s, 2s]`` (nb == 2, from its A11,
    A22, A12 blocks) or ``[..., Ka, s, s]`` (nb == 1)."""
    if nb == 1:
        return a[..., 0, :, :]
    top = torch.cat([a[..., 0, :, :], a[..., 2, :, :]], dim=-1)
    bot = torch.cat([a[..., 2, :, :].transpose(-1, -2), a[..., 1, :, :]],
                    dim=-1)
    return torch.cat([top, bot], dim=-2)


def gradient_plain(mu, pd, po, temperature, nl_specs, lin_specs, nl_arrays,
                   lin_arrays):
    """Plain version of K6: ``(cov_diag, cov_off, logdet, dprec_diag,
    dprec_off, dmu, dmu_fallback)``.

    The plain GBP, the sigma-point moments with the marginal-rule lift and
    the NGD local gradients, the residual-form linear gradients, scattered
    per state and edge, then both solves."""
    b, n, s = mu.shape
    prec = BlockTridiag(pd, po)
    joint_cov, ld = gbp_edge_covariance(prec)
    _, _, cov_off, cov_diag = edge_blocks(joint_cov, s)
    vdmu = torch.zeros_like(mu)
    vdd = BlockTridiag.zeros((b,), n, s, mu.dtype, mu.device)
    t = temperature[:, None, None]
    for spec, (start, nodes, weights, params) in zip(nl_specs, nl_arrays):
        off = spec.slice_offset
        cov_k = take_states(cov_diag, start, off, 2)
        moments = gh_moments(nodes, weights, take_states(mu, start, off, 1),
                             cov_k, KERNEL_COSTS[spec.cost][1], params,
                             rdim=spec.rdim)
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
    dprec = vdd - prec
    return (cov_diag, cov_off, ld, dprec.diag, dprec.off,
            solve(vdd, -vdmu), solve(prec, -vdmu))


def gradient_lanes(mu, pd, po, temperature, nl_specs, lin_specs, nl_arrays,
                   lin_arrays, mode: str = "full"):
    """K6: ``mu [B, N, s]``, ``pd [B, N, s, s]``, ``po [B, N-1, s, s]``,
    ``temperature [B]`` and the factor operands of
    ``kernels/fused_trials.py`` -> ``(cov_diag [B, N, s, s], cov_off
    [B, N-1, s, s], logdet [B], dprec_diag, dprec_off, dmu [B, N, s],
    dmu_fallback [B, N, s])``.  CUDA tensors launch the kernel; CPU tensors
    run :func:`gradient_plain`."""
    if mode != "full":
        raise NotImplementedError(
            f"fused gradient mode {mode!r} (the fp-sharded split pair) is "
            "not ported yet (ROADMAP.md, Queue B 7)")
    if mu.device.type == "cpu":
        return gradient_plain(mu, pd, po, temperature, nl_specs, lin_specs,
                              nl_arrays, lin_arrays)
    name = "gradient_lanes"
    b, n, s = check_state(name, mu, pd, po, temperature)
    if temperature.shape != (b,):
        raise ValueError(f"{name}: temperature must be [{b}]")
    fa = factor_args(name, mu, nl_specs, lin_specs, nl_arrays, lin_arrays)
    mu_l, pd_l, po_l = lanes(mu, b), lanes(pd, b), lanes(po, b)
    temp = temperature.contiguous()

    def like(x):
        return torch.empty_like(x)

    covd, covo, dpd, dpo = like(pd_l), like(po_l), like(pd_l), like(po_l)
    dmu, dfb = like(mu_l), like(mu_l)
    fpiv, vdd, vdo, vdmu = like(pd_l), like(pd_l), like(po_l), like(mu_l)
    ld = torch.empty((b,), dtype=mu.dtype, device=mu.device)
    err = _build.load().gvi_fused_grad(
        _build.DTYPES[mu.dtype], s, fa.cost, fa.n_params,
        *(x.data_ptr() for x in (mu_l, pd_l, po_l, temp, covd, covo, ld, dpd,
                                 dpo, dmu, dfb, fpiv, vdd, vdo, vdmu)),
        b, n, fa.n_nl, fa.nl_ptrs, fa.nl_ints, fa.n_lin, fa.lin_ptrs,
        fa.lin_ints, torch.cuda.current_stream(mu.device).cuda_stream,
    )
    _build.check(err, "gvi_fused_grad")
    gradient_lanes.launches += 1
    return (unlanes(covd, pd.shape), unlanes(covo, po.shape), ld,
            unlanes(dpd, pd.shape), unlanes(dpo, po.shape),
            unlanes(dmu, mu.shape), unlanes(dfb, mu.shape))


gradient_lanes.launches = 0
