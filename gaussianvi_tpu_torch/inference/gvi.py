"""Joint-level cost and gradient assembly for both optimizers.

Counterpart of ``gaussianvi_tpu/inference/gvi.py``: cost =
sum_k E[psi_k] (/T) + 0.5 log det Lambda; the joint natural-gradient
pieces (Vdmu, Vddmu) scatter-added from every factor batch; and the
proximal optimizer's Bures-Wasserstein JKO pseudo-gradients.  Tensors
carry the problem axis first; ``temperature`` is a scalar or ``[B]``.
``quad_batches``: per nonlinear batch, whether its quadrature takes the
kernel (``inference.engine.LocalEngine.quad_batches``; empty: none does).
"""

from __future__ import annotations

import torch

from ..factors import moments as mm
from ..ops.blocktridiag import (
    BlockTridiag,
    gbp_covariance_logdet,
    spd_inv,
)
from ..ops.psd import sqrtm_product
from .graph import FactorGraph, gather_marginals, scatter_gradients


def _with_kernels(graph: FactorGraph, quad_batches):
    """Each nonlinear batch with its quadrature route."""
    return zip(graph.nonlinear,
               quad_batches or (False,) * len(graph.nonlinear), strict=True)


def factor_costs(graph: FactorGraph, mu, cov_diag, cov_off, temperature,
                 temper_costs: bool = True, quad_batches=(), eval_dtype=None):
    """Concatenated per-factor expected costs E[psi_k] (optionally / T):
    ``[..., K_total]``, nonlinear batches first, then linear;
    ``eval_dtype``: the sigma offsets' rounding (``factors.moments``)."""
    t = temperature if temper_costs else 1.0
    if isinstance(t, torch.Tensor) and t.ndim:
        t = t[..., None]
    costs = []
    for fb, kernel in _with_kernels(graph, quad_batches):
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                       cov_off, fb.slice_offset)
        costs.append(mm.batch_phi(fb, mu_k, cov_k, kernel, eval_dtype) / t)
    for lb in graph.linear:
        costs.append(mm.batch_linear_cost(lb, mu, cov_diag, cov_off) / t)
    if not costs:
        return mu.new_zeros((*mu.shape[:-2], 0))
    return torch.cat(costs, dim=-1)


def joint_cost(graph: FactorGraph, mu, precision: BlockTridiag, temperature,
               temper_costs: bool = True):
    """Total V(q) = sum_k E[psi_k] (/T) + 0.5 log det Lambda, per problem
    (``[...]``), on the plain chain and quadrature."""
    cov_diag, cov_off, ld = gbp_covariance_logdet(precision)
    fc = factor_costs(graph, mu, cov_diag, cov_off, temperature, temper_costs)
    return fc.sum(-1) + 0.5 * ld


def ngd_gradients(graph: FactorGraph, mu, cov_diag, cov_off, temperature,
                  use_pallas: bool = False, quad_batches=(), onto=None,
                  eval_dtype=None):
    """Assemble joint (Vdmu [..., N, s], Vddmu block-tridiag).

    The NGD step downstream is d_precision = Vddmu - Lambda and
    d_mu = solve(Vddmu, -Vdmu).  ``onto``: accumulators ``(Vdmu, Vddmu)``
    to add into in place (a sharded engine's summed nonlinear part) in
    place of zeros.  ``eval_dtype``: the sigma offsets' rounding (not on
    the block-form route, as in the JAX package)."""
    n, s = mu.shape[-2:]
    if onto is not None:
        vdmu_joint, vddmu_joint = onto
    else:
        vdmu_joint = torch.zeros_like(mu)
        vddmu_joint = BlockTridiag.zeros(mu.shape[:-2], n, s, mu.dtype,
                                         mu.device)
    for fb, kernel in _with_kernels(graph, quad_batches):
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                       cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k, use_pallas,
                                               kernel, eval_dtype)
        vdmu, vddmu = mm.ngd_local_gradients(e_phi, e_xmu, e_xxt, cov_k,
                                             temperature)
        scatter_gradients(fb.start, fb.nb, vdmu, vddmu, vdmu_joint,
                          vddmu_joint, fb.slice_offset)
    for lb in graph.linear:
        mu_k, _ = gather_marginals(lb.start, lb.nb, mu, cov_diag, cov_off,
                                   lb.slice_offset)
        vdmu, vddmu = mm.linear_local_gradients(
            lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
            mu_k, temperature,
        )
        scatter_gradients(lb.start, lb.nb, vdmu, vddmu, vdmu_joint,
                          vddmu_joint, lb.slice_offset)
    return vdmu_joint, vddmu_joint


def _bw_jko_step(b_k, s_k, cov_k, step_size):
    """The Bures-Wasserstein JKO proximal step as pseudo-gradients:

        M = I - s S_k;  Sig_half = M Sig M^T
        Sig_new = 0.5 Sig_half + s I + 0.5 sqrtm(Sig_half (Sig_half + 4 s I))
        mu_new  = mu - s b_k
        Vdmu = (mu_new - mu)/s = -b_k;  Vddmu = (Sig_new^{-1} - Prec_k)/s"""
    d = cov_k.shape[-1]
    eye = torch.eye(d, dtype=cov_k.dtype, device=cov_k.device)
    m = eye - step_size * s_k
    sig_half = torch.einsum("...ab,...bc,...dc->...ad", m, cov_k, m)
    sig_new = (0.5 * sig_half + step_size * eye
               + 0.5 * sqrtm_product(sig_half, step_size))
    return -b_k, (spd_inv(sig_new) - spd_inv(cov_k)) / step_size


def prox_gradients(graph: FactorGraph, mu, cov_diag, cov_off, step_size,
                   quad_batches=()):
    """Per-factor Bures-Wasserstein JKO pseudo-gradients, summed into the
    joint ``(dmu [..., N, s], dprec block-tridiag)``.  The nonlinear
    moments never take the block-form kernel (as in the JAX package)."""
    n, s = mu.shape[-2:]
    dmu_joint = torch.zeros_like(mu)
    dprec_joint = BlockTridiag.zeros(mu.shape[:-2], n, s, mu.dtype,
                                     mu.device)
    for fb, kernel in _with_kernels(graph, quad_batches):
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                       cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k,
                                               use_kernel=kernel)
        b_k, s_k = mm.bw_local_gradients(e_phi, e_xmu, e_xxt, cov_k)
        vdmu, vddmu = _bw_jko_step(b_k, s_k, cov_k, step_size)
        scatter_gradients(fb.start, fb.nb, vdmu, vddmu, dmu_joint,
                          dprec_joint, fb.slice_offset)
    for lb in graph.linear:
        # closed-form BW gradients, without the constant factor (unlike the
        # NGD linear path): b_k = Lam^T prec_t (Lam mu - Psi mu_t),
        # S_k = Lam^T prec_t Lam
        mu_k, cov_k = gather_marginals(lb.start, lb.nb, mu, cov_diag,
                                       cov_off, lb.slice_offset)
        resid = (torch.einsum("...rd,...d->...r", lb.lam, mu_k)
                 - torch.einsum("...rt,...t->...r", lb.psi, lb.target_mu))
        b_k = torch.einsum("...rd,...rs,...s->...d", lb.lam, lb.target_prec,
                           resid)
        s_k = torch.einsum("...ra,...rs,...sb->...ab", lb.lam, lb.target_prec,
                           lb.lam)
        vdmu, vddmu = _bw_jko_step(b_k, s_k, cov_k, step_size)
        scatter_gradients(lb.start, lb.nb, vdmu, vddmu, dmu_joint,
                          dprec_joint, lb.slice_offset)
    return dmu_joint, dprec_joint
