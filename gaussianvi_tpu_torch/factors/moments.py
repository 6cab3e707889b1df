"""Sigma-point moments and per-factor gradient math.

Counterpart of ``gaussianvi_tpu/factors/moments.py``.  For a batch of K
factors with marginals ``(mu [..., K, d], cov [..., K, d, d])`` and an
M-point rule, ``phi`` is evaluated once per sigma point and the three
weighted reductions E[phi], E[(x-mu) phi], E[(x-mu)(x-mu)^T phi] follow.

:func:`batch_phi` / :func:`batch_moments` dispatch: the quadrature kernel
(``kernels/quad.py``) when ``quad_impl`` selects it, else the plain
functions here.
"""

from __future__ import annotations

import torch

from ..ops.blocktridiag import spd_inv
from ..ops.smallmat import chol_small

# Rounding-band width (ulps of sum |w phi|) for the nonneg-phi guard; see
# gaussianvi_tpu/factors/moments._NONNEG_BAND (csrc/quad.cu uses the same).
NONNEG_BAND = 4096.0
# cancellation-trust guard: |sum w phi| below this many ulps of
# sum |w phi| is poisoned (gaussianvi_tpu/kernels/quad_lanes._cancel_tol)
CANCEL_ULPS = 64.0


def _eps(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).eps


def _sigma_diffs(nodes, cov):
    """Zero-mean sigma offsets ``nodes @ L^T`` with the sigma-point axis
    FIRST: [M, ..., K, d] (and the lower factor L)."""
    sqrt_p = chol_small(cov)
    return torch.einsum("md,...ed->m...e", nodes, sqrt_p), sqrt_p


def _weighted_phi(nodes, weights, mu, cov, cost_fn, params):
    diff, sqrt_p = _sigma_diffs(nodes, cov)
    phi = cost_fn(diff + mu, params)                  # [M, ..., K]
    return phi * weights.reshape(-1, *([1] * (phi.ndim - 1))), diff, sqrt_p


def gh_moments(nodes, weights, mu, cov, cost_fn, params, rdim=None):
    """(E[phi] [..., K], E[(x-mu)phi] [..., K, d],
    E[(x-mu)(x-mu)^T phi] [..., K, d, d]).

    ``cost_fn(pts [M, ..., K, d], params) -> [M, ..., K]``: param leaves
    ``[..., K, *leaf]`` broadcast against the points from the right.
    ``rdim``: MARGINAL quadrature — phi depends only on the first r dims and
    ``nodes`` carry an r-dim rule zero-padded to d; the exact Gaussian
    conditional-moment lift adds ``L[:, r:] L[:, r:]^T E[phi]`` to the
    second moment (derivation in gaussianvi_tpu/factors/moments.gh_moments).
    """
    wphi, diff, sqrt_p = _weighted_phi(nodes, weights, mu, cov, cost_fn,
                                       params)
    e_phi = torch.sum(wphi, dim=0)
    e_xmu = torch.einsum("m...,m...d->...d", wphi, diff)
    e_xxt = torch.einsum("m...,m...d,m...e->...de", wphi, diff, diff)
    if rdim is not None and rdim < mu.shape[-1]:
        lhi = sqrt_p[..., rdim:]
        corr = lhi @ lhi.transpose(-1, -2)
        e_xxt = e_xxt + corr * e_phi[..., None, None]
    return e_phi, e_xmu, e_xxt


def guard_phi(tot, absum, nonneg: bool):
    """NaN-poison a quadrature sum whose sign cannot be trusted: more than
    ~5 of 7 float32 digits cancelled (|sum| < 64 ulps of sum |w phi|), or,
    for a nonnegative integrand, a negative value inside the rounding band
    (the JAX package's cancellation and nonneg guards)."""
    eps = _eps(tot)
    bad = torch.abs(tot) < CANCEL_ULPS * eps * absum
    if nonneg:
        bad = bad | ((tot < 0.0) & (tot > -NONNEG_BAND * eps * absum))
    return torch.where(bad, torch.full_like(tot, float("nan")), tot)


def expectation_phi(nodes, weights, mu, cov, cost_fn, params,
                    nonneg: bool = False):
    """E[phi] only (the line-search cost path), cancellation-guarded."""
    wphi, _, _ = _weighted_phi(nodes, weights, mu, cov, cost_fn, params)
    return guard_phi(torch.sum(wphi, dim=0),
                     torch.sum(torch.abs(wphi), dim=0), nonneg)


def _kernel_cost(fb):
    if fb.kernel_cost is None or fb.kernel_params is None:
        raise ValueError(
            "the quadrature kernel needs a factor batch with kernel_cost and "
            "kernel_params set (a CUDA cost functor in csrc/costs.cuh)"
        )
    return fb.kernel_cost, fb.kernel_params


def batch_phi(fb, mu_k, cov_k, use_kernel: bool):
    """E[phi] [..., K] for a NonlinearFactorBatch: the quadrature kernel
    (``kernels.quad.quad_lanes_phi``) or :func:`expectation_phi`."""
    if use_kernel:
        from ..kernels.quad import quad_lanes_phi

        return quad_lanes_phi(mu_k, cov_k, fb.nodes, fb.weights,
                              *_kernel_cost(fb), nonneg=fb.nonneg_cost)
    return expectation_phi(fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn,
                           fb.params, nonneg=fb.nonneg_cost)


def batch_moments(fb, mu_k, cov_k, use_kernel: bool):
    """The three moments for a NonlinearFactorBatch: the quadrature kernel
    (``kernels.quad.quad_lanes_moments``) or :func:`gh_moments`."""
    if use_kernel:
        from ..kernels.quad import quad_lanes_moments

        return quad_lanes_moments(mu_k, cov_k, fb.nodes, fb.weights,
                                  *_kernel_cost(fb), rdim=fb.quad_rdim)
    return gh_moments(fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn,
                      fb.params, rdim=fb.quad_rdim)


def ngd_local_gradients(e_phi, e_xmu, e_xxt, cov, temperature):
    """Per-factor natural-gradient pieces:

        Vdmu_k  = Prec_k E[(x-mu)phi] / T
        Vddmu_k = (Prec_k E[(x-mu)(x-mu)^T phi] Prec_k - Prec_k E[phi]) / T

    ``temperature`` is a scalar or one value per problem (``[B]`` against
    ``[B, K, ...]`` factor axes)."""
    t = _per_problem(temperature, e_phi)
    prec = spd_inv(cov)
    vdmu = torch.einsum("...de,...e->...d", prec, e_xmu) / t[..., None]
    vddmu = (
        torch.einsum("...ab,...bc,...cd->...ad", prec, e_xxt, prec)
        - prec * e_phi[..., None, None]
    ) / t[..., None, None]
    vddmu = 0.5 * (vddmu + vddmu.transpose(-1, -2))
    return vdmu, vddmu


def _per_problem(temperature, per_factor):
    """Temperature broadcastable against ``[..., K]`` per-factor values."""
    t = torch.as_tensor(temperature, dtype=per_factor.dtype,
                        device=per_factor.device)
    return t[..., None] if t.ndim else t


def linear_local_gradients(lam, psi, target_mu, target_prec, constant, mu,
                           temperature):
    """Closed-form NGD gradients for linear-Gaussian factors:
    Vdmu = 2 Lam^T P (Lam mu - Psi mu_t) C / T, Vddmu = 2 Lam^T P Lam C / T."""
    t = _per_problem(temperature, constant)
    resid = (torch.einsum("...rd,...d->...r", lam, mu)
             - torch.einsum("...rt,...t->...r", psi, target_mu))
    vdmu = (
        2.0
        * torch.einsum("...rd,...rs,...s->...d", lam, target_prec, resid)
        * constant[..., None]
        / t[..., None]
    )
    a = torch.einsum("...ra,...rs,...sb->...ab", lam, target_prec, lam)
    vddmu = 2.0 * a * constant[..., None, None] / t[..., None, None]
    return vdmu, vddmu


def guard_linear_cost(cost):
    """A negative closed-form linear cost is always rounding garbage
    (tr(A Sigma) + ||r||^2_P >= 0): poison it to NaN."""
    return torch.where(cost < 0, torch.full_like(cost, float("nan")), cost)


def batch_linear_cost(lb, mu, cov_diag, cov_off):
    """E[psi] [..., K] for a LinearFactorBatch from the chain blocks
    (nb == 2 edges blockwise, without assembling the edge marginal)."""
    from ..inference.graph import gather_chain_edges, gather_marginals

    if lb.nb == 2:
        return linear_cost_chain(
            lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
            *gather_chain_edges(lb.start, mu, cov_diag, cov_off,
                                lb.slice_offset),
        )
    mu_k, cov_k = gather_marginals(lb.start, lb.nb, mu, cov_diag, cov_off,
                                   lb.slice_offset)
    return linear_cost(lb.lam, lb.psi, lb.target_mu, lb.target_prec,
                       lb.constant, mu_k, cov_k)


def _residual_quad(lam, psi, target_mu, target_prec, mu_k):
    resid = (torch.einsum("...rd,...d->...r", lam, mu_k)
             - torch.einsum("...rt,...t->...r", psi, target_mu))
    return torch.einsum("...r,...rs,...s->...", resid, target_prec, resid)


def linear_cost_chain(lam, psi, target_mu, target_prec, constant,
                      mu_i, mu_ip1, cd_i, cd_ip1, co_i):
    """Closed-form E[psi] for nb == 2 linear factors from the chain blocks:
    tr(A Sigma_e) = sum(A11 . Sig_ii) + sum(A22 . Sig_i+1) + 2 sum(A12 . Sig_i,i+1)
    with A = sym(Lam^T prec_t Lam)."""
    s = cd_i.shape[-1]
    a = torch.einsum("...ra,...rs,...sb->...ab", lam, target_prec, lam)
    a = 0.5 * (a + a.transpose(-1, -2))
    tr_term = (
        torch.sum(a[..., :s, :s] * cd_i, dim=(-2, -1))
        + torch.sum(a[..., s:, s:] * cd_ip1, dim=(-2, -1))
        + 2.0 * torch.sum(a[..., :s, s:] * co_i, dim=(-2, -1))
    )
    mu_k = torch.cat([mu_i, mu_ip1], dim=-1)
    quad = _residual_quad(lam, psi, target_mu, target_prec, mu_k)
    return guard_linear_cost((tr_term + quad) * constant)


def linear_cost(lam, psi, target_mu, target_prec, constant, mu, cov):
    """Closed-form E[psi] = (tr(Lam^T P Lam Cov) + ||Lam mu - Psi mu_t||^2_P) C."""
    a = torch.einsum("...ra,...rs,...sb->...ab", lam, target_prec, lam)
    tr_term = torch.diagonal(a @ cov, dim1=-2, dim2=-1).sum(-1)
    quad = _residual_quad(lam, psi, target_mu, target_prec, mu)
    return guard_linear_cost((tr_term + quad) * constant)
