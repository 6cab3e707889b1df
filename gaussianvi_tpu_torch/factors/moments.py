"""Sigma-point moments and per-factor gradient math.

Counterpart of ``gaussianvi_tpu/factors/moments.py``.  For a batch of K
factors with marginals ``(mu [..., K, d], cov [..., K, d, d])`` and an
M-point rule, ``phi`` is evaluated once per sigma point and the three
weighted reductions E[phi], E[(x-mu) phi], E[(x-mu)(x-mu)^T phi] follow.

:func:`batch_phi` / :func:`batch_moments` dispatch in the JAX package's
order: the block-form moments kernel (``kernels/fused_moments.py``) for
``use_pallas`` on a batch with a block form, the quadrature kernel
(``kernels/quad.py``) when ``quad_impl`` selects it, else the plain
functions here.
"""

from __future__ import annotations

import torch

from ..ops.blocktridiag import spd_inv
from ..ops.psd import psd_sqrtm
from ..ops.smallmat import chol_small

# Rounding-band width (ulps of sum |w phi|) for the nonneg-phi guard; see
# gaussianvi_tpu/factors/moments._NONNEG_BAND (csrc/quad.cu uses the same).
NONNEG_BAND = 4096.0
# cancellation-trust guard: |sum w phi| below this many ulps of
# sum |w phi| is poisoned (gaussianvi_tpu/kernels/quad_lanes._cancel_tol)
CANCEL_ULPS = 64.0
# the names ``GVIConfig.moments_eval_dtype`` takes
EVAL_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _eps(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).eps


def as_eval_dtype(value) -> torch.dtype | None:
    """A ``moments_eval_dtype`` (None, ``"bfloat16"``, ``"float16"`` or the
    torch dtype) as a torch dtype or None."""
    if value is None or value in EVAL_DTYPES.values():
        return value
    if value in EVAL_DTYPES:
        return EVAL_DTYPES[value]
    raise ValueError(f"unknown moments_eval_dtype {value!r} (one of "
                     f"{sorted(EVAL_DTYPES)})")


def kernel_quantizes(eval_dtype) -> bool:
    """Whether the quadrature kernels (K3, K5, K6) take ``eval_dtype``:
    None and bfloat16 (rounded in the kernel); float16 keeps the plain
    quadrature, as in the JAX package (``moments._lanes_eligible``)."""
    return as_eval_dtype(eval_dtype) in (None, torch.bfloat16)


def quantize(diff: torch.Tensor, eval_dtype) -> torch.Tensor:
    """Round sigma offsets through ``eval_dtype`` and back (none for None).
    From float64 PyTorch rounds to bfloat16 through float32, as the JAX
    package does and as the kernels' float64 instances do."""
    eval_dtype = as_eval_dtype(eval_dtype)
    if eval_dtype is None:
        return diff
    return diff.to(eval_dtype).to(diff.dtype)


def sigma_points(nodes, mu, cov, method: str = "cholesky"):
    """Zero-mean nodes placed at N(mu_k, cov_k): ``mu + F node`` for a
    factor F F^T = cov, the lower Cholesky factor (``"cholesky"``) or the
    symmetric root (``"eigh"``).  ``nodes [M, d]``, ``mu [..., K, d]``,
    ``cov [..., K, d, d]`` -> ``[M, ..., K, d]`` (sigma axis first; JAX
    gives ``[K, M, d]``)."""
    if method == "cholesky":
        sqrt_p = chol_small(cov)
    elif method == "eigh":
        sqrt_p = psd_sqrtm(cov)
    else:
        raise ValueError(f"unknown method {method!r}")
    return torch.einsum("md,...ed->m...e", nodes, sqrt_p) + mu


def eval_phi(cost_fn, pts, params):
    """phi over the sigma batch: ``pts [M, ..., K, d]`` -> ``[M, ..., K]``
    (the port's cost functions take the whole batch at once)."""
    return cost_fn(pts, params)


def kernel_offsets(nodes, sqrt_p, eval_dtype=None):
    """Sigma offsets ``L node`` summed as the kernels sum them
    (``csrc/sigma.cuh``): ``nd[0] l[i][0]``, then ``+ nd[j] l[i][j]`` for
    j = 1..i, each product and sum rounded, then the round trip through
    ``eval_dtype``.  A one-ulp difference before the round trip becomes a
    bfloat16 ulp after it, so the plain versions of the kernels form a
    quantized offset this way, not by an einsum.  ``[M, ..., K, d]``."""
    m, d = nodes.shape
    nd = nodes.reshape(m, *([1] * (sqrt_p.ndim - 2)), d)
    rows = []
    for i in range(d):
        t = nd[..., 0] * sqrt_p[..., i, 0]
        for j in range(1, i + 1):
            t = t + nd[..., j] * sqrt_p[..., i, j]
        rows.append(t)
    return quantize(torch.stack(rows, dim=-1), eval_dtype)


def _sigma_diffs(nodes, cov, eval_dtype=None, kernel_order=False):
    """Zero-mean sigma offsets ``nodes @ L^T`` with the sigma-point axis
    FIRST: [M, ..., K, d] (and the lower factor L), rounded through
    ``eval_dtype`` and back where it is set: centered quantization, which
    keeps the rounding error relative to the offset, not to the point
    (gaussianvi_tpu/factors/moments._sigma_diffs).  ``kernel_order``: sum
    in the kernels' order (:func:`kernel_offsets`)."""
    sqrt_p = chol_small(cov)
    if kernel_order:
        return kernel_offsets(nodes, sqrt_p, eval_dtype), sqrt_p
    diff = torch.einsum("md,...ed->m...e", nodes, sqrt_p)
    return quantize(diff, eval_dtype), sqrt_p


def _weighted_phi(nodes, weights, mu, cov, cost_fn, params, eval_dtype=None,
                  kernel_order=False):
    diff, sqrt_p = _sigma_diffs(nodes, cov, eval_dtype, kernel_order)
    phi = cost_fn(diff + mu, params)                  # [M, ..., K]
    return phi * weights.reshape(-1, *([1] * (phi.ndim - 1))), diff, sqrt_p


def gh_moments(nodes, weights, mu, cov, cost_fn, params, eval_dtype=None,
               rdim=None, kernel_order=False):
    """(E[phi] [..., K], E[(x-mu)phi] [..., K, d],
    E[(x-mu)(x-mu)^T phi] [..., K, d, d]).

    ``eval_dtype``: centered offset quantization (:func:`_sigma_diffs`);
    phi and every reduction stay in the working dtype, and the moments
    accumulate the rounded offsets.

    ``cost_fn(pts [M, ..., K, d], params) -> [M, ..., K]``: param leaves
    ``[..., K, *leaf]`` broadcast against the points from the right.
    ``rdim``: MARGINAL quadrature — phi depends only on the first r dims and
    ``nodes`` carry an r-dim rule zero-padded to d; the exact Gaussian
    conditional-moment lift adds ``L[:, r:] L[:, r:]^T E[phi]`` to the
    second moment (derivation in gaussianvi_tpu/factors/moments.gh_moments).
    """
    wphi, diff, sqrt_p = _weighted_phi(nodes, weights, mu, cov, cost_fn,
                                       params, eval_dtype, kernel_order)
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
                    eval_dtype=None, nonneg: bool = False,
                    kernel_order=False):
    """E[phi] only (the line-search cost path), cancellation-guarded;
    ``eval_dtype`` as in :func:`gh_moments`."""
    wphi, _, _ = _weighted_phi(nodes, weights, mu, cov, cost_fn, params,
                               eval_dtype, kernel_order)
    return guard_phi(torch.sum(wphi, dim=0),
                     torch.sum(torch.abs(wphi), dim=0), nonneg)


def kernel_covers(fb) -> str | None:
    """Why the quadrature kernel (``kernels.quad``) does not cover the
    NonlinearFactorBatch ``fb``, or None where it does: a batch spanning
    one state with a CUDA cost functor instantiated for its dim and rule,
    and the field the functor reads where it reads one."""
    from ..kernels.quad import covers

    if fb.nb != 1:
        return (f"nonlinear factors spanning nb={fb.nb} states take the "
                "plain quadrature")
    if fb.kernel_params is None:
        return covers(None, fb.dim, 0, fb.nodes.shape[0], fb.nodes.dtype)
    return covers(fb.kernel_cost, fb.dim, fb.kernel_params.shape[-1],
                  fb.nodes.shape[0], fb.nodes.dtype, fb.kernel_field)


def kernel_params_at(fb, mu_k):
    """The kernel params of factors whose marginal means are ``mu_k
    [..., K, d]``: the batch's own, or, for a batch with a ``kernel_prep``
    (the patch mode), the ones it forms from ``mu_k`` (the JAX package's
    ``_lanes_leaves``)."""
    if fb.kernel_prep is not None:
        return fb.kernel_prep(mu_k)
    return fb.kernel_params


def _kernel_cost(fb, mu_k):
    if fb.kernel_cost is None or fb.kernel_params is None:
        raise ValueError(
            "the quadrature kernels need a factor batch with kernel_cost and "
            "kernel_params set (a CUDA cost functor in csrc/costs.cuh)"
        )
    return fb.kernel_cost, kernel_params_at(fb, mu_k)


def batch_phi(fb, mu_k, cov_k, use_kernel: bool, eval_dtype=None):
    """E[phi] [..., K] for a NonlinearFactorBatch: the quadrature kernel
    (``kernels.quad.quad_lanes_phi``) or :func:`expectation_phi`.  A
    float16 ``eval_dtype`` keeps the plain quadrature (the kernel rounds
    through bfloat16 only), as in the JAX package.  A patch-mode batch's
    windows follow ``mu_k`` (the trials' means on the line search)."""
    if use_kernel and kernel_quantizes(eval_dtype):
        from ..kernels.quad import quad_lanes_phi

        return quad_lanes_phi(mu_k, cov_k, fb.nodes, fb.weights,
                              *_kernel_cost(fb, mu_k), nonneg=fb.nonneg_cost,
                              field=fb.kernel_field, eval_dtype=eval_dtype)
    return expectation_phi(fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn,
                           fb.params, eval_dtype, nonneg=fb.nonneg_cost)


def batch_moments(fb, mu_k, cov_k, use_pallas: bool = False,
                  use_kernel: bool = False, eval_dtype=None):
    """The three moments for a NonlinearFactorBatch: the block-form kernel
    (``kernels.fused_moments.fused_moments``) when the caller opted in
    (``GVIConfig.use_pallas``) and the batch has a block form, else the
    quadrature kernel (``kernels.quad.quad_lanes_moments``; not for a
    float16 ``eval_dtype``) or :func:`gh_moments`.  Every route applies
    the ``quad_rdim`` lift; a patch-mode batch's windows follow ``mu_k``
    on the kernel route.  The block-form route ignores ``eval_dtype``,
    as the JAX package's does: its kernel has no such argument."""
    if use_pallas and fb.block_cost is not None:
        from ..kernels.fused_moments import fused_moments

        return fused_moments(fb.nodes, fb.weights, mu_k, cov_k,
                             *_kernel_cost(fb, mu_k), rdim=fb.quad_rdim,
                             field=fb.kernel_field)
    if use_kernel and kernel_quantizes(eval_dtype):
        from ..kernels.quad import quad_lanes_moments

        return quad_lanes_moments(mu_k, cov_k, fb.nodes, fb.weights,
                                  *_kernel_cost(fb, mu_k), rdim=fb.quad_rdim,
                                  field=fb.kernel_field,
                                  eval_dtype=eval_dtype)
    return gh_moments(fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn,
                      fb.params, eval_dtype, rdim=fb.quad_rdim)


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


def bw_local_gradients(e_phi, e_xmu, e_xxt, cov):
    """Bures-Wasserstein gradients of the proximal step:

        b_k = Prec_k E[(x-mu)phi]
        S_k = Prec_k E[(x-mu)(x-mu)^T phi] Prec_k - Prec_k E[phi]"""
    prec = spd_inv(cov)
    b_k = torch.einsum("...de,...e->...d", prec, e_xmu)
    s_k = (torch.einsum("...ab,...bc,...cd->...ad", prec, e_xxt, prec)
           - prec * e_phi[..., None, None])
    return b_k, 0.5 * (s_k + s_k.transpose(-1, -2))


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
