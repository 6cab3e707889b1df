"""Block-form sigma-point moments kernel (K4).

Counterpart of ``gaussianvi_tpu/kernels/fused_moments.py``
(``fused_moments``): from the factors' marginals, the shared rule and the
cost, one pass gives E[phi] ``[..., K]``, E[(x-mu) phi] ``[..., K, d]`` and
E[(x-mu)(x-mu)^T phi] ``[..., K, d, d]`` without the sigma points ever
reaching device memory.  Unguarded (the gradient path).  Unlike the JAX
kernel's caller, this one applies the marginal-rule lift
``L[:, r:] L[:, r:]^T E[phi]`` for ``rdim``, so a rule over the leading
``rdim`` dims gives the moments of ``factors.moments.gh_moments``.

On the card the cost is the CUDA functor ``kernel_cost`` names
(``csrc/costs.cuh``) with its packed params, and the kernel
(``csrc/fused_moments.cu``) takes the covariance and its Cholesky factor
itself: one call is one launch and no PyTorch op.  It is the quadrature
kernel's moments body (``csrc/quad.cuh``) under its own entry, with the
same operand layout (read in place: ``kernels.quad._operands``) and plan
(``kernels.quad.quad_plan``).  For CPU tensors the wrapper runs
:func:`fused_moments_plain`, which takes the Cholesky factor with
``chol_small`` as the JAX wrapper does and the cost as a block-form
callable (``NonlinearFactorBatch.block_cost`` with the param leaves, or
the functor's PyTorch form with the packed params as its one leaf);
``fused_moments.launches`` counts kernel launches only.
"""

from __future__ import annotations

import math

import torch

from ..ops.smallmat import chol_small
from ..utils.profiling import span
from . import _build
from .quad import _operands, cost_form


def fused_moments_plain(nodes, weights, mu, cov, block_cost, params=(),
                        rdim=None):
    """Plain version, step by step: ``mu [K, d]``, ``cov [K, d, d]``,
    ``block_cost(pts [K, M, d], *rows [K, 1, *leaf]) -> [K, M]`` with
    ``params`` a tuple of leaves with leading K."""
    chol = chol_small(cov)                                   # [K, d, d]
    # diff[k, m, e] = sum_d nodes[m, d] * chol[k, e, d]
    diff = torch.sum(nodes[None, :, None, :] * chol[:, None, :, :], dim=-1)
    pts = diff + mu[:, None, :]                              # [K, M, d]
    phi = block_cost(pts, *[p[:, None] for p in params])     # [K, M]
    wphi = phi * weights[None, :]
    e_phi = torch.sum(wphi, dim=1)
    wd = wphi[:, :, None] * diff                             # [K, M, d]
    e_xmu = torch.sum(wd, dim=1)
    e_xxt = torch.sum(wd[:, :, :, None] * diff[:, :, None, :], dim=1)
    if rdim is not None and rdim < mu.shape[-1]:
        lhi = chol[..., rdim:]
        e_xxt = e_xxt + (lhi @ lhi.transpose(-1, -2)) * e_phi[:, None, None]
    return e_phi, e_xmu, e_xxt


def _launch(nodes, weights, mu, cov, kernel_cost, kernel_params, rdim,
            field=None):
    """One K4 launch (``gvi_fused_moments``) on the operands as they lie."""
    d = mu.shape[-1]
    call = _operands("fused_moments", mu, cov, nodes, weights, kernel_cost,
                     kernel_params, True, field)
    err = _build.load().gvi_fused_moments(
        _build.DTYPES[mu.dtype], d, call.cost_id, *call.args,
        d if rdim is None else rdim, call.plan.group.bit_length() - 1,
        call.plan.threads, _build.current_stream(mu.device))
    _build.check(err, "gvi_fused_moments")
    return call.outs


def fused_moments(nodes, weights, mu, cov, kernel_cost, kernel_params,
                  rdim: int | None = None, field=None):
    """K4: ``nodes [M, d]``, ``weights [M]``, ``mu [..., K, d]``,
    ``cov [..., K, d, d]``, the cost as the functor name ``kernel_cost``
    with ``kernel_params`` (packed, broadcastable to ``[..., K, P]``) and
    its ``field`` where it reads one -> the three moments, with the
    marginal-rule lift for ``rdim``.  (The field passes through to the
    body K4 shares with K3; no batch with a field has a block form today,
    so none reaches K4 from the engine, as in the JAX package.)

    GPU tensors launch the kernel, which factorizes ``cov`` itself; CPU
    tensors run the plain version with the functor's PyTorch form, which is
    a block cost with the packed params as its one leaf."""
    if kernel_cost is None or kernel_params is None:
        raise ValueError(
            "the block-form moments kernel needs a factor batch with "
            "kernel_cost and kernel_params set (a CUDA cost functor in "
            "csrc/costs.cuh)")
    lead = mu.shape[:-1]
    d = mu.shape[-1]
    if cov.shape != (*lead, d, d):
        raise ValueError(f"fused_moments: shape mismatch mu {tuple(mu.shape)},"
                         f" cov {tuple(cov.shape)}")
    if mu.device.type != "cpu":
        with span("gvi.kernel.fused_moments"):
            out = _launch(nodes, weights, mu, cov, kernel_cost, kernel_params,
                          rdim, field)
            fused_moments.launches += 1
            return out
    count = math.prod(lead)
    p = kernel_params.shape[-1]
    par_f = kernel_params.expand(*lead, p).reshape(count, p)
    e_phi, e_xmu, e_xxt = fused_moments_plain(
        nodes, weights, mu.reshape(count, d), cov.reshape(count, d, d),
        cost_form(kernel_cost, field), (par_f,), rdim)
    return (e_phi.reshape(lead), e_xmu.reshape(*lead, d),
            e_xxt.reshape(*lead, d, d))


fused_moments.launches = 0
