"""Joint-level cost and NGD gradient assembly.

Counterpart of ``gaussianvi_tpu/inference/gvi.py`` (NGD part): cost =
sum_k E[psi_k] (/T) + 0.5 log det Lambda, and the joint natural-gradient
pieces (Vdmu, Vddmu) scatter-added from every factor batch.  Tensors carry
the problem axis first; ``temperature`` is a scalar or ``[B]``.
"""

from __future__ import annotations

import torch

from ..factors import moments as mm
from ..ops.blocktridiag import BlockTridiag
from .graph import FactorGraph, gather_marginals, scatter_gradients


def factor_costs(graph: FactorGraph, mu, cov_diag, cov_off, temperature,
                 temper_costs: bool = True, use_kernel: bool = False):
    """Concatenated per-factor expected costs E[psi_k] (optionally / T):
    ``[..., K_total]``, nonlinear batches first, then linear."""
    t = temperature if temper_costs else 1.0
    if isinstance(t, torch.Tensor) and t.ndim:
        t = t[..., None]
    costs = []
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                       cov_off, fb.slice_offset)
        costs.append(mm.batch_phi(fb, mu_k, cov_k, use_kernel) / t)
    for lb in graph.linear:
        costs.append(mm.batch_linear_cost(lb, mu, cov_diag, cov_off) / t)
    if not costs:
        return mu.new_zeros((*mu.shape[:-2], 0))
    return torch.cat(costs, dim=-1)


def ngd_gradients(graph: FactorGraph, mu, cov_diag, cov_off, temperature,
                  use_kernel: bool = False):
    """Assemble joint (Vdmu [..., N, s], Vddmu block-tridiag).

    The NGD step downstream is d_precision = Vddmu - Lambda and
    d_mu = solve(Vddmu, -Vdmu)."""
    n, s = mu.shape[-2:]
    vdmu_joint = torch.zeros_like(mu)
    vddmu_joint = BlockTridiag.zeros(mu.shape[:-2], n, s, mu.dtype,
                                     mu.device)
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                       cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_k, cov_k, use_kernel)
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
