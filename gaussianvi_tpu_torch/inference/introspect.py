"""Introspection: per-factor expectations at the current state.

Counterpart of ``gaussianvi_tpu/inference/introspect.py`` (the reference's
E_Phis / E_xMuPhis / E_xMuxMuTPhis accessors), one batched pass per factor
batch on the plain chain and quadrature.  Any leading problem axes pass
through.
"""

from __future__ import annotations

import torch

from ..factors import moments as mm
from ..ops.blocktridiag import gbp_covariance
from .graph import FactorGraph, GaussianState, gather_marginals


def factor_expectations(graph: FactorGraph,
                        state: GaussianState) -> list[dict[str, torch.Tensor]]:
    """Per nonlinear factor batch: ``{"e_phi" [..., K], "e_xmu_phi"
    [..., K, d], "e_xmumu_phi" [..., K, d, d]}`` at the current
    marginals."""
    cov_diag, cov_off = gbp_covariance(state.precision)
    out = []
    for fb in graph.nonlinear:
        mu_k, cov_k = gather_marginals(fb.start, fb.nb, state.mu, cov_diag,
                                       cov_off, fb.slice_offset)
        e_phi, e_xmu, e_xxt = mm.gh_moments(
            fb.nodes, fb.weights, mu_k, cov_k, fb.cost_fn, fb.params,
            rdim=fb.quad_rdim)
        out.append({"e_phi": e_phi, "e_xmu_phi": e_xmu,
                    "e_xmumu_phi": e_xxt})
    return out


def marginals(graph: FactorGraph, state: GaussianState):
    """Every state's marginal: ``(mean [..., N, s], covariance
    [..., N, s, s])``."""
    del graph
    cov_diag, _ = gbp_covariance(state.precision)
    return state.mu, cov_diag
