"""The 1-D nonlinear estimation example of Barfoot et al. (IJRR'20).

Counterpart of ``gaussianvi_tpu/examples/barfoot_1d.py``: a single scalar
nonlinear factor

    psi(x) = (x - mu_p)^2 / (2 sig_p^2) + (y - f b / x)^2 / (2 sig_r^2)

with mu_p = 20, f = 400, b = 0.1, sig_p^2 = 9, sig_r^2 = 0.09,
y = f b / mu_p - 0.8; GH degree 10; q0 = N(20, 9); 10 iterations with step
base 0.75 and no temperature switch.  Its converged trajectories are the
reference's golden data (``tests/test_golden_1d.py``).  One state of one
dimension (N = 1, s = 1): on the card ``"auto"`` runs the chain kernels
K1 / K2 at s = 1 and the plain quadrature (the factor is ``cost_fn``-only,
as in the JAX package).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..factors.base import make_nonlinear_batch
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag


def barfoot_cost(x, params):
    """psi(x) for ``x [M, ..., K, 1]``."""
    del params
    xx = x[..., 0]
    mu_p, f, b = 20.0, 400.0, 0.1
    sig_r_sq, sig_p_sq = 0.09, 9.0
    y = f * b / mu_p - 0.8
    return ((xx - mu_p) ** 2 / sig_p_sq / 2
            + (y - f * b / xx) ** 2 / sig_r_sq / 2)


def build_barfoot_1d(gh_degree: int = 10, dtype=torch.float64, device=None):
    """``(graph, init_state, config)``.  ``device=None`` is the card;
    ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    fb = make_nonlinear_batch(barfoot_cost, [0], state_dim=1, nb=1,
                              gh_degree=gh_degree, nonneg_cost=True,
                              dtype=dtype, device=device)
    graph = FactorGraph(num_states=1, state_dim=1, nonlinear=(fb,))
    init = GaussianState(
        torch.tensor([[20.0]], dtype=dtype, device=device),
        BlockTridiag(torch.tensor([[[1.0 / 9.0]]], dtype=dtype,
                                  device=device),
                     torch.zeros((0, 1, 1), dtype=dtype, device=device)),
    )
    config = GVIConfig(niters=10, niters_lowtemp=10, step_size_base=0.75)
    return graph, init, config


def run_barfoot_1d(method: str = "ngd", gh_degree: int = 10,
                   dtype=torch.float64, device=None):
    """Build and optimize: ``(final_state, history)``."""
    graph, init, config = build_barfoot_1d(gh_degree, dtype, device)
    return optimize(graph, init, config, method=method)
