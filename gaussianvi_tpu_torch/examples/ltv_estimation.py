"""Batch state estimation with a linear time-varying (LTV) GP prior.

Counterpart of ``gaussianvi_tpu/examples/ltv_estimation.py`` (the
reference's LTV configuration): the prior between consecutive states comes
from a damped pendulum linearized about a nominal trajectory,
x' = A(t) x + B u, with the transition matrix and controllability Gramian
integrated per segment and the nominal trajectory entering through
Psi = [Phi, -I]; a range measurement of the angle to a beacon at -1 per
state.  N = 10 states of dim 2, the degree-4 rule.  The measurement batch
carries its cost as PyTorch code only (``cost_fn``, as in the JAX package,
where it has no lane form): on the card ``"auto"`` runs K1 / K2 at s = 2
and the plain quadrature, the route the JAX package takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.base import make_nonlinear_batch
from ..factors.priors import fixed_prior, ltv_prior
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag
from .chain_estimation import range_cost


def pendulum_ltv_system(num_states: int, dt: float, theta_nom: np.ndarray):
    """Piecewise-constant (A, B) of a damped pendulum x = [theta,
    theta_dot] linearized about ``theta_nom``: A(t) = [[0, 1],
    [-cos(theta_nom(t)), -0.2]], B = [[0], [1]]; 5 sub-intervals a
    segment, index 4 i + j."""
    a_list, b_list = [], []
    for i in range(num_states - 1):
        for j in range(5):
            t = (i + j / 4.0) * dt
            idx = min(int(np.floor(t / dt)), num_states - 1)
            a_list.append(np.array([[0.0, 1.0],
                                    [-np.cos(theta_nom[idx]), -0.2]]))
            b_list.append(np.array([[0.0], [1.0]]))
    return a_list, b_list


def build_ltv_estimation(num_states: int = 10, dt: float = 0.2,
                         gh_degree: int = 4, seed: int = 0,
                         dtype=torch.float64, device=None):
    """One problem: ``(graph, init_state, config)``, the arrays built as the
    JAX package builds them (same numpy stream).  ``device=None`` is the
    card; ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    state_dim = 2
    rng = np.random.default_rng(seed)
    theta_nom = 0.5 + 0.1 * np.arange(num_states) * dt
    target_means = [np.array([theta_nom[i], 0.1]) for i in range(num_states)]
    a_list, b_list = pendulum_ltv_system(num_states, dt, theta_nom)
    gp = ltv_prior(a_list, b_list, target_means, dt, num_states, dtype=dtype,
                   device=device)
    anchor = fixed_prior(0, target_means[0], 0.05 * np.eye(state_dim),
                         dtype=dtype, device=device)
    ranges = np.abs(theta_nom + 1.0) + 0.05 * rng.standard_normal(num_states)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    meas = make_nonlinear_batch(
        range_cost,
        np.arange(num_states),
        state_dim=state_dim,
        params={"r": t(ranges), "beacon": t(np.full((num_states, 1), -1.0)),
                "sig_r_sq": t(np.full(num_states, 0.05**2))},
        gh_degree=gh_degree,
        nonneg_cost=True,   # squared residual: E[phi] >= 0 by construction
        dtype=dtype,
        device=device,
    )
    graph = FactorGraph(num_states=num_states, state_dim=state_dim,
                        nonlinear=(meas,), linear=(anchor, gp))
    init = GaussianState(
        t(np.stack(target_means)),
        BlockTridiag.identity((), num_states, state_dim, 5.0, dtype, device))
    config = GVIConfig(niters=15, niters_lowtemp=15, step_size_base=0.9)
    return graph, init, config


def run_ltv_estimation(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history)``."""
    graph, init, config = build_ltv_estimation(**kwargs)
    return optimize(graph, init, config, method=method)
