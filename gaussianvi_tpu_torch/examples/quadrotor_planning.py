"""Planar quadrotor motion planning.

Counterpart of ``gaussianvi_tpu/examples/quadrotor_planning.py``: state
[x, z, phi, vx, vz, phi_dot] (s = 6) with five collision-check balls along
the body axis, a hinge obstacle cost against a planar SDF on the
pose-marginal rule (the cost reads (x, z, phi) only), and a minimum-acc GP
prior over the three pose coordinates.  The obstacle batch is
``cost_fn``-only, as in the JAX package (no CUDA functor takes five balls
yet), so on the card ``"auto"`` runs the chain kernels K1 / K2 and the
plain quadrature.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.base import NonlinearFactorBatch, marginal_rule
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import _resolve_interp, planar_quad_balls
from ..factors.sdf import hinge_obstacle_cost
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag
from .planar_planning import block_obstacle_sdf


def build_quadrotor_planning(
    num_states: int = 12,
    total_time: float = 3.0,
    cost_sigma: float = 3.0,
    epsilon: float = 0.3,
    radius: float = 1.0,
    n_balls: int = 5,
    body_length: float = 5.0,
    gh_degree: int = 2,
    interp: str = "auto",
    dtype=torch.float64,
    device=None,
):
    """One planning problem: ``(graph, init_state, config, sdf)``.
    ``device=None`` is the card; ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    dim_pose, state_dim = 3, 6
    dt = total_time / (num_states - 1)
    start = np.array([2.0, 1.0, 0.0])
    goal = np.array([16.0, 8.0, 0.0])
    vel = (goal - start) / total_time

    sdf = block_obstacle_sdf(extent=20.0, n_cells=120, block_x=(8.0, 11.0),
                             block_y=(2.0, 5.0), dtype=dtype, device=device)
    lookup = (sdf.signed_distance_matmul
              if _resolve_interp(interp) == "matmul" else sdf.signed_distance)

    def quad_cost(x, params):
        del params
        balls = planar_quad_balls(x, n_balls, body_length, radius)
        return hinge_obstacle_cost(lookup(balls), epsilon, radius,
                                   cost_sigma, slope=5.0)

    # pose-marginal quadrature: quad_cost reads (x, z, phi) = x[:3] only
    nodes, weights = marginal_rule(state_dim, dim_pose, gh_degree)
    obstacle = NonlinearFactorBatch(
        start=torch.arange(num_states, device=device),
        slice_offset=0,
        nodes=torch.as_tensor(nodes, dtype=dtype, device=device),
        weights=torch.as_tensor(np.asarray(weights), dtype=dtype,
                                device=device),
        params=None,
        cost_fn=quad_cost,
        nb=1,
        nonneg_cost=True,
        quad_rdim=dim_pose,
    )
    anchors = [
        fixed_prior(idx, np.concatenate([p, vel]), 0.01 * np.eye(state_dim),
                    dtype=dtype, device=device)
        for idx, p in ((0, start), (num_states - 1, goal))
    ]
    gp = minimum_acc_prior(np.eye(dim_pose), dt, num_states, dtype=dtype,
                           device=device)
    graph = FactorGraph(num_states=num_states, state_dim=state_dim,
                        nonlinear=(obstacle,), linear=(*anchors, gp))
    ts = np.linspace(0.0, 1.0, num_states)[:, None]
    pose = start[None] + ts * (goal - start)[None]
    init_mu = np.concatenate([pose, np.tile(vel, (num_states, 1))], axis=1)
    init = GaussianState(
        torch.as_tensor(init_mu, dtype=dtype, device=device),
        BlockTridiag.identity((), num_states, state_dim, 10.0, dtype, device),
    )
    config = GVIConfig(niters=20, niters_lowtemp=20, step_size_base=0.9)
    return graph, init, config, sdf


def run_quadrotor_planning(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history, sdf)``."""
    graph, init, config, sdf = build_quadrotor_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf
