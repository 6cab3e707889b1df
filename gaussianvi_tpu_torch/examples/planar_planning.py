"""Planar point-robot motion planning through an obstacle field.

Counterpart of ``gaussianvi_tpu/examples/planar_planning.py``: a GVI
trajectory optimizer whose factor graph is start/goal anchors, a
minimum-acceleration GP prior and one SDF collision factor per state (the
reference's parent application, stochastic motion planning as GVI).  The
arrays are built as the JAX package builds them (float64 NumPy, then
tensors).  With the default ``interp`` the collision batch names the
``"planar_sdf"`` CUDA cost functor, so on the card ``"auto"`` runs the
whole planner on the kernels: K1 (and K2 on the separate path), K3, and
the fused K5 / K6 by default.  Restarts (``parallel.perturb_inits``) run
as one problem-batched ``optimize`` call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import make_planar_obstacle_factor, planar_point_balls
from ..factors.sdf import PlanarSDF
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag


def block_obstacle_sdf(extent: float = 10.0, n_cells: int = 100,
                       block_x=(4.0, 6.0), block_y=(3.0, 5.0),
                       dtype=torch.float64, device=None) -> PlanarSDF:
    """Euclidean SDF of one axis-aligned box obstacle (off the start-goal
    diagonal by default, so the planner is not started at a symmetry
    saddle).  ``device=None`` is the card."""
    device = resolve_device(device)
    cell = extent / (n_cells - 1)
    xs = np.linspace(0.0, extent, n_cells)
    xx, yy = np.meshgrid(xs, xs, indexing="xy")
    # distance to the box block_x x block_y (positive outside, negative in)
    dx = np.maximum(block_x[0] - xx, xx - block_x[1])
    dy = np.maximum(block_y[0] - yy, yy - block_y[1])
    outside = np.hypot(np.maximum(dx, 0.0), np.maximum(dy, 0.0))
    inside = np.minimum(np.maximum(dx, dy), 0.0)
    sd = outside + inside

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PlanarSDF(t(sd), t([0.0, 0.0]), t(cell))


def build_planar_planning(
    num_states: int = 20,
    total_time: float = 4.0,
    start=(1.0, 1.0),
    goal=(8.5, 8.5),
    cost_sigma: float = 5.0,
    epsilon: float = 0.4,
    radius: float = 0.2,
    gh_degree: int = 3,
    patch_size: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=torch.float64,
    device=None,
):
    """One planning problem: ``(graph, init_state, config, sdf)``.

    ``interp="matmul"``: the hat-function SDF interpolation, a
    ``cost_fn``-only collision batch on the plain quadrature.
    ``patch_size``: the patch mode (``factors/robots.py``), windows of
    that many cells a side (on the card the default is faster, PERF.md
    section 5).  ``device=None`` is the card (``device.default_device``);
    ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    dim_x, state_dim = 2, 4
    dt = total_time / (num_states - 1)
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    vel = (goal - start) / total_time

    sdf = block_obstacle_sdf(dtype=dtype, device=device)
    obstacle = make_planar_obstacle_factor(
        sdf,
        np.arange(num_states),
        state_dim=state_dim,
        cost_sigma=cost_sigma,
        epsilon=epsilon,
        radius=radius,
        balls_fn=planar_point_balls,
        gh_degree=gh_degree,
        patch_size=patch_size,
        interp=interp,
        marginal_quad=marginal_quad,
        dtype=dtype,
        device=device,
    )
    anchors = [
        fixed_prior(idx, np.concatenate([p, vel]), 0.01 * np.eye(state_dim),
                    dtype=dtype, device=device)
        for idx, p in ((0, start), (num_states - 1, goal))
    ]
    gp = minimum_acc_prior(1.0 * np.eye(dim_x), dt, num_states, dtype=dtype,
                           device=device)
    graph = FactorGraph(num_states=num_states, state_dim=state_dim,
                        nonlinear=(obstacle,), linear=(*anchors, gp))

    # straight-line initialization (goes through the obstacle)
    ts = np.linspace(0.0, 1.0, num_states)[:, None]
    pos = start[None, :] + ts * (goal - start)[None, :]
    init_mu = np.concatenate([pos, np.tile(vel, (num_states, 1))], axis=1)
    init = GaussianState(
        torch.as_tensor(init_mu, dtype=dtype, device=device),
        BlockTridiag.identity((), num_states, state_dim, 10.0, dtype, device),
    )
    config = GVIConfig(niters=30, niters_lowtemp=20, step_size_base=0.9,
                       temperature=0.1, high_temperature=1.0)
    return graph, init, config, sdf


def run_planar_planning(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history, sdf)``."""
    graph, init, config, sdf = build_planar_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf
