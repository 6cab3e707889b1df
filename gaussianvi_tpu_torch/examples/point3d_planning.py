"""3-D point-robot motion planning through an obstacle field.

Counterpart of ``gaussianvi_tpu/examples/point3d_planning.py``: a point
robot in 3-D (state [pos3; vel3], s = 6), one collision ball at (x, y, z),
the trilinear SDF lookup and the hinge obstacle cost, wired into the same
anchors + minimum-acceleration GP + collision factor graph as the planar
planner.  The field is generated from an occupancy grid
(``factors.sdf_io.sdf_from_occupancy``) and round-trips through the
``.npz`` map format when a ``map_file`` is given; the arrays are built as
the JAX package builds them.  With the default ``interp`` the collision
batch names the ``"sdf3d"`` CUDA cost functor, so on the card ``"auto"``
runs the whole planner on the kernels: K1 (and K2 on the separate path),
K3, and the fused K5 / K6 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import make_point3d_obstacle_factor
from ..factors.sdf import SDF3D
from ..factors.sdf_io import load_sdf, save_sdf, sdf_from_occupancy
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag


def box_obstacle_sdf3d(extent: float = 10.0, n_cells: int = 50,
                       block_x=(4.0, 6.0), block_y=(3.0, 5.0),
                       block_z=(2.0, 7.0), dtype=torch.float64,
                       device=None) -> SDF3D:
    """Euclidean SDF of one axis-aligned box obstacle, built through the
    occupancy-grid pipeline.  ``device=None`` is the card."""
    cell = extent / (n_cells - 1)
    xs = np.linspace(0.0, extent, n_cells)
    # SDF3D layout: data[z, row(y), col(x)]
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    occ = ((xx >= block_x[0]) & (xx <= block_x[1])
           & (yy >= block_y[0]) & (yy <= block_y[1])
           & (zz >= block_z[0]) & (zz <= block_z[1]))
    return sdf_from_occupancy(occ, cell, origin=(0.0, 0.0, 0.0), dtype=dtype,
                              device=device)


def build_point3d_planning(
    num_states: int = 20,
    total_time: float = 4.0,
    start=(1.0, 1.0, 4.5),
    goal=(8.5, 8.5, 4.5),
    cost_sigma: float = 5.0,
    epsilon: float = 0.4,
    radius: float = 0.2,
    gh_degree: int = 3,
    patch_size: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    map_file=None,
    dtype=torch.float64,
    device=None,
):
    """One planning problem: ``(graph, init_state, config, sdf)``.

    ``map_file``: the generated SDF is saved there and loaded back (the
    map IO path).  ``interp="matmul"``: the hat-function interpolation, a
    ``cost_fn``-only collision batch on the plain quadrature.
    ``patch_size``: the patch mode (``factors/robots.py``), windows of
    that many voxels a side (the JAX package runs ``patch_size=8`` on a
    TPU; on the card the default is faster, PERF.md section 5).
    ``device=None`` is the card; ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    dim_x, state_dim = 3, 6
    dt = total_time / (num_states - 1)
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    vel = (goal - start) / total_time

    sdf = box_obstacle_sdf3d(dtype=dtype, device=device)
    if map_file is not None:
        save_sdf(map_file, sdf)
        sdf = load_sdf(map_file, dtype=dtype, device=device)

    obstacle = make_point3d_obstacle_factor(
        sdf,
        np.arange(num_states),
        state_dim=state_dim,
        cost_sigma=cost_sigma,
        epsilon=epsilon,
        radius=radius,
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


def run_point3d_planning(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history, sdf)``."""
    graph, init, config, sdf = build_point3d_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, sdf
