"""7-DOF arm motion planning through a 3-D SDF.

Counterpart of ``gaussianvi_tpu/examples/arm_planning.py``: the
reference's largest model family (CudaOperation_3dArm: DH forward
kinematics -> sphere centers -> 3-D SDF -> hinge obstacle cost) with
WAM-like DH parameters.  State per time step = [theta(7); theta_dot(7)]
(s = 14), a minimum-acceleration GP prior in joint space, anchors at the
start and goal configurations, and the collision batch on the 15-node
(7, 2) joint-marginal rule.  The collision batch is ``cost_fn``-only, as in
the JAX package, so on the card ``"auto"`` runs the chain kernels K1 / K2
at s = 14 and the plain quadrature.  The arrays are built as the JAX
package builds them (float64 numpy, then cast).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..factors.robots import DHForwardKinematics, make_arm_obstacle_factor
from ..factors.sdf import SDF3D
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag


def wam_fk(dtype=torch.float64, device=None) -> DHForwardKinematics:
    """7-DOF WAM arm DH parameters with one collision sphere per link
    frame.  ``device=None`` is the card."""
    device = resolve_device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return DHForwardKinematics(
        a=t([0.0, 0.0, 0.045, -0.045, 0.0, 0.0, 0.0]),
        alpha=t([-np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2,
                 -np.pi / 2, np.pi / 2, 0.0]),
        d=t([0.0, 0.0, 0.55, 0.0, 0.3, 0.0, 0.06]),
        theta_bias=t(np.zeros(7)),
        frames=t([2, 2, 3, 4, 5, 6, 6], torch.int64),
        centers=t([[0.0, 0.0, -0.4], [0.0, 0.0, -0.2], [0.0, 0.0, 0.0],
                   [0.0, 0.0, -0.15], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.05]]),
    )


def sphere_obstacle_sdf3d(center=(0.45, 0.0, 0.6), radius=0.2, extent=2.0,
                          n_cells=40, dtype=torch.float64,
                          device=None) -> SDF3D:
    """Euclidean SDF of one sphere obstacle, grid centered at the origin
    (``data[z, y, x]``).  ``device=None`` is the card."""
    device = resolve_device(device)
    cell = extent / (n_cells - 1)
    xs = np.linspace(-extent / 2, extent / 2, n_cells)
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    sd = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                 + (zz - center[2]) ** 2) - radius
    return SDF3D(
        torch.as_tensor(sd, dtype=dtype, device=device),
        torch.full((3,), -extent / 2, dtype=dtype, device=device),
        torch.tensor(cell, dtype=dtype, device=device),
    )


def build_arm_planning(
    num_states: int = 10,
    total_time: float = 2.0,
    cost_sigma: float = 20.0,
    epsilon: float = 0.1,
    gh_degree: int = 2,
    dtype=torch.float64,
    device=None,
):
    """One planning problem: ``(graph, init_state, config, (fk, sdf))``.
    ``device=None`` is the card; ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    n_joints = 7
    state_dim = 2 * n_joints
    dt = total_time / (num_states - 1)
    fk = wam_fk(dtype, device)
    sdf = sphere_obstacle_sdf3d(dtype=dtype, device=device)
    radii = np.full(7, 0.05)

    start_q = np.zeros(n_joints)
    goal_q = np.array([0.8, 0.6, 0.0, -0.4, 0.0, 0.3, 0.0])
    vel = (goal_q - start_q) / total_time

    obstacle = make_arm_obstacle_factor(
        sdf, fk, radii, np.arange(num_states), state_dim=state_dim,
        cost_sigma=cost_sigma, epsilon=epsilon, gh_degree=gh_degree,
        n_joints=n_joints, dtype=dtype, device=device)
    anchors = [
        fixed_prior(idx, np.concatenate([q, vel]), 0.01 * np.eye(state_dim),
                    dtype=dtype, device=device)
        for idx, q in ((0, start_q), (num_states - 1, goal_q))
    ]
    gp = minimum_acc_prior(np.eye(n_joints), dt, num_states, dtype=dtype,
                           device=device)
    graph = FactorGraph(num_states=num_states, state_dim=state_dim,
                        nonlinear=(obstacle,), linear=(*anchors, gp))

    ts = np.linspace(0.0, 1.0, num_states)[:, None]
    qs = start_q[None, :] + ts * (goal_q - start_q)[None, :]
    init_mu = np.concatenate([qs, np.tile(vel, (num_states, 1))], axis=1)
    init = GaussianState(
        torch.as_tensor(init_mu, dtype=dtype, device=device),
        BlockTridiag.identity((), num_states, state_dim, 10.0, dtype, device),
    )
    config = GVIConfig(niters=15, niters_lowtemp=15, step_size_base=0.9)
    return graph, init, config, (fk, sdf)


def run_arm_planning(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history, (fk,
    sdf))``."""
    graph, init, config, aux = build_arm_planning(**kwargs)
    final, hist = optimize(graph, init, config, method=method)
    return final, hist, aux
