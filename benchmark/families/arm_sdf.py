"""7-DOF arm planning: the map, each request's endpoints and restarts
drawn from the seed, the program's problem built from them, and the
reference's.

The arm is the configuration's DH chain (``dh``: the WAM table, a sphere
in each listed frame) and the map one sphere obstacle (``obstacle_center``,
``obstacle_radius``) on an ``n_cells``^3 grid spanning ``extent`` metres
centred at the base, the field the exact Euclidean distance to the
obstacle's surface at the grid points.  A request is a start and a goal
joint vector, each drawn uniformly within ``endpoint_jitter`` rad per
joint of the configuration's, and ``per_request`` restarts: the straight
line in joint space from start to goal (joint velocity the line's) with
every entry of the mean but restart 0's perturbed by
N(0, restart_mean_scale^2), precision ``init_prec_scale`` I.
"""

from __future__ import annotations

import numpy as np

from . import batch_graph

JOINTS = 7


def make_shared(cfg: dict) -> dict:
    """The signed distance field ``{"data" [z, y, x], "origin", "cell"}``."""
    n, extent = cfg["n_cells"], cfg["extent"]
    xs = np.linspace(-extent / 2, extent / 2, n)
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    cx, cy, cz = cfg["obstacle_center"]
    sd = (np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2)
          - cfg["obstacle_radius"])
    return {"data": sd, "origin": np.full(3, -extent / 2),
            "cell": extent / (n - 1)}


def make_inputs(cfg: dict, rng: np.random.Generator, requests: int,
                per_request: int) -> dict:
    """The raw arrays of ``requests`` requests of ``per_request``
    restarts, one row a problem (request-major)."""
    n, j = cfg["num_states"], cfg["endpoint_jitter"]
    start = np.asarray(cfg["start"]) + rng.uniform(-j, j, (requests, JOINTS))
    goal = np.asarray(cfg["goal"]) + rng.uniform(-j, j, (requests, JOINTS))
    vel = (goal - start) / cfg["total_time"]
    ts = np.linspace(0.0, 1.0, n)[None, :, None]
    line = np.concatenate([start[:, None] + ts * (goal - start)[:, None],
                           np.repeat(vel[:, None], n, 1)], axis=2)
    noise = cfg["restart_mean_scale"] * rng.standard_normal(
        (requests, per_request, n, 2 * JOINTS))
    noise[:, 0] = 0.0
    init = (line[:, None] + noise).reshape(requests * per_request, n,
                                           2 * JOINTS)
    return {"start": np.repeat(start, per_request, 0),
            "goal": np.repeat(goal, per_request, 0), "init_mu": init}


def _ends(cfg: dict, inputs: dict) -> list:
    """Every problem's start and goal states ``[P, 14]`` (joint angles and
    the straight line's joint velocity)."""
    vel = (inputs["goal"] - inputs["start"]) / cfg["total_time"]
    return [np.concatenate([inputs[k], vel], 1) for k in ("start", "goal")]


def build_problem(cfg: dict, inputs: dict, i: int, dtype, device, shared,
                  base=None):
    """Problem ``i``'s graph alone, through the program's public
    constructors; with ``base`` (another problem's graph of the same arm
    and map), its obstacle factor and GP prior, as restarts share them."""
    import torch
    from gaussianvi_tpu_torch.factors.priors import (
        fixed_prior,
        minimum_acc_prior,
    )
    from gaussianvi_tpu_torch.factors.robots import (
        DHForwardKinematics,
        make_arm_obstacle_factor,
    )
    from gaussianvi_tpu_torch.factors.sdf import SDF3D
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a), dtype=dt, device=device)

    n, s = cfg["num_states"], 2 * JOINTS
    cov = cfg["anchor_cov"] * np.eye(s)
    anchors = [fixed_prior(k, e[i], cov, dtype=dtype, device=device)
               for k, e in zip((0, n - 1), _ends(cfg, inputs))]
    if base is not None:
        return FactorGraph(num_states=n, state_dim=s,
                           nonlinear=base.nonlinear,
                           linear=(*anchors, base.linear[-1]))
    dh = cfg["dh"]
    fk = DHForwardKinematics(
        a=t(dh["a"]), alpha=t(dh["alpha"]), d=t(dh["d"]),
        theta_bias=t(dh["theta_bias"]), frames=t(dh["frames"], torch.int64),
        centers=t(dh["centers"]))
    sdf = SDF3D(t(shared["data"]), t(shared["origin"]), t(shared["cell"]))
    obstacle = make_arm_obstacle_factor(
        sdf, fk, dh["radii"], np.arange(n), state_dim=s,
        cost_sigma=cfg["cost_sigma"], epsilon=cfg["epsilon"],
        slope=cfg["slope"], gh_degree=cfg["gh_degree"], n_joints=JOINTS,
        interp="auto", marginal_quad=cfg["marginal_quad"], dtype=dtype,
        device=device)
    gp = minimum_acc_prior(cfg["qc"] * np.eye(JOINTS),
                           cfg["total_time"] / (n - 1), n, dtype=dtype,
                           device=device)
    return FactorGraph(num_states=n, state_dim=s, nonlinear=(obstacle,),
                       linear=(*anchors, gp))


def build_program(cfg: dict, inputs: dict, dtype, device, shared):
    """The program's graph of every problem of ``inputs``: problem 0's
    graph (``build_problem``) given every problem's own anchors."""
    import torch

    graph = build_problem(cfg, inputs, 0, dtype, device, shared)
    return batch_graph(graph, inputs["start"].shape[0], {
        ("linear", k, "target_mu"): torch.as_tensor(
            e[:, None, :], dtype=dtype, device=device)
        for k, e in enumerate(_ends(cfg, inputs))})


def build_reference(cfg, inputs, guard_eps, device, shared, dtype=None):
    import torch

    from ..reference.arm_sdf import problems

    kernel_route_held(device)
    return problems(cfg, inputs, shared, guard_eps, device,
                    dtype or torch.float64)


def kernel_route_held(device) -> None:
    """Raise if, on the card, the program resolved an arm batch to the
    plain quadrature in this process (``kernels.quad_route_counts``): the
    cell measures the arm's kernel route, and a silent fall back to the
    plain one fails the run.  Called before the check, after the window.
    A program that counts no routes has no kernel for the arm; its plain
    route is then the one measured."""
    import torch

    try:
        from gaussianvi_tpu_torch.kernels import quad_route_counts
    except ImportError:
        return
    if torch.device(device).type != "cuda":
        return
    routes = quad_route_counts()
    if routes["plain"]:
        raise RuntimeError(f"the arm's batches left the quadrature kernel: "
                           f"{routes}")


# the arm's cost, operations a node, counted from the functor
# (csrc/costs.cuh ArmSdfCost): a joint 66 (the angle's sum, a sine and a
# cosine, 6 products of the transform's entries, 3 rows of 19 for the
# rotation and the origin), a sphere 75 (its center 18, the field lookup
# and hinge 55 as the 3-D point's, the radius and the running sum 2)
ARM_COST_OPS = JOINTS * 66 + JOINTS * 75


def shapes(cfg: dict) -> dict:
    """The problem's shapes for the work counts (``work.py``): a node
    costs ``ARM_COST_OPS``; per problem its two anchor means; shared the
    anchors' precisions, the GP's [-Phi, I] and Q^-1, the field and the
    arm's 77 params (one row every factor reads).  ``quad_shared``: what
    a quadrature launch reads once besides its factors (the field, the
    params, the rule over the joint angles)."""
    n, s, m = cfg["num_states"], 2 * JOINTS, len(cfg["rule"]["weights"])
    field = cfg["n_cells"] ** 3
    return dict(n=n, s=s, m=m, dx=cfg["rule"]["dim"], cost=ARM_COST_OPS,
                own=2 * s, shared=2 * s * s + 3 * s * s + field + 77,
                factors=2 * n + 1,
                quad_shared=field + 77 + m * (cfg["rule"]["dim"] + 1))
