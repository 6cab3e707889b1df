"""3-D point-robot planning: the map, each request's endpoints and
restarts drawn from the seed, the program's problem built from them, and
the reference's.

The map is the configuration's: boxes in a cube of ``extent`` metres on an
``n_cells``^3 grid, the field the Euclidean distance transform of the
occupancy grid (positive outside, negative inside, between cell centres).
A request is a start and a goal, each drawn uniformly within
``endpoint_jitter`` of the configuration's, and ``per_request`` restarts:
the straight line from start to goal (velocity the line's) with every
entry of the mean but restart 0's perturbed by N(0, restart_mean_scale^2),
precision ``init_prec_scale`` I.
"""

from __future__ import annotations

import numpy as np

from . import batch_graph


def make_shared(cfg: dict) -> dict:
    """The signed distance field ``{"data" [z, y, x], "origin", "cell"}``."""
    from scipy.ndimage import distance_transform_edt

    n, extent = cfg["n_cells"], cfg["extent"]
    cell = extent / (n - 1)
    xs = np.linspace(0.0, extent, n)
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    occ = np.zeros(zz.shape, bool)
    for (x0, x1), (y0, y1), (z0, z1) in cfg["boxes"]:
        occ |= ((xx >= x0) & (xx <= x1) & (yy >= y0) & (yy <= y1)
                & (zz >= z0) & (zz <= z1))
    sd = (distance_transform_edt(~occ) - distance_transform_edt(occ)) * cell
    return {"data": sd, "origin": np.zeros(3), "cell": cell}


def make_inputs(cfg: dict, rng: np.random.Generator, requests: int,
                per_request: int) -> dict:
    """The raw arrays of ``requests`` requests of ``per_request``
    restarts, one row a problem (request-major)."""
    n, j = cfg["num_states"], cfg["endpoint_jitter"]
    start = np.asarray(cfg["start"]) + rng.uniform(-j, j, (requests, 3))
    goal = np.asarray(cfg["goal"]) + rng.uniform(-j, j, (requests, 3))
    vel = (goal - start) / cfg["total_time"]
    ts = np.linspace(0.0, 1.0, n)[None, :, None]
    line = np.concatenate([start[:, None] + ts * (goal - start)[:, None],
                           np.repeat(vel[:, None], n, 1)], axis=2)
    noise = cfg["restart_mean_scale"] * rng.standard_normal(
        (requests, per_request, n, 6))
    noise[:, 0] = 0.0
    init = (line[:, None] + noise).reshape(requests * per_request, n, 6)
    return {"start": np.repeat(start, per_request, 0),
            "goal": np.repeat(goal, per_request, 0), "init_mu": init}


def _ends(cfg: dict, inputs: dict) -> list:
    """Every problem's start and goal states ``[P, 6]`` (position and the
    straight line's velocity)."""
    vel = (inputs["goal"] - inputs["start"]) / cfg["total_time"]
    return [np.concatenate([inputs[k], vel], 1) for k in ("start", "goal")]


def build_problem(cfg: dict, inputs: dict, i: int, dtype, device, shared,
                  base=None):
    """Problem ``i``'s graph alone, through the program's public
    constructors; with ``base`` (another problem's graph of the same
    map), its obstacle factor and GP prior, as restarts share them."""
    import torch
    from gaussianvi_tpu_torch.factors.priors import (
        fixed_prior,
        minimum_acc_prior,
    )
    from gaussianvi_tpu_torch.factors.robots import (
        make_point3d_obstacle_factor,
    )
    from gaussianvi_tpu_torch.factors.sdf import SDF3D
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype,
                               device=device)

    n, s = cfg["num_states"], 6
    cov = cfg["anchor_cov"] * np.eye(s)
    anchors = [fixed_prior(k, e[i], cov, dtype=dtype, device=device)
               for k, e in zip((0, n - 1), _ends(cfg, inputs))]
    if base is not None:
        return FactorGraph(num_states=n, state_dim=s,
                           nonlinear=base.nonlinear,
                           linear=(*anchors, base.linear[-1]))
    sdf = SDF3D(t(shared["data"]), t(shared["origin"]), t(shared["cell"]))
    obstacle = make_point3d_obstacle_factor(
        sdf, np.arange(n), state_dim=s, cost_sigma=cfg["cost_sigma"],
        epsilon=cfg["epsilon"], radius=cfg["radius"], slope=cfg["slope"],
        gh_degree=cfg["gh_degree"], interp="auto",
        marginal_quad=cfg["marginal_quad"], dtype=dtype, device=device)
    gp = minimum_acc_prior(cfg["qc"] * np.eye(3),
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

    from ..reference.point3d_sdf import problems

    return problems(cfg, inputs, shared, guard_eps, device,
                    dtype or torch.float64)


def shapes(cfg: dict) -> dict:
    """The problem's shapes for the work counts (``work.py``): one field
    lookup is 55 operations (clip, three divisions, three floors, the
    eight-corner blend, the hinge); per problem its two anchor means;
    shared the anchors' precisions, the GP's [-Phi, I] and Q^-1, the
    field and each factor's eight cost parameters."""
    n, s = cfg["num_states"], 6
    return dict(n=n, s=s, m=len(cfg["rule"]["weights"]),
                dx=cfg["rule"]["dim"], cost=55, own=2 * s,
                shared=2 * s * s + 3 * s * s + cfg["n_cells"] ** 3 + 8 * n,
                factors=2 * n + 1)
