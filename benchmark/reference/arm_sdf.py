"""The reference's 7-DOF arm planning problem, from the raw inputs.

N states [theta (7 joint angles); theta_dot (7)], anchors at the start and
the goal (joint velocity the straight line's), the minimum-acceleration GP
prior between consecutive states (``range_chain.gp_prior`` with dim_x =
7), and at every state the collision cost of the arm's spheres against
the signed distance field:

    psi(x) = sum_s sigma * (slope * max(0, eps + r_s - sd(c_s(theta))))^2

with c_s(theta) sphere s's center in the base frame by Denavit-Hartenberg
forward kinematics (frame j = A_0(theta_0) ... A_j(theta_j), A_j =
Rot_z(theta_j + bias_j) Trans_z(d_j) Trans_x(a_j) Rot_x(alpha_j), the
sphere at ``centers[s]`` in frame ``frames[s]``) and sd the trilinear
lookup of ``point3d_sdf.trilinear``, on the frozen marginal rule over the
joint angles (the joint velocities lifted in closed form,
``dense_gvi``).  The kinematics are elementwise products and sums, so no
matrix product enters the cost, and :func:`problems` pins TF32 off for
the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense_gvi import NonlinearGroup, Problems
from .point3d_sdf import trilinear
from .range_chain import anchor, gp_prior


def dh_frames(theta, dh: dict):
    """The base-to-frame transforms ``[..., J, 4, 4]`` at joint angles
    ``theta [..., J]`` for the DH table ``dh`` (tensors ``a``, ``alpha``,
    ``d``, ``theta_bias``)."""
    q = theta + dh["theta_bias"]
    ct, st = torch.cos(q), torch.sin(q)
    ca, sa = torch.cos(dh["alpha"]), torch.sin(dh["alpha"])
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    a, d = dh["a"] + zero, dh["d"] + zero
    rows = [[ct, -st * ca, st * sa, a * ct],
            [st, ct * ca, -ct * sa, a * st],
            [zero, sa + zero, ca + zero, d],
            [zero, zero, zero, one]]
    links = torch.stack([torch.stack(r, -1) for r in rows], -2)  # [..., J, 4, 4]
    out, t = [], None
    for j in range(links.shape[-3]):
        a_j = links[..., j, :, :]
        t = a_j if t is None else (t[..., :, :, None]
                                   * a_j[..., None, :, :]).sum(-2)
        out.append(t)
    return torch.stack(out, -3)


def sphere_centers(theta, dh: dict):
    """Every sphere's center in the base frame, ``[..., S, 3]``."""
    frames = dh_frames(theta, dh)[..., dh["frames"], :, :]   # [..., S, 4, 4]
    local = torch.cat([dh["centers"], torch.ones_like(dh["centers"][:, :1])],
                      -1)                                       # [S, 4]
    return (frames[..., :3, :] * local[:, None, :]).sum(-1)


def problems(cfg: dict, inputs: dict, sdf: dict, guard_eps: float, device,
             dtype=torch.float64) -> Problems:
    """The problems of ``inputs`` (``families/arm_sdf``, one row a
    problem) on the field ``sdf`` ({"data", "origin", "cell"}, numpy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    n, joints = cfg["num_states"], len(cfg["start"])
    s = 2 * joints
    field, origin = t(sdf["data"]), t(sdf["origin"])
    cell = float(sdf["cell"])
    raw = cfg["dh"]
    dh = {k: t(raw[k]) for k in ("a", "alpha", "d", "theta_bias", "centers")}
    dh["frames"] = torch.as_tensor(raw["frames"], device=device)
    radii = t(raw["radii"])
    eps, sigma, slope = cfg["epsilon"], cfg["cost_sigma"], cfg["slope"]

    def cost(pts, params):
        del params
        sd = trilinear(field, origin, cell, sphere_centers(pts, dh))
        err = torch.clamp_min(eps + radii - sd, 0.0) * slope
        return (sigma * err ** 2).sum(-1)

    rule = cfg["rule"]
    obstacle = NonlinearGroup(
        start=torch.arange(n, device=device), nodes=t(rule["nodes"]),
        weights=t(rule["weights"]), cost=cost, params={}, nonneg=True)
    vel = (inputs["goal"] - inputs["start"]) / cfg["total_time"]
    dt = cfg["total_time"] / (n - 1)
    return Problems(n, s, [obstacle], [
        anchor(0, np.concatenate([inputs["start"], vel], 1),
               cfg["anchor_cov"], s, t),
        anchor(n - 1, np.concatenate([inputs["goal"], vel], 1),
               cfg["anchor_cov"], s, t),
        gp_prior(joints, dt, cfg["qc"], n, t)], guard_eps)
