"""The reference's 3-D point-robot planning problem, from the raw inputs.

N states [pos3; vel3], anchors at the start and the goal (velocity the
straight line's), the minimum-acceleration GP prior between consecutive
states (``range_chain.gp_prior`` with dim_x = 3), and at every state the
collision cost of one ball at the position against the signed distance
field, read by trilinear interpolation between the grid's cell centres
(coordinates clamped to the grid):

    psi(x) = sigma * (slope * max(0, eps + radius - sd(pos)))^2

on the frozen marginal rule over the position.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense_gvi import NonlinearGroup, Problems
from .range_chain import anchor, gp_prior


def trilinear(field, origin, cell, pts):
    """``field [nz, rows, cols]`` (z, y, x) at ``pts [..., 3]`` (x, y, z)."""
    nz, rows, cols = field.shape
    top = torch.tensor([cols - 1.0, rows - 1.0, nz - 1.0], dtype=pts.dtype,
                       device=pts.device)
    nan = torch.isnan(pts).any(-1)
    u = (torch.minimum(torch.maximum(pts, origin), origin + top * cell)
         - origin) / cell                               # fractional x, y, z
    u = torch.nan_to_num(u)
    lo = torch.floor(u)
    w = u - lo
    lo = lo.long()
    hi = torch.minimum(lo + 1, top.long())
    flat = field.reshape(-1)

    def at(ix, iy, iz):
        return flat[(iz * rows + iy) * cols + ix]

    out = 0.0
    for cx in (0, 1):
        ix = hi[..., 0] if cx else lo[..., 0]
        wx = w[..., 0] if cx else 1 - w[..., 0]
        for cy in (0, 1):
            iy = hi[..., 1] if cy else lo[..., 1]
            wy = w[..., 1] if cy else 1 - w[..., 1]
            for cz in (0, 1):
                iz = hi[..., 2] if cz else lo[..., 2]
                wz = w[..., 2] if cz else 1 - w[..., 2]
                out = out + wx * wy * wz * at(ix, iy, iz)
    return torch.where(nan, torch.full_like(out, float("nan")), out)


def problems(cfg: dict, inputs: dict, sdf: dict, guard_eps: float, device,
             dtype=torch.float64) -> Problems:
    """The problems of ``inputs`` (``families/point3d_sdf``, one row a
    problem) on the field ``sdf`` ({"data", "origin", "cell"}, numpy)."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    n, s = cfg["num_states"], 6
    field, origin = t(sdf["data"]), t(sdf["origin"])
    cell = float(sdf["cell"])
    eps, radius = cfg["epsilon"], cfg["radius"]
    sigma, slope = cfg["cost_sigma"], cfg["slope"]

    def cost(pts, params):
        del params
        sd = trilinear(field, origin, cell, pts)
        return sigma * (slope * torch.clamp_min(eps + radius - sd, 0.0)) ** 2

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
        gp_prior(3, dt, cfg["qc"], n, t)], guard_eps)
