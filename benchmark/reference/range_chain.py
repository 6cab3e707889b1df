"""The reference's chain-estimation problem, from the raw inputs alone.

N states [position; velocity] (dim_x each), an anchor at state 0, the
constant-velocity (minimum-acceleration) GP prior between consecutive
states and one range measurement to a beacon a state (Barfoot, Forbes &
Yoon, IJRR 2020):

    psi_range(x) = (r - sqrt(|pos - beacon|^2 + 1e-12))^2 / (2 sigma_r^2)

on the frozen marginal rule over the position.  The GP blocks are worked
out here: Phi = [[I, dt I], [0, I]], Q = [[dt^3/3, dt^2/2], [dt^2/2, dt]]
(x) Qc, the factor C ||[-Phi, I] (x_i, x_i+1)||^2_{Q^-1} with C = 1/2.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense_gvi import LinearGroup, NonlinearGroup, Problems


def range_cost(pts, params):
    d = torch.sqrt(((pts - params["beacon"][:, :, None, :]) ** 2).sum(-1)
                   + 1e-12)
    return (params["r"][..., None] - d) ** 2 / (2.0 * params["sig_sq"][..., None])


def gp_prior(dim_x: int, dt: float, qc: float, num_states: int, t):
    """The GP prior's group over every consecutive pair."""
    s = 2 * dim_x
    eye = np.eye(dim_x)
    phi = np.block([[eye, dt * eye], [np.zeros_like(eye), eye]])
    q = np.block([[dt**3 / 3 * eye, dt**2 / 2 * eye],
                  [dt**2 / 2 * eye, dt * eye]]) * qc
    lam = np.concatenate([-phi, np.eye(s)], axis=1)
    k = num_states - 1
    return LinearGroup(
        start=torch.arange(k, device=t(0.0).device), nb=2,
        lam=t(np.broadcast_to(lam, (1, k, s, 2 * s))),
        psi=t(np.zeros((1, k, s, 1))), target=t(np.zeros((1, k, 1))),
        prec=t(np.broadcast_to(np.linalg.inv(q), (1, k, s, s))),
        const=t(np.full((1, k), 0.5)))


def anchor(state: int, target, cov: float, s: int, t):
    """A Gaussian prior on one state: ``target [P, s]``."""
    return LinearGroup(
        start=torch.tensor([state], device=t(0.0).device), nb=1,
        lam=t(np.eye(s)[None, None]), psi=t(np.eye(s)[None, None]),
        target=t(np.asarray(target)[:, None, :]),
        prec=t((np.eye(s) / cov)[None, None]), const=t(np.ones((1, 1))))


def problems(cfg: dict, inputs: dict, guard_eps: float, device,
             dtype=torch.float64) -> Problems:
    """The problems of ``inputs`` (the arrays of ``families/range_chain``,
    one row a problem)."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    n, dx = cfg["num_states"], cfg["dim_x"]
    s = 2 * dx
    p = inputs["ranges"].shape[0]
    rule = cfg["rule"]
    meas = NonlinearGroup(
        start=torch.arange(n, device=device), nodes=t(rule["nodes"]),
        weights=t(rule["weights"]), cost=range_cost,
        params={"r": t(inputs["ranges"]),
                "beacon": t(np.broadcast_to(cfg["beacon"], (p, n, dx))),
                "sig_sq": t(np.full((p, n), cfg["meas_sigma"] ** 2))},
        nonneg=True)
    anchor_mu = np.concatenate([inputs["x0"], inputs["v0"]], axis=1)
    return Problems(n, s, [meas], [
        anchor(0, anchor_mu, cfg["anchor_cov"], s, t),
        gp_prior(dx, cfg["dt"], cfg["qc"], n, t)], guard_eps)
