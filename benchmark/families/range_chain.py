"""Chain estimation: inputs drawn from the seed, the program's problem
built from them, and the reference's.

A problem is one vehicle's trajectory of N states [position; velocity]
with a range to a fixed beacon measured at every state (the flagship
example's simulation, one trajectory a problem): x0 ~ U(x0_range),
v0 ~ U(v0_range) per axis, positions x0 + t v0, ranges |pos - beacon| +
sigma_r n with n ~ N(0, 1).  The anchor is the true initial state; the
initial iterate is the anchor at every state with precision
``init_prec_scale`` I.  A request is one problem.
"""

from __future__ import annotations

import numpy as np

from . import batch_graph


def make_inputs(cfg: dict, rng: np.random.Generator, requests: int,
                per_request: int) -> dict:
    """The raw arrays of ``requests`` problems, one row each."""
    if per_request != 1:
        raise ValueError("chain estimation takes one problem a request")
    n, dx = cfg["num_states"], cfg["dim_x"]
    x0 = rng.uniform(*cfg["x0_range"], size=(requests, dx))
    v0 = rng.uniform(*cfg["v0_range"], size=(requests, dx))
    noise = rng.standard_normal((requests, n))
    ts = np.arange(n) * cfg["dt"]
    pos = x0[:, None, :] + ts[None, :, None] * v0[:, None, :]
    ranges = (np.linalg.norm(pos - np.asarray(cfg["beacon"]), axis=-1)
              + cfg["meas_sigma"] * noise)
    anchor = np.concatenate([x0, v0], axis=1)
    return {"x0": x0, "v0": v0, "ranges": ranges,
            "init_mu": np.repeat(anchor[:, None, :], n, axis=1)}


def _params(cfg: dict, inputs: dict) -> dict:
    """The range factors' parameters of every problem, ``[P, N, ...]``."""
    b, n = inputs["ranges"].shape
    return {"r": inputs["ranges"],
            "beacon": np.broadcast_to(cfg["beacon"], (b, n, cfg["dim_x"])),
            "sig_r_sq": np.full((b, n), cfg["meas_sigma"] ** 2)}


def build_problem(cfg: dict, inputs: dict, i: int, dtype, device,
                  shared=None, base=None):
    """Problem ``i``'s graph alone, through the program's public
    constructors; with ``base`` (another problem's graph), its GP
    prior."""
    from gaussianvi_tpu_torch.convert import graph_from_arrays
    from gaussianvi_tpu_torch.factors.priors import (
        fixed_prior,
        minimum_acc_prior,
    )
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    n, dx = cfg["num_states"], cfg["dim_x"]
    s = 2 * dx
    rule = cfg["rule"]
    nodes = np.zeros((len(rule["nodes"]), s))
    nodes[:, :dx] = rule["nodes"]
    desc = {"num_states": n, "state_dim": s, "linear": [], "nonlinear": [{
        "start": np.arange(n), "nodes": nodes, "weights": rule["weights"],
        "params": {k: v[i] for k, v in _params(cfg, inputs).items()},
        "nb": 1, "slice_offset": 0, "nonneg_cost": True,
        "quad_rdim": dx if cfg["marginal_quad"] else None,
        "shared_start": True, "cost": "range", "block_cost": True}]}
    meas = graph_from_arrays(desc, dtype=dtype, device=device).nonlinear[0]
    anchor_mu = np.concatenate([inputs["x0"][i], inputs["v0"][i]])
    anchor = fixed_prior(0, anchor_mu, cfg["anchor_cov"] * np.eye(s),
                         dtype=dtype, device=device)
    gp = (base.linear[1] if base is not None else minimum_acc_prior(
        cfg["qc"] * np.eye(dx), cfg["dt"], n, dtype=dtype, device=device))
    return FactorGraph(num_states=n, state_dim=s, nonlinear=(meas,),
                       linear=(anchor, gp))


def build_program(cfg: dict, inputs: dict, dtype, device, shared=None):
    """The program's graph of every problem of ``inputs``: problem 0's
    graph (``build_problem``) given every problem's own leaves."""
    import torch
    from gaussianvi_tpu_torch.factors.base import pack_params

    b, n = inputs["ranges"].shape

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype,
                               device=device)

    leaves = {k: t(v) for k, v in _params(cfg, inputs).items()}
    flat = pack_params({k: v.reshape(b * n, *v.shape[2:])
                        for k, v in leaves.items()})
    anchor_mu = np.concatenate([inputs["x0"], inputs["v0"]], axis=1)
    return batch_graph(build_problem(cfg, inputs, 0, dtype, device), b, {
        ("nonlinear", 0, "params"): leaves,
        ("nonlinear", 0, "kernel_params"): flat.reshape(b, n, -1),
        ("linear", 0, "target_mu"): t(anchor_mu[:, None, :]),
    })


def build_reference(cfg, inputs, guard_eps, device, shared=None,
                    dtype=None):
    import torch

    from ..reference.range_chain import problems

    return problems(cfg, inputs, guard_eps, device, dtype or torch.float64)


def make_shared(cfg: dict) -> None:
    """Inputs shared by every problem of the configuration: none."""
    return None


def shapes(cfg: dict) -> dict:
    """The problem's shapes for the work counts (``work.py``): per problem
    its own range parameters (beacon, range, variance a state) and anchor
    mean; shared the anchor's precision and the GP's [-Phi, I] and Q^-1."""
    n, s = cfg["num_states"], 2 * cfg["dim_x"]
    return dict(n=n, s=s, m=len(cfg["rule"]["weights"]),
                dx=cfg["rule"]["dim"], cost=3 * cfg["dim_x"] + 8,
                own=n * (cfg["dim_x"] + 2) + s, shared=s * s + 3 * s * s,
                factors=2 * n)
