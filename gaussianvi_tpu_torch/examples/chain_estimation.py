"""Batch trajectory state estimation on a chain factor graph (the flagship).

Counterpart of ``gaussianvi_tpu/examples/chain_estimation.py``: N states
[position; velocity], a fixed Gaussian anchor at t=0, minimum-acceleration
GP priors between consecutive states, and a nonlinear range measurement per
state.  The arrays are built exactly as the JAX package builds them (same
numpy RNG stream, same float64 construction), and the measurement batch
names the ``"range"`` CUDA cost functor for the kernels and carries the
block form of its cost.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..factors.base import make_nonlinear_batch
from ..factors.priors import fixed_prior, minimum_acc_prior
from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..ops.blocktridiag import BlockTridiag


def range_cost(x, params):
    """psi(x) = (r_meas - |pos - beacon|)^2 / (2 sig_r^2), x = [pos, vel];
    ``x [M, ..., K, d]``, param leaves ``[..., K, *leaf]``."""
    beacon = params["beacon"]
    dim_x = beacon.shape[-1]
    pos = x[..., :dim_x]
    dist = torch.sqrt(torch.sum((pos - beacon) ** 2, dim=-1) + 1e-12)
    return (params["r"] - dist) ** 2 / (2.0 * params["sig_r_sq"])


def range_cost_block(pts, beacon, r, sig_r_sq):
    """Block form of :func:`range_cost` (``pts [..., d]``, batch-dim
    agnostic; the leaves arrive in sorted-key order: beacon, r, sig_r_sq),
    the cost the block-form moments kernel's plain version evaluates."""
    dim_x = beacon.shape[-1]
    pos = pts[..., :dim_x]
    dist = torch.sqrt(torch.sum((pos - beacon) ** 2, dim=-1) + 1e-12)
    return (r - dist) ** 2 / (2.0 * sig_r_sq)


def simulate_trajectory(num_states, dim_x, dt, seed=0):
    """Ground-truth constant-velocity trajectory + noisy range measurements
    (the JAX package's numpy stream, draw for draw)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(1.0, 2.0, dim_x)
    v0 = rng.uniform(0.3, 0.8, dim_x)
    ts = np.arange(num_states) * dt
    pos = x0[None, :] + ts[:, None] * v0[None, :]
    beacon = np.full(dim_x, -1.0)
    sig_r = 0.1
    ranges = np.linalg.norm(pos - beacon, axis=1) + sig_r * rng.standard_normal(
        num_states
    )
    return pos, v0, beacon, ranges, sig_r


def build_chain_estimation(
    num_states: int = 16,
    dim_x: int = 1,
    dt: float = 0.1,
    gh_degree: int = 6,
    seed: int = 0,
    meas_sigma: float | None = None,
    anchor_cov: float = 0.01,
    marginal_quad: bool = True,
    dtype=torch.float64,
    device=None,
):
    """One problem: ``(graph, init_state, config)``.  ``marginal_quad``
    integrates the range factor over the position marginal (29 vs 137
    sigma points at dim_x=2 / degree 4).  ``device=None`` is the card
    (``device.default_device``); ``device="cpu"`` builds CPU tensors."""
    device = resolve_device(device)
    state_dim = 2 * dim_x
    pos, v0, beacon, ranges, sig_r = simulate_trajectory(
        num_states, dim_x, dt, seed
    )
    if meas_sigma is not None:
        sig_r = meas_sigma

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    anchor_mu = np.concatenate([pos[0], v0])
    anchor = fixed_prior(0, anchor_mu, anchor_cov * np.eye(state_dim),
                         dtype=dtype, device=device)
    gp = minimum_acc_prior(np.eye(dim_x), dt, num_states, dtype=dtype,
                           device=device)
    meas = make_nonlinear_batch(
        range_cost,
        np.arange(num_states),
        state_dim=state_dim,
        nb=1,
        params={
            "r": t(ranges),
            "beacon": t(np.broadcast_to(beacon, (num_states, dim_x))),
            "sig_r_sq": t(np.full(num_states, sig_r**2)),
        },
        gh_degree=gh_degree,
        kernel_cost="range",
        block_cost=range_cost_block,
        nonneg_cost=True,   # squared residual: E[phi] >= 0 by construction
        quad_rdim=dim_x if marginal_quad else None,
        dtype=dtype,
        device=device,
    )
    graph = FactorGraph(num_states=num_states, state_dim=state_dim,
                        nonlinear=(meas,), linear=(anchor, gp))
    # initial mean: anchor state replicated; precision: scaled identity
    init = GaussianState(
        t(np.tile(anchor_mu, (num_states, 1))),
        BlockTridiag.identity((), num_states, state_dim, 10.0, dtype, device),
    )
    config = GVIConfig(
        niters=15, niters_lowtemp=15, step_size_base=0.9, niters_backtrack=10
    )
    return graph, init, config


def run_chain_estimation(method: str = "ngd", **kwargs):
    """Build and optimize one problem: ``(final_state, history)``."""
    from ..inference.optimize import optimize

    graph, init, config = build_chain_estimation(**kwargs)
    return optimize(graph, init, config, method=method)
