"""Pointwise joint density of a factor graph.

Counterpart of ``gaussianvi_tpu/samplers/target.py``.  GVI minimizes
KL[q || p] with p(X|Z) ∝ exp(-sum_k psi_k(x_k)); the samplers (HMC/NUTS/SMC)
operate on the same factorized target evaluated POINTWISE (no quadrature):
psi(x) = sum over factor batches of psi_k at the gathered local states.
JAX evaluates one point and vmaps over chains; here the points carry any
leading axes (chains, particles) before the state axis, which the factors'
``cost_fn(pts [..., K, d], params)`` already takes.  One problem per graph,
as in JAX; the tensors follow the graph's device.
"""

from __future__ import annotations

import torch

from ..inference.graph import FactorGraph, take_states


def _gather_local(x: torch.Tensor, fb) -> torch.Tensor:
    """x [..., N, s] -> local supports [..., K, nb*s]."""
    if fb.nb == 1:
        return take_states(x, fb.start, fb.slice_offset, 1)
    if fb.nb == 2:
        return torch.cat([take_states(x, fb.start, fb.slice_offset, 1),
                          take_states(x, fb.start, fb.slice_offset, 1, 1)],
                         dim=-1)
    raise NotImplementedError(f"nb={fb.nb}")


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a [K, r, d] @ v [..., K, d] -> [..., K, r]``."""
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _check_one_problem(graph: FactorGraph) -> None:
    stacked = (
        any(fb.start.ndim != 1 or (fb.kernel_params is not None
                                   and fb.kernel_params.ndim != 2)
            for fb in graph.nonlinear)
        or any(lb.start.ndim != 1 or lb.lam.ndim != 3 for lb in graph.linear))
    if stacked:
        raise ValueError("the samplers take one problem per graph, not a "
                         "stacked [B, ...] batch (stack_problems)")


def neg_log_prob(graph: FactorGraph, x: torch.Tensor) -> torch.Tensor:
    """psi(x) = -log p(x|Z) + const for x [..., N, s] -> [...]."""
    _check_one_problem(graph)
    total = x.new_zeros(x.shape[:-2])
    for fb in graph.nonlinear:
        x_k = _gather_local(x, fb)
        vals = fb.cost_fn(x_k, fb.params)
        if vals.shape != x_k.shape[:-1]:
            raise ValueError(f"cost_fn gave {tuple(vals.shape)} for points "
                             f"{tuple(x_k.shape)}: one problem per graph")
        total = total + torch.sum(vals, dim=-1)
    for lb in graph.linear:
        x_k = _gather_local(x, lb)
        resid = (_matvec(lb.lam, x_k) - _matvec(lb.psi, lb.target_mu))
        quad = torch.sum(resid * _matvec(lb.target_prec, resid), dim=-1)
        total = total + torch.sum(quad * lb.constant, dim=-1)
    return total


def make_log_density(graph: FactorGraph, num_states: int, state_dim: int):
    """Flat-vector log-density callable for the samplers:
    ``theta [..., num_states * state_dim] -> [...]``."""

    def log_density(theta: torch.Tensor) -> torch.Tensor:
        x = theta.reshape(*theta.shape[:-1], num_states, state_dim)
        return -neg_log_prob(graph, x)

    return log_density
