"""Parallel restarts: batched multi-initialization GVI with best-of
selection.

Counterpart of ``gaussianvi_tpu/parallel/restarts.py``.  GVI converges to
a local KL optimum, so a planner runs R randomized initializations at once
and keeps the lowest-cost posterior.  Here the R restarts are one
problem-batched ``optimize`` call.  The noise comes from an explicit
``torch.Generator`` (the JAX package takes a PRNG key; the two give
different numbers from the same seed), and the selection,
:func:`best_of_restarts`, is a plain function of given initial states.
"""

from __future__ import annotations

from dataclasses import fields, replace

import torch

from ..inference.config import GVIConfig
from ..inference.graph import FactorGraph, GaussianState
from ..inference.gvi import joint_cost
from ..inference.optimize import optimize
from ..ops.blocktridiag import BlockTridiag


def perturb_inits(init: GaussianState, generator: torch.Generator,
                  num_restarts: int, mean_scale: float = 1.0) -> GaussianState:
    """R randomized initial states of one problem (``init.mu [N, s]``):
    the mean jittered, the precision shared; restart 0 keeps the nominal
    mean."""
    noise = mean_scale * torch.randn(
        (num_restarts, *init.mu.shape), generator=generator,
        dtype=init.mu.dtype, device=generator.device).to(init.mu.device)
    noise[0] = 0.0
    prec = init.precision
    return GaussianState(init.mu + noise, BlockTridiag(
        prec.diag.expand(num_restarts, *prec.diag.shape).clone(),
        prec.off.expand(num_restarts, *prec.off.shape).clone()))


def _batch_graph(graph: FactorGraph, num_restarts: int) -> FactorGraph:
    """One problem's graph with a leading restart axis on its per-problem
    data (views: every restart reads the same factors)."""
    def rep(x):
        return x.expand(num_restarts, *x.shape)

    nonlinear = tuple(replace(
        fb,
        params=(None if fb.params is None
                else {k: rep(v) for k, v in fb.params.items()}),
        kernel_params=(None if fb.kernel_params is None
                       else rep(fb.kernel_params)),
    ) for fb in graph.nonlinear)
    data = ("lam", "psi", "target_mu", "target_prec", "constant")
    linear = tuple(replace(lb, **{f.name: rep(getattr(lb, f.name))
                                  for f in fields(lb) if f.name in data})
                   for lb in graph.linear)
    return replace(graph, nonlinear=nonlinear, linear=linear)


def best_of_restarts(graph: FactorGraph, inits: GaussianState,
                     config: GVIConfig = GVIConfig(), method: str = "ngd"):
    """Optimize one problem from each of the R initial states
    (``inits.mu [R, N, s]``) in one batched run: ``(best_state, best_cost,
    all_final_costs [R])``, the costs at ``config.temperature`` (untempered
    for ``method="prox"``)."""
    r = inits.mu.shape[0]
    graph_b = _batch_graph(graph, r)
    finals, _ = optimize(graph_b, inits, config, method)
    with torch.no_grad():
        costs = joint_cost(graph_b, finals.mu, finals.precision,
                           config.temperature, temper_costs=method == "ngd")
    best = int(torch.argmin(costs))
    prec = finals.precision
    best_state = GaussianState(finals.mu[best],
                               BlockTridiag(prec.diag[best], prec.off[best]))
    return best_state, costs[best], costs


def optimize_restarts(graph: FactorGraph, init: GaussianState,
                      generator: torch.Generator, num_restarts: int = 8,
                      config: GVIConfig = GVIConfig(), method: str = "ngd",
                      mean_scale: float = 1.0):
    """Run R restarts of one problem in one batched computation; returns
    ``(best_state, best_cost, all_final_costs)``."""
    inits = perturb_inits(init, generator, num_restarts, mean_scale)
    return best_of_restarts(graph, inits, config, method)
