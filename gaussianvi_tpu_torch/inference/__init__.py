"""The GVI loop over problem-batched factor graphs: NGD and the proximal
optimizer, checkpoint / resume, graph validation."""

from .config import GVIConfig
from .graph import FactorGraph, GaussianState, gather_marginals, scatter_gradients
from .gvi import factor_costs, joint_cost, ngd_gradients, prox_gradients
from .optimize import GVIHistory, LoopState, optimize, optimize_from
from .validate import validate_graph

__all__ = [
    "GVIConfig", "FactorGraph", "GaussianState",
    "gather_marginals", "scatter_gradients",
    "factor_costs", "joint_cost", "ngd_gradients", "prox_gradients",
    "optimize", "optimize_from", "GVIHistory", "LoopState",
    "validate_graph",
]
