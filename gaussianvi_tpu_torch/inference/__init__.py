"""NGD loop over problem-batched factor graphs."""

from .config import GVIConfig
from .graph import FactorGraph, GaussianState
from .optimize import GVIHistory, optimize

__all__ = ["FactorGraph", "GaussianState", "GVIConfig", "GVIHistory",
           "optimize"]
