"""PyTorch/CUDA port of gaussianvi_tpu for NVIDIA Hopper (H100).

The JAX package ``gaussianvi_tpu`` is the reference; this package mirrors
its layout and module names.  It covers the flagship
(``examples.chain_estimation`` -> ``inference.optimize.optimize``) with the
NGD and proximal optimizers, single-process and over a (dp, fp) mesh of
ranks (``parallel.optimize_sharded``), with a hand-written CUDA kernel
(``kernels/``, ``csrc/``) for every Pallas kernel of the JAX package.
Problems are batched on an explicit leading axis.
Imports PyTorch and numpy, never JAX.
"""

from .batching import stack_problems
from .inference import FactorGraph, GaussianState, GVIConfig, optimize

__all__ = ["FactorGraph", "GaussianState", "GVIConfig", "optimize",
           "stack_problems"]
