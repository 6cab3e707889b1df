"""PyTorch/CUDA port of gaussianvi_tpu for NVIDIA Hopper (H100).

The JAX package ``gaussianvi_tpu`` is the reference; this package mirrors
its layout and module names.  It covers the flagship NGD path
(``examples.chain_estimation`` -> ``inference.optimize.optimize``) on the
separate-kernel configuration, with hand-written CUDA kernels for the
chain (``kernels/chain.py``) and the sigma-point quadrature
(``kernels/quad.py``).  Problems are batched on an explicit leading axis.
Imports PyTorch and numpy, never JAX.
"""

from .batching import stack_problems
from .inference import FactorGraph, GaussianState, GVIConfig, optimize

__all__ = ["FactorGraph", "GaussianState", "GVIConfig", "optimize",
           "stack_problems"]
