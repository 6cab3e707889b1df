"""PyTorch/CUDA port of gaussianvi_tpu for NVIDIA Hopper (H100).

The JAX package ``gaussianvi_tpu`` is the reference; this package mirrors
its layout and module names.  It covers the flagship
(``examples.chain_estimation`` -> ``inference.optimize.optimize``) with the
NGD and proximal optimizers, single-process and over a (dp, fp) mesh of
ranks (``parallel.optimize_sharded``), with a hand-written CUDA kernel
(``kernels/``, ``csrc/``) for every Pallas kernel of the JAX package.
Problems are batched on an explicit leading axis.  Entry points that build
tensors put them on the card (``default_device``) unless the caller asks for
the CPU with ``device="cpu"``.
Imports PyTorch and numpy, never JAX.
"""

from .batching import stack_problems
from .device import default_device
from .inference import FactorGraph, GaussianState, GVIConfig, optimize

__all__ = ["FactorGraph", "GaussianState", "GVIConfig", "default_device",
           "optimize", "stack_problems"]
