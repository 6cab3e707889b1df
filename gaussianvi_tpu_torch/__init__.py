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
from .factors import LinearFactorBatch, NonlinearFactorBatch, make_nonlinear_batch
from .inference import (
    FactorGraph,
    GaussianState,
    GVIConfig,
    GVIHistory,
    optimize,
)
from .ops import BlockTridiag

__all__ = [
    "FactorGraph", "GaussianState", "GVIConfig", "GVIHistory", "optimize",
    "BlockTridiag",
    "NonlinearFactorBatch", "LinearFactorBatch", "make_nonlinear_batch",
    "default_device", "stack_problems",
]
