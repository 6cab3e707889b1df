"""Where the samplers' randomness comes from.

``jax.random`` streams cannot be reproduced in PyTorch, so each sampler
asks for all of a transition's (or an SMC stage's) randomness as tensors
before its dynamics run, from a draw source with the methods below.  The
samplers' public entry points use :class:`GeneratorDraws`, which fills the
tensors from the caller's ``torch.Generator`` on the tensors' device; a
source that hands over other draws (the JAX package's, in the parity tests)
has the same methods.  ``C`` is the number of chains (SMC: particles),
``D`` the dimension.

* ``hmc(t)``: standard-normal momenta ``[C, D]`` (before the mass scaling)
  and the accept uniforms ``[C]`` of transition ``t``;
* ``nuts_momentum(t)``: standard-normal momenta ``[C, D]``;
* ``nuts_depth(t, depth, count)``: at tree depth ``depth``, the direction
  (bool ``[C]``, True forward), the uniform deciding the subtree's
  proposal (``[C]``) and ``count`` uniforms ``[C, count]``: one per leaf
  (iterative trees, ``2**depth``) or per merge node in post-order
  (unrolled trees, ``2**depth - 1``).  Asked only for depths some chain
  reaches;
* ``smc_stage(stage, moves)``: the resampling uniform (0-d), the mutation
  momenta ``[moves, C, D]`` and accept uniforms ``[moves, C]``.
"""

from __future__ import annotations

import torch


class GeneratorDraws:
    """Draws from ``generator`` (on ``device``), in the order asked."""

    def __init__(self, generator: torch.Generator, chains: int, dim: int,
                 dtype: torch.dtype, device: torch.device):
        self.generator = generator
        self.chains, self.dim = chains, dim
        self.dtype, self.device = dtype, device

    def _normal(self, *shape):
        return torch.randn(shape, generator=self.generator, dtype=self.dtype,
                           device=self.device)

    def _uniform(self, *shape):
        return torch.rand(shape, generator=self.generator, dtype=self.dtype,
                          device=self.device)

    def hmc(self, t):
        return self._normal(self.chains, self.dim), self._uniform(self.chains)

    def nuts_momentum(self, t):
        return self._normal(self.chains, self.dim)

    def nuts_depth(self, t, depth, count):
        return (self._uniform(self.chains) < 0.5, self._uniform(self.chains),
                self._uniform(self.chains, count))

    def smc_stage(self, stage, moves):
        return (self._uniform(), self._normal(moves, self.chains, self.dim),
                self._uniform(moves, self.chains))
