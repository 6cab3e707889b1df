"""Optimizer configuration: the JAX package's ``GVIConfig``, same fields
and defaults (``gaussianvi_tpu/inference/config.py``).

What the implementation switches mean in the port:

* ``chain_impl`` / ``quad_impl``: ``"auto"`` runs the CUDA kernels
  (``kernels/chain.py``, ``kernels/quad.py``) for GPU tensors and their
  plain PyTorch versions for CPU tensors; ``"lanes"`` means the kernel and
  raises for CPU tensors; ``"seq"`` (chain) / ``"xla"`` (quadrature) force
  the plain PyTorch versions on any device.  ``chain_impl="assoc"`` is not
  ported.
* ``fused_trials`` / ``fused_gradient``: the fused kernels are not ported
  yet, so ``"auto"`` and ``"off"`` both run the separate kernels and
  ``"on"`` raises ``NotImplementedError``.
* ``linesearch="seq"``, ``ema_alpha != 1``, ``moments_eval_dtype`` and
  ``use_pallas`` raise ``NotImplementedError`` (ROADMAP.md, Queue A).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GVIConfig:
    niters: int = 10
    niters_lowtemp: int = 10
    niters_backtrack: int = 10
    temperature: float = 1.0
    high_temperature: float = 10.0
    step_size_base: float = 0.55
    step_decay: float = 0.75
    stop_err: float = 1e-5
    ema_alpha: float = 1.0
    chain_impl: str = "auto"
    assoc_threshold: int = 1_000_000
    linesearch: str = "batched"
    use_pallas: bool = False
    quad_impl: str = "auto"
    fused_trials: str = "auto"
    fused_gradient: str = "auto"
    moments_eval_dtype: str | None = None
