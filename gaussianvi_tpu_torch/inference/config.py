"""Optimizer configuration: the JAX package's ``GVIConfig``, same fields
and defaults (``gaussianvi_tpu/inference/config.py``).

What the implementation switches mean in the port:

* ``chain_impl`` / ``quad_impl``: ``"auto"`` runs the CUDA kernels
  (``kernels/chain.py``, ``kernels/quad.py``) for GPU tensors where they
  cover the shape and the plain PyTorch versions elsewhere: the chain
  kernels at s in {1, 2, 4, 6, 14}, else the log-depth scans
  (``ops/parallel_chain.py``) where ``num_states >= assoc_threshold``,
  else the sequential sweeps (JAX's ``resolve_chain_impl``, with the card
  in the TPU's place); the quadrature follows the resolved chain (the
  kernel only where the chain is K1 / K2), then per nonlinear batch (a
  batch without a ``kernel_cost`` functor, or spanning two states, takes
  the plain version).  ``"lanes"`` means the kernel and raises for CPU
  tensors and for what it does not cover; ``"seq"`` (chain) / ``"xla"``
  (quadrature) force the plain PyTorch versions on any device;
  ``chain_impl="assoc"`` forces the log-depth scans (Hillis-Steele
  doubling over the state axis, torch ops: JAX runs them on XLA, not in
  a Pallas kernel).
* ``fused_trials`` / ``fused_gradient``: the fused line-search trial
  kernel (``kernels/fused_trials.py``, K5) and the fused gradient kernel
  (``kernels/fused_gradient.py``, K6).  ``"auto"`` takes them where the
  quadrature resolved to its kernels (the JAX package's gate: the
  quadrature alone) and they cover the graph (N >= 2; s in {2, 4}; every
  nonlinear batch nb == 1 with a ``kernel_cost``, one cost for all;
  every linear batch nb <= 2; starts a slice or shared by all problems;
  the rules within shared memory; for the trials,
  ``linesearch="batched"``), i.e. for GPU tensors: the JAX package's
  static choice, so CPU tensors stay on the separate path.  ``"on"``
  asserts that and raises ``ValueError`` where the JAX package does
  (``quad_impl="xla"``, or ``"auto"`` with ``chain_impl`` ``"seq"`` or
  ``"assoc"``, included; ``chain_impl="seq", quad_impl="lanes"``
  builds); on CPU tensors it runs the kernels' plain versions.  ``"off"`` forces the
  separate path.
* ``use_pallas``: the NGD gradient moments of every nonlinear batch that
  has a block form (``block_cost``) go through the block-form moments
  kernel (``kernels/fused_moments.py``, K4) on GPU tensors and through
  its plain version on CPU tensors.  As in the JAX package it has no
  effect where the fused gradient kernel runs (K6 computes the moments
  itself: pass ``fused_gradient="off"``) and none on ``method="prox"``.
  Unlike the JAX package, the route applies the ``quad_rdim`` lift, so it
  agrees with the other routes on a marginal rule.
* ``linesearch``: ``"batched"`` (every trial at once) or ``"seq"`` (one
  trial after another per problem, stopping at the first accepted one;
  the fused trial kernel needs ``"batched"``).  ``ema_alpha`` < 1 blends
  the accepted proposal with the current iterate.
* ``moments_eval_dtype`` (NGD only): ``"bfloat16"`` or ``"float16"``
  rounds every sigma offset through that dtype and back (centered
  quantization).  bfloat16 keeps the quadrature kernels and both fused
  kernels, which round in the kernel; float16 takes the plain quadrature
  and no fused kernel (``"on"`` raises), as in the JAX package.  The
  block-form moments (``use_pallas``) ignore it, as the JAX package's do.

``optimize(..., method="prox")`` runs the proximal (Bures-Wasserstein JKO)
optimizer: the quadrature kernel's moments, the fused trial kernel when
eligible, never the fused gradient kernel.
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
