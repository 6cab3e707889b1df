"""Adaptive-tempering Sequential Monte Carlo with HMC mutations.

Counterpart of ``gaussianvi_tpu/samplers/smc.py``, the second
posterior-validation baseline.  Particles start from a Gaussian reference
(typically the GP-prior part of the graph or the GVI solution itself); the
nonlinear part of the target is annealed in with an ESS-adaptive
temperature ladder; systematic resampling + a few HMC mutation steps per
stage, all particles one batch on their device.  The stage loop asks the
host once a stage whether to go on (``lam < 1`` and stages left); the
bisection for each increment stays on the device.  ``log_reference`` and
``log_target_delta`` map ``x [P, D] -> [P]``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ._draws import GeneratorDraws
from .hmc import hmc_move, value_and_grad


class SMCResult(NamedTuple):
    particles: torch.Tensor       # [P, D]
    weights: torch.Tensor         # [P] normalized
    log_evidence: torch.Tensor    # log Z estimate (up to reference const)
    num_stages: torch.Tensor


def _systematic_resample(u, weights, particles):
    """Systematic resampling with the uniform ``u`` (0-d)."""
    p = weights.shape[0]
    positions = (u + torch.arange(p, dtype=weights.dtype,
                                  device=weights.device)) / p
    idx = torch.searchsorted(torch.cumsum(weights, dim=0), positions)
    return particles[torch.clamp(idx, 0, p - 1)]


def _hmc_mutate(particles, log_target, step_size, num_steps, momenta,
                accept_u):
    """``momenta.shape[0]`` HMC moves of every particle at a fixed step
    size, with the momenta ``[moves, P, D]`` and accept uniforms
    ``[moves, P]``."""
    q = particles
    lp, g = value_and_grad(log_target, q)
    for p0, u in zip(momenta, accept_u):
        q, lp, g, _ = hmc_move(log_target, q, lp, g, p0, u, step_size,
                               num_steps)
    return q


def _run_smc(log_reference, log_target_delta, init_particles, draws,
             ess_threshold, mutation_step_size, mutation_steps,
             mutations_per_stage, max_stages) -> SMCResult:
    """Adaptive SMC with the draws of ``draws`` (:mod:`._draws`)."""
    particles = init_particles
    p = particles.shape[0]
    log_z = particles.new_zeros(())
    lam = particles.new_zeros(())
    n = 0
    while n < max_stages and bool(lam < 1.0):
        u_res, momenta, accept_u = draws.smc_stage(n, mutations_per_stage)
        deltas = log_target_delta(particles)

        # bisect the largest d_lam with ESS >= threshold
        def ess_at(d_lam):
            logw = d_lam * deltas
            logw = logw - torch.max(logw)
            w = torch.exp(logw)
            w = w / torch.sum(w)
            return 1.0 / torch.sum(w**2)

        lo, hi = torch.zeros_like(lam), 1.0 - lam
        for _ in range(20):
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= ess_threshold * p
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        d_lam = torch.where(ess_at(1.0 - lam) >= ess_threshold * p,
                            1.0 - lam, lo)
        d_lam = torch.clamp(d_lam, min=1e-4)
        d_lam = torch.minimum(d_lam, 1.0 - lam)

        logw = d_lam * deltas
        log_z = log_z + torch.logsumexp(logw, dim=0) - math.log(p)
        w = torch.exp(logw - torch.max(logw))
        w = w / torch.sum(w)

        particles = _systematic_resample(u_res, w, particles)
        lam = lam + d_lam

        def log_tempered(x, lam=lam):
            return log_reference(x) + lam * log_target_delta(x)

        particles = _hmc_mutate(particles, log_tempered, mutation_step_size,
                                mutation_steps, momenta, accept_u)
        n += 1
    weights = torch.full((p,), 1.0 / p, dtype=particles.dtype,
                         device=particles.device)
    return SMCResult(particles, weights, log_z,
                     torch.tensor(n, device=particles.device))


def smc_adaptive(
    log_reference: Callable[[torch.Tensor], torch.Tensor],
    log_target_delta: Callable[[torch.Tensor], torch.Tensor],
    init_particles: torch.Tensor,
    generator: torch.Generator,
    num_particles: int = 512,
    ess_threshold: float = 0.5,
    mutation_step_size: float = 0.1,
    mutation_steps: int = 8,
    mutations_per_stage: int = 2,
    max_stages: int = 50,
) -> SMCResult:
    """Anneal from ``log_reference`` to ``log_reference + log_target_delta``
    via lambda in [0, 1], choosing each increment by bisection so the stage
    ESS stays at ``ess_threshold * P`` (P = ``init_particles.shape[0]``;
    ``num_particles`` is not read, as in the JAX package)."""
    p, dim = init_particles.shape
    draws = GeneratorDraws(generator, p, dim, init_particles.dtype,
                           init_particles.device)
    return _run_smc(log_reference, log_target_delta, init_particles, draws,
                    ess_threshold, mutation_step_size, mutation_steps,
                    mutations_per_stage, max_stages)
