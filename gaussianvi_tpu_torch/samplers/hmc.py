"""Hamiltonian Monte Carlo with dual-averaging step-size adaptation.

Counterpart of ``gaussianvi_tpu/samplers/hmc.py``: the posterior-validation
baseline for the GVI engines.  JAX runs a chain as one ``lax.scan`` and
several under ``jax.vmap``; here the C chains of :func:`run_chains` are one
batch of ``[C, D]`` tensors on their device, advanced by a Python loop over
transitions, with a step size per chain ``[C]``.  ``log_density`` maps
``theta [..., D] -> [...]``, each value from its own row, so
``torch.autograd.grad(log_density(q).sum(), q)`` is every chain's
gradient.  A position's value and gradient come from one evaluation and
travel with it, so a leapfrog step evaluates the density once (JAX takes
the gradient twice a step and the density again for the Hamiltonians:
the same values).  A transition's randomness is drawn before its dynamics
run (:mod:`._draws`), from the caller's ``torch.Generator`` on the
tensors' device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ._draws import GeneratorDraws


class HMCResult(NamedTuple):
    samples: torch.Tensor       # [num_samples, D] ([C, num_samples, D] from run_chains)
    accept_prob: torch.Tensor   # [num_samples] ([C, num_samples])
    step_size: torch.Tensor     # final adapted step size ([C])


def value_and_grad(log_density, q: torch.Tensor):
    """``(log_density(q) [C], its gradient [C, D])`` of a batch of rows."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        lp = log_density(q)
        (g,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), g


class DualAveraging:
    """Per-chain log step size adapted by dual averaging during warmup
    (Nesterov primal-dual as in Hoffman & Gelman 2014, Alg. 5), then frozen
    at its average; the JAX package's constants and order of operations."""

    GAMMA, T0, KAPPA = 0.05, 10.0, 0.75

    def __init__(self, init_step_size, target_accept, num_warmup, chains,
                 dtype, device):
        self.mu = math.log(10.0 * init_step_size)
        self.target_accept, self.num_warmup = target_accept, num_warmup
        self.log_eps = torch.full((chains,), math.log(init_step_size),
                                  dtype=dtype, device=device)
        self.h_bar = torch.zeros_like(self.log_eps)
        self.log_eps_bar = self.log_eps
        self.m = 0

    def update(self, alpha: torch.Tensor) -> None:
        in_warmup = self.m < self.num_warmup
        self.m += 1
        if not in_warmup:
            self.log_eps = self.log_eps_bar
            return
        mm, t0 = self.m, self.T0
        self.h_bar = ((1.0 - 1.0 / (mm + t0)) * self.h_bar
                      + (self.target_accept - alpha) / (mm + t0))
        self.log_eps = self.mu - math.sqrt(mm) / self.GAMMA * self.h_bar
        eta = mm ** (-self.KAPPA)
        self.log_eps_bar = eta * self.log_eps + (1.0 - eta) * self.log_eps_bar


def hmc_move(log_density, q, lp, g, p0, u, eps, num_steps, inv_mass=1.0):
    """One HMC proposal of every chain from ``q`` (log density ``lp``,
    gradient ``g``) with momenta ``p0``, ``num_steps`` leapfrog steps of
    size ``eps`` (per chain ``[C, 1]``, or one number), and its Metropolis
    decision by the uniforms ``u [C]``: ``(q, lp, g, alpha)`` after it."""
    half, step = 0.5 * eps, eps * inv_mass
    q1, p1, lp1, g1 = q, p0, lp, g
    for _ in range(num_steps):
        p1 = p1 + half * g1
        q1 = q1 + step * p1
        lp1, g1 = value_and_grad(log_density, q1)
        p1 = p1 + half * g1
    h0 = -lp + 0.5 * torch.sum(inv_mass * p0**2, dim=-1)
    h1 = -lp1 + 0.5 * torch.sum(inv_mass * p1**2, dim=-1)
    alpha = torch.exp(torch.clamp(h0 - h1, max=0.0))
    alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
    take = u < alpha
    return (torch.where(take[:, None], q1, q), torch.where(take, lp1, lp),
            torch.where(take[:, None], g1, g), alpha)


def _run_hmc(log_density, init: torch.Tensor, draws, num_samples: int,
             num_warmup: int, num_leapfrog: int, init_step_size: float,
             target_accept: float, inv_mass) -> HMCResult:
    """Adaptive HMC on the chains ``init [C, D]`` with the draws of
    ``draws`` (:mod:`._draws`)."""
    chains, dim = init.shape
    dtype, device = init.dtype, init.device
    inv_mass = torch.as_tensor(inv_mass, dtype=dtype, device=device).expand(dim)
    mass_sqrt = 1.0 / torch.sqrt(inv_mass)
    adapt = DualAveraging(init_step_size, target_accept, num_warmup, chains,
                          dtype, device)
    q = init.detach()
    lp, g = value_and_grad(log_density, q)
    samples = init.new_empty(chains, num_samples, dim)
    accept_prob = init.new_empty(chains, num_samples)
    for m in range(num_warmup + num_samples):
        normal, u = draws.hmc(m)
        q, lp, g, alpha = hmc_move(
            log_density, q, lp, g, normal * mass_sqrt, u,
            torch.exp(adapt.log_eps)[:, None], num_leapfrog, inv_mass)
        adapt.update(alpha)
        if m >= num_warmup:
            samples[:, m - num_warmup] = q
            accept_prob[:, m - num_warmup] = alpha
    return HMCResult(samples, accept_prob, torch.exp(adapt.log_eps))


def run_chains(
    log_density: Callable[[torch.Tensor], torch.Tensor],
    init_positions: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    inv_mass=1.0,
) -> HMCResult:
    """Multi-chain adaptive HMC, the chains one batch on their device:
    ``init_positions [C, D]`` -> samples ``[C, T, D]``, accept
    probabilities ``[C, T]``, step sizes ``[C]``."""
    chains, dim = init_positions.shape
    draws = GeneratorDraws(generator, chains, dim, init_positions.dtype,
                           init_positions.device)
    return _run_hmc(log_density, init_positions, draws, num_samples,
                    num_warmup, num_leapfrog, init_step_size, target_accept,
                    inv_mass)


def hmc(
    log_density: Callable[[torch.Tensor], torch.Tensor],
    init_position: torch.Tensor,
    generator: torch.Generator,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    inv_mass=1.0,
) -> HMCResult:
    """Adaptive HMC on one chain ``init_position [D]``.  Warmup adapts the
    log step size by dual averaging (Hoffman & Gelman 2014, Alg. 5)."""
    res = run_chains(log_density, init_position[None], generator,
                     num_samples, num_warmup, num_leapfrog, init_step_size,
                     target_accept, inv_mass)
    return HMCResult(*(x[0] for x in res))
