"""The GVI optimization loop: NGD and the proximal optimizer, with the
batched backtracking line search.

Counterpart of ``gaussianvi_tpu/inference/optimize.py``
(``linesearch="batched"``; separate-kernel and fused paths).  Loop semantics
follow the JAX package exactly:

* record (mu, Sigma, Lambda, cost, per-factor costs) at the TOP of each
  iteration;
* trial steps ``step_size_base * step_decay**t``, t = 1..niters_backtrack+1,
  all evaluated at once; the first trial whose cost decreases is taken
  (NaN costs compare False);
* an exhausted search escalates to the high temperature once, then flags
  convergence; a scheduled switch happens at iteration ``niters_lowtemp``;
* a converged problem's state freezes (later rows repeat it);
* ``method="prox"``: the direction is the Bures-Wasserstein JKO
  pseudo-gradient at step ``step_size_base``, the trial steps are
  ``step_size_base**t``, costs are never tempered, an exhausted search
  takes its last trial unless that trial's cost is non-finite, and there
  is no escalation and no convergence flag.

JAX reaches B problems through ``jax.vmap(optimize)``; here the problem axis
is explicit and leads every tensor (``mu [B, N, s]``, history
``cost [B, niters]``), and every decision (accept, fallback, temperature,
convergence) is taken per problem.  The line-search trials add one more
leading axis, ``[T, B, ...]``, so the chain and quadrature run once over
all T x B trial iterates.  The iterations are a Python loop (``lax.scan``
in JAX).

Where the engine takes the fused kernels, the fused gradient kernel (K6)
replaces the gradient quadrature, assembly and solves and recomputes the
iterate's covariance itself, and the fused trial kernel (K5) replaces the
trial chain and cost evaluation, returning no covariance: with K5 alone
the accepted iterate's covariance is recomputed by one width-B chain call.
With K6 the carried covariance blocks are never read again after an
accepted step (the kernel's own blocks are recorded), so they lag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.blocktridiag import BlockTridiag
from ..ops.precision import set_precision_policy
from .config import GVIConfig
from .engine import LocalEngine, check_config
from .graph import FactorGraph, GaussianState


class GVIHistory(NamedTuple):
    """Per-iteration records, problem axis first."""

    mu: torch.Tensor            # [B, niters, N, s]
    cov_diag: torch.Tensor      # [B, niters, N, s, s]
    cov_off: torch.Tensor       # [B, niters, N-1, s, s]
    prec_diag: torch.Tensor     # [B, niters, N, s, s]
    prec_off: torch.Tensor      # [B, niters, N-1, s, s]
    cost: torch.Tensor          # [B, niters]
    factor_costs: torch.Tensor  # [B, niters, K_total]
    accepted_step: torch.Tensor  # [B, niters]


@dataclass
class _Carry:
    state: GaussianState
    # covariance, logdet and untempered per-factor costs of state, carried
    # so the accepted trial's values are reused, not recomputed (the
    # covariance lags one update on the fused-gradient path, see above)
    cov_diag: torch.Tensor
    cov_off: torch.Tensor
    logdet: torch.Tensor
    fc_raw: tuple
    temperature: torch.Tensor
    is_lowtemp: torch.Tensor
    converged: torch.Tensor


def _bc(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-problem ``cond [...]`` broadcastable against ``x [..., *rest]``."""
    return cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim))


def _where(cond, a, b):
    return torch.where(_bc(cond, a), a, b)


def _pick(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``x [T, *batch, ...]`` -> ``x[sel[b], b]`` for every problem b."""
    idx = sel.reshape(1, *sel.shape, *([1] * (x.ndim - 1 - sel.ndim)))
    return torch.gather(x, 0, idx.expand(1, *x.shape[1:]))[0]


def _temper(fc_raw, temperature):
    t = temperature[..., None]
    return tuple(f / t for f in fc_raw)


def make_gvi_init(engine: LocalEngine, init_state: GaussianState,
                  config: GVIConfig) -> _Carry:
    """The initial carry: covariance, logdet and untempered factor costs of
    the initial iterate, plus the fresh-start loop scalars (per problem)."""
    mu = init_state.mu
    batch = mu.shape[:-2]
    cd, co, ld = engine.cov_logdet(init_state.precision)
    return _Carry(
        init_state, cd, co, ld, engine.factor_costs_raw(mu, cd, co),
        torch.full(batch, config.temperature, dtype=mu.dtype, device=mu.device),
        torch.ones(batch, dtype=torch.bool, device=mu.device),
        torch.zeros(batch, dtype=torch.bool, device=mu.device),
    )


def make_gvi_step(engine: LocalEngine, config: GVIConfig,
                  method: str = "ngd"):
    """The iteration body ``(carry, i_iter) -> (carry, record)`` of
    ``method`` ``"ngd"`` or ``"prox"`` (validated by ``check_config``)."""
    ngd = method == "ngd"
    n_trials = config.niters_backtrack + 1
    # the fused gradient kernel is the NGD step; prox never takes it
    use_fused_grad = ngd and engine.fused_gradient_ready

    def temper(fc_raw, temperature):
        return _temper(fc_raw, temperature) if ngd else fc_raw

    def iteration(carry: _Carry, i_iter: int):
        state = carry.state
        mu, prec = state.mu, state.precision
        dtype, device = mu.dtype, mu.device
        temperature, is_lowtemp = carry.temperature, carry.is_lowtemp
        high = torch.full_like(temperature, config.high_temperature)

        # scheduled high-temperature switch
        if i_iter == config.niters_lowtemp:
            temperature = torch.where(is_lowtemp, high, temperature)
            is_lowtemp = torch.zeros_like(is_lowtemp)

        fc_iter = temper(carry.fc_raw, temperature)
        cost_iter = engine.reduce_fc(fc_iter, carry.logdet) + 0.5 * carry.logdet

        powers = torch.arange(1, n_trials + 1, dtype=dtype, device=device)
        cov_diag, cov_off = carry.cov_diag, carry.cov_off
        if not ngd:
            # the JKO step is taken at base^1; trial schedule base^t
            trials = torch.as_tensor(config.step_size_base, dtype=dtype,
                                     device=device) ** powers
            dmu, dprec = engine.prox_gradients(mu, cov_diag, cov_off,
                                               config.step_size_base)
        else:
            # trial schedule: base * decay^t, t = 1..niters_backtrack+1
            trials = config.step_size_base * config.step_decay ** powers
            if use_fused_grad:
                # one kernel: the iterate's covariance (recorded in place of
                # the carried blocks), gradients, dprec and both solves
                (cov_diag, cov_off, _, dprec, dmu,
                 fallback) = engine.fused_gradient(state, temperature)
            else:
                vdmu, vddmu = engine.ngd_gradients(mu, cov_diag, cov_off,
                                                   temperature)
                dprec = vddmu - prec
                dmu, fallback = engine.solve_pair(vddmu, prec, -vdmu)
            # an indefinite Vddmu NaNs the Cholesky-based solve: fall back to
            # the current precision (SPD) as the metric, per problem
            dmu = _where(engine.all_finite(dmu), dmu, fallback)

        # ---- batched backtracking line search: all trials at once ----
        if engine.fused_trials_ready:
            t_ld, t_fc = engine.fused_trial_costs(state, dmu, dprec, trials)
        else:
            steps = trials.reshape(n_trials, *([1] * (mu.ndim - 2)))
            t_mu = mu + steps[..., None, None] * dmu
            t_prec = (prec + dprec.scale(steps)).symmetrize()
            t_cd, t_co, t_ld = engine.cov_logdet(t_prec)
            t_fc = engine.factor_costs_raw(t_mu, t_cd, t_co)
        trial_costs = engine.reduce_trial_costs(
            t_ld, temper(t_fc, temperature))                  # [T, B]
        ok = trial_costs < cost_iter
        accepted = ok.any(0)
        sel = torch.where(accepted, ok.to(dtype).argmax(0),
                          torch.full_like(accepted, n_trials - 1,
                                          dtype=torch.long))
        step_f = trials[sel]

        # prox adopts the last trial of an exhausted search, unless its
        # cost is non-finite; NGD keeps the old iterate
        take = accepted if ngd else (
            accepted | torch.isfinite(_pick(trial_costs, sel)))
        acc_mu = _where(take, mu + step_f[..., None, None] * dmu, mu)
        sel_prec = (prec + dprec.scale(step_f)).symmetrize()
        acc_prec = BlockTridiag(_where(take, sel_prec.diag, prec.diag),
                                _where(take, sel_prec.off, prec.off))

        # exhausted line search: escalate temperature once, then converge
        # (NGD only: prox neither escalates nor flags convergence)
        failed = ~accepted if ngd else torch.zeros_like(accepted)
        esc_temp = failed & is_lowtemp
        new_temperature = torch.where(esc_temp, high, temperature)
        new_is_lowtemp = is_lowtemp & ~esc_temp
        new_converged = carry.converged | (failed & ~is_lowtemp)

        # freeze the state once converged
        keep = ~carry.converged
        new_state = GaussianState(
            _where(keep, acc_mu, mu),
            BlockTridiag(_where(keep, acc_prec.diag, prec.diag),
                         _where(keep, acc_prec.off, prec.off)),
        )
        # carry the accepted trial's log det + factor costs forward, and its
        # covariance: the separate path's trial blocks, one chain call at the
        # updated state after the fused trial kernel (which returns none),
        # or nothing on the fused-gradient path (recomputed next iteration)
        upd = keep & take
        if not engine.fused_trials_ready:
            new_cd = _where(upd, _pick(t_cd, sel), cov_diag)
            new_co = _where(upd, _pick(t_co, sel), cov_off)
        elif use_fused_grad:
            new_cd, new_co = cov_diag, cov_off
        else:
            new_cd, new_co, _ = engine.cov_logdet(new_state.precision)
        new_carry = _Carry(
            new_state, new_cd, new_co,
            _where(upd, _pick(t_ld, sel), carry.logdet),
            tuple(_where(upd, _pick(f, sel), f0)
                  for f, f0 in zip(t_fc, carry.fc_raw)),
            new_temperature, new_is_lowtemp, new_converged,
        )
        record = (
            mu, cov_diag, cov_off, prec.diag, prec.off,
            cost_iter, torch.cat(fc_iter, dim=-1),
            torch.where(accepted, step_f, torch.zeros_like(step_f)),
        )
        return new_carry, record

    return iteration


def run_gvi(engine: LocalEngine, init_state: GaussianState,
            config: GVIConfig, method: str = "ngd"):
    """The GVI loop over an engine: ``(final state, GVIHistory)``."""
    iteration = make_gvi_step(engine, config, method)
    carry = make_gvi_init(engine, init_state, config)
    records = []
    for i in range(config.niters):
        carry, record = iteration(carry, i)
        records.append(record)
    axis = init_state.mu.ndim - 2   # after the problem axes
    history = GVIHistory(*(torch.stack(r, dim=axis) for r in zip(*records)))
    return carry.state, history


def optimize(graph: FactorGraph, init_state: GaussianState,
             config: GVIConfig = GVIConfig(), method: str = "ngd"):
    """Run the full GVI loop on a (problem-batched) graph; returns the final
    state and iteration history.  Raises ``NotImplementedError`` for the
    options the port does not cover yet and ``ValueError`` for a fused
    kernel forced on where it is not eligible (see :mod:`.config`)."""
    check_config(config, method)
    set_precision_policy()
    with torch.no_grad():
        engine = LocalEngine(graph, config, init_state.mu.device)
        return run_gvi(engine, init_state, config, method)
