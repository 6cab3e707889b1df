"""The GVI optimization loop: NGD and the proximal optimizer, with the
batched or the sequential backtracking line search, EMA smoothing and
checkpoint / resume.

Counterpart of ``gaussianvi_tpu/inference/optimize.py`` (separate-kernel
and fused paths).  Loop semantics follow the JAX package exactly:

* record (mu, Sigma, Lambda, cost, per-factor costs) at the TOP of each
  iteration;
* trial steps ``step_size_base * step_decay**t``, t = 1..niters_backtrack+1;
  the first trial whose cost decreases is taken (NaN costs compare False).
  ``linesearch="batched"`` evaluates every trial at once;
  ``linesearch="seq"`` evaluates them one after another and stops at the
  first accepted one (a do-while per problem: trial 1 always, then more
  only while the problem is still searching and not converged; the loop
  runs while any problem searches, each problem's values freezing when its
  own search ends, as ``lax.while_loop`` under ``jax.vmap`` does).  Both
  select the same iterate;
* ``ema_alpha`` < 1 blends the accepted proposal with the current iterate,
  ``alpha * new + (1 - alpha) * current``; the accept decision is made on
  the unblended trial cost, and the blended iterate gets a fresh
  covariance and fresh factor costs;
* ``moments_eval_dtype`` (NGD only): every sigma offset is rounded through
  bfloat16 or float16 and back (centered quantization,
  ``factors/moments.py``); prox never quantizes;
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
convergence) is taken per problem.  The batched line-search trials add one
more leading axis, ``[T, B, ...]``, so the chain and quadrature run once
over all T x B trial iterates.  The iterations are a Python loop
(``lax.scan`` in JAX).

Which route each stage takes is the engine's :class:`~.engine.LoopPlan`
(``engine.plan(config, method)``), resolved once a call; an iteration is
the gradient stage, the trial stage of ``plan.trials`` and the selection.
Every trial route gives the same record (cost, log det, untempered factor
costs, and the covariance blocks where it forms them).  The fused
gradient kernel (K6) replaces the gradient quadrature, assembly and
solves and recomputes the iterate's covariance itself; the fused trial
kernel (K5) replaces the trial chain and cost evaluation and forms no
covariance.  The accepted iterate's covariance is the selected trial's
blocks where the route formed them; after K5 it lags with K6 (the
kernel's own blocks are recorded, and the end of :func:`run_gvi_carry`
refreshes them) and is one width-B chain call without it.  Where no
fused kernel covers the chain (s = 14), NGD's batched trials take K1's
trial form (``engine.gbp_trials``): one launch forms every trial's
precision, its covariance and log det and the linear factors' costs, and
only the nonlinear batches run apart, on its covariance blocks.

Under a profiler each call and each of its phases is a named span
(``utils.profiling.span``): ``gvi.optimize`` holding ``gvi.engine``,
``gvi.init``, a ``gvi.iter`` an iteration (``gvi.gradient``,
``gvi.trials``, ``gvi.select``) and ``gvi.finish``.

A run resumes exactly from ``(state, iteration, LoopState)``
(:func:`optimize_from`, ``utils/checkpoint.py``): the covariance, log det
and factor costs are recomputed from the state by :func:`make_gvi_init`,
the same functions of the same inputs as in the uninterrupted run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.blocktridiag import BlockTridiag
from ..ops.precision import set_precision_policy
from ..utils.profiling import span
from .config import GVIConfig
from . import loop_graph
from .engine import LocalEngine, LoopPlan, check_config
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


class LoopState(NamedTuple):
    """The loop-carried values beyond (mu, Lambda), per problem (``[...]``
    over the problem axes): with the state and the iteration index, all a
    run needs to resume exactly."""

    temperature: torch.Tensor
    is_lowtemp: torch.Tensor
    converged: torch.Tensor


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


def _per_problem(value, batch, dtype, device) -> torch.Tensor:
    """A loop scalar, or one value per problem, as a ``batch`` tensor (a
    Python scalar filled on the device: a copy from the host would wait
    for the device, which a CUDA graph's capture forbids)."""
    if isinstance(value, (bool, int, float)):
        return torch.full(batch, value, dtype=dtype, device=device)
    x = torch.as_tensor(value, dtype=dtype, device=device)
    return torch.broadcast_to(x, batch).clone()


def _loop_values(loop: LoopState, batch, dtype, device) -> LoopState:
    """``loop``'s values as per-problem ``batch`` tensors."""
    return LoopState(_per_problem(loop.temperature, batch, dtype, device),
                     _per_problem(loop.is_lowtemp, batch, torch.bool, device),
                     _per_problem(loop.converged, batch, torch.bool, device))


def make_gvi_init(engine: LocalEngine, init_state: GaussianState,
                  config: GVIConfig, plan: LoopPlan,
                  loop: LoopState | None = None) -> _Carry:
    """The initial carry: covariance, logdet and untempered factor costs of
    the initial iterate, and the loop values: a fresh start's, or
    ``loop``'s to resume a run (scalars, as the JAX package writes them,
    apply to every problem)."""
    mu = init_state.mu
    cd, co, ld = engine.cov_logdet(init_state.precision)
    fc = engine.factor_costs_raw(mu, cd, co, plan.eval_dtype)
    if loop is None:
        loop = LoopState(config.temperature, True, False)
    return _Carry(init_state, cd, co, ld, fc,
                  *_loop_values(loop, mu.shape[:-2], mu.dtype, mu.device))


class _Trials(NamedTuple):
    """What a trial route gives for each trial (``[T, ...]``) or for the
    one selected (``[...]``): the cost, the log det, the untempered
    factor costs and the covariance blocks ``(cov_diag, cov_off)``, None
    where the route forms none (K5)."""

    cost: torch.Tensor
    logdet: torch.Tensor
    fc: tuple
    cov: tuple | None


def _each(fn, *trees):
    """``fn`` over the tensors of like trees of tuples (named or not)."""
    head = trees[0]
    if head is None or isinstance(head, torch.Tensor):
        return head if head is None else fn(*trees)
    parts = [_each(fn, *xs) for xs in zip(*trees)]
    return type(head)(*parts) if hasattr(head, "_fields") else tuple(parts)


def make_gvi_step(engine: LocalEngine, config: GVIConfig, plan: LoopPlan):
    """The iteration body ``(carry, i_iter) -> (carry, record)`` of the
    engine's ``plan`` (:meth:`LocalEngine.plan`): the gradient stage, the
    trial stage of ``plan.trials``, the selection."""
    ngd = plan.gradient != "prox"
    n_trials = config.niters_backtrack + 1
    alpha = config.ema_alpha
    eval_dtype = plan.eval_dtype

    def temper(fc_raw, temperature):
        """NGD's costs tempered; prox's never are."""
        if not ngd:
            return fc_raw
        t = temperature[..., None]
        return tuple(f / t for f in fc_raw)

    def gradient(state, cov_diag, cov_off, temperature):
        """``(cov_diag, cov_off, dmu, dprec)``: the direction, and the
        covariance the iteration records (K6's own where it runs)."""
        mu, prec = state.mu, state.precision
        if plan.gradient == "prox":
            return (cov_diag, cov_off, *engine.prox_gradients(
                mu, cov_diag, cov_off, config.step_size_base))
        if plan.gradient == "fused":
            # one kernel: the iterate's covariance, gradients, dprec and
            # both solves
            (cov_diag, cov_off, _, dprec, dmu,
             fallback) = engine.fused_gradient(state, temperature, eval_dtype)
        else:
            vdmu, vddmu = engine.ngd_gradients(mu, cov_diag, cov_off,
                                               temperature, eval_dtype)
            dprec = vddmu - prec
            dmu, fallback = engine.solve_pair(vddmu, prec, -vdmu)
        # an indefinite Vddmu NaNs the Cholesky-based solve: fall back to
        # the current precision (SPD) as the metric, per problem
        dmu = _where(engine.all_finite(dmu), dmu, fallback)
        return cov_diag, cov_off, dmu, dprec

    # ---- the trial routes: (log det, untempered factor costs, covariance
    # blocks or None) of the trials at ``steps`` (``trials [T]`` against
    # the problem axes; one step a problem in the sequential search) ----
    def separate(state, dmu, dprec, trials, steps):
        """The chain and the quadrature over every trial iterate."""
        t_mu = state.mu + steps[..., None, None] * dmu
        t_prec = (state.precision + dprec.scale(steps)).symmetrize()
        t_cd, t_co, t_ld = engine.cov_logdet(t_prec)
        return (t_ld, engine.factor_costs_raw(t_mu, t_cd, t_co, eval_dtype),
                (t_cd, t_co))

    def fused(state, dmu, dprec, trials, steps):
        """K5: every trial in one kernel, no covariance."""
        return (*engine.fused_trial_costs(state, dmu, dprec, trials,
                                          eval_dtype), None)

    def chain(state, dmu, dprec, trials, steps):
        """K1's trial form: every trial's chain and linear costs in one
        launch; the nonlinear batches read its blocks at the trial means."""
        t_cd, t_co, t_ld, t_lin = engine.gbp_trials(state, dmu, dprec,
                                                    trials)
        return t_ld, (*engine.nonlinear_costs_raw(
            state.mu + steps[..., None, None] * dmu, t_cd, t_co, eval_dtype),
            *t_lin), (t_cd, t_co)

    routes = {"separate": separate, "fused": fused, "chain": chain}

    def evaluate(route, state, dmu, dprec, trials, steps, temperature):
        """The :class:`_Trials` of ``route`` at ``steps``."""
        ld, fc, cov = routes[route](state, dmu, dprec, trials, steps)
        return _Trials(engine.reduce_trial_costs(
            ld, temper(fc, temperature)), ld, fc, cov)

    def search(carry, dmu, dprec, trials, cost_iter, temperature):
        """``(selected _Trials, sel, accepted)``: the first decreasing
        trial, or the last one where the search is exhausted."""
        state = carry.state
        if plan.trials != "seq":
            steps = trials.reshape(n_trials, *([1] * (state.mu.ndim - 2)))
            t = evaluate(plan.trials, state, dmu, dprec, trials, steps,
                         temperature)
            ok = t.cost < cost_iter
            accepted = ok.any(0)
            sel = torch.where(accepted, ok.to(trials.dtype).argmax(0),
                              torch.full_like(accepted, n_trials - 1,
                                              dtype=torch.long))
            return _each(lambda x: _pick(x, sel), t), sel, accepted
        # do-while per problem: trial 1 for all, then trial t + 1 while a
        # problem has accepted none, has trials left and has not
        # converged; every problem searching is at the same trial
        batch = cost_iter.shape
        best = evaluate("separate", state, dmu, dprec, None,
                        trials[0].expand(batch), temperature)
        accepted = best.cost < cost_iter
        sel = torch.zeros(batch, dtype=torch.long, device=trials.device)
        for t in range(1, n_trials):
            searching = ~accepted & ~carry.converged
            if not bool(searching.any()):
                break
            now = evaluate("separate", state, dmu, dprec, None,
                           trials[t].expand(batch), temperature)
            best = _each(lambda a, b: _where(searching, a, b), now, best)
            sel = torch.where(searching, t, sel)
            accepted = torch.where(searching, now.cost < cost_iter, accepted)
        return best, sel, accepted

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
        if ngd:
            # trial schedule: base * decay^t, t = 1..niters_backtrack+1
            trials = config.step_size_base * config.step_decay ** powers
        else:
            # the JKO step is taken at base^1; trial schedule base^t
            trials = torch.as_tensor(config.step_size_base, dtype=dtype,
                                     device=device) ** powers
        with span("gvi.gradient"):
            cov_diag, cov_off, dmu, dprec = gradient(
                state, carry.cov_diag, carry.cov_off, temperature)

        # ---- backtracking line search ----
        with span("gvi.trials"):
            picked, sel, accepted = search(carry, dmu, dprec, trials,
                                           cost_iter, temperature)
            step_f = trials[sel]

        with span("gvi.select"):
            # prox adopts the last trial of an exhausted search, unless its
            # cost is non-finite; NGD keeps the old iterate
            take = accepted if ngd else accepted | torch.isfinite(picked.cost)
            # EMA-smoothed proposal alpha * new + (1 - alpha) * current
            # (alpha = 1: plain), accepted on the unblended trial cost above
            acc_mu = _where(take, mu + (alpha * step_f)[..., None, None] * dmu,
                            mu)
            sel_prec = (prec + dprec.scale(step_f)).symmetrize()
            if alpha != 1.0:
                sel_prec = BlockTridiag(
                    alpha * sel_prec.diag + (1.0 - alpha) * prec.diag,
                    alpha * sel_prec.off + (1.0 - alpha) * prec.off)
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
            upd = keep & take
            if alpha != 1.0:
                # the blended iterate is none of the trials: its covariance
                # and factor costs are computed fresh
                new_cd, new_co, new_ld = engine.cov_logdet(new_state.precision)
                new_fc = engine.factor_costs_raw(new_state.mu, new_cd, new_co,
                                                 eval_dtype)
            else:
                # carry the accepted trial's log det + factor costs forward,
                # and its covariance: the trial's blocks where the route
                # formed them; else nothing after K6 (recomputed next
                # iteration), one chain call at the updated state otherwise
                if picked.cov is not None:
                    new_cd = _where(upd, picked.cov[0], cov_diag)
                    new_co = _where(upd, picked.cov[1], cov_off)
                elif plan.gradient == "fused":
                    new_cd, new_co = cov_diag, cov_off
                else:
                    new_cd, new_co, _ = engine.cov_logdet(new_state.precision)
                new_ld = _where(upd, picked.logdet, carry.logdet)
                new_fc = tuple(_where(upd, f, f0)
                               for f, f0 in zip(picked.fc, carry.fc_raw))
            new_carry = _Carry(new_state, new_cd, new_co, new_ld, new_fc,
                               new_temperature, new_is_lowtemp, new_converged)
            record = (
                mu, cov_diag, cov_off, prec.diag, prec.off,
                cost_iter, torch.cat(fc_iter, dim=-1),
                torch.where(accepted, step_f, torch.zeros_like(step_f)),
            )
            return new_carry, record

    return iteration


def _stack_records(records, template, axis: int) -> GVIHistory:
    """The per-iteration records stacked on ``axis`` (after the problem
    axes); an empty window gives zero-length histories of the same
    layout (``template``: a record of the run's shapes)."""
    if records:
        return GVIHistory(*(torch.stack(r, dim=axis)
                            for r in zip(*records)))
    return GVIHistory(*(x.unsqueeze(axis).narrow(axis, 0, 0)
                        for x in template))


def _gvi_loop(engine: LocalEngine, init_state: GaussianState,
              config: GVIConfig, plan: LoopPlan, start_iteration: int,
              loop: LoopState | None, finish):
    """``gvi.init``, iterations ``start_iteration..niters-1`` and
    ``gvi.finish``: ``finish(carry, records, template)`` (``template``: a
    record of the run's shapes), after the final covariance refresh."""
    iteration = make_gvi_step(engine, config, plan)
    with span("gvi.init"):
        carry = make_gvi_init(engine, init_state, config, plan, loop)
        template = (init_state.mu, carry.cov_diag, carry.cov_off,
                    init_state.precision.diag, init_state.precision.off,
                    carry.logdet, torch.cat(carry.fc_raw, dim=-1),
                    carry.temperature)
    records = []
    for i in range(start_iteration, config.niters):
        with span("gvi.iter"):
            carry, record = iteration(carry, i)
        records.append(record)
    with span("gvi.finish"):
        if plan.gradient == "fused":
            carry.cov_diag, carry.cov_off, carry.logdet = engine.cov_logdet(
                carry.state.precision)
        return finish(carry, records, template)


def run_gvi_carry(engine: LocalEngine, init_state: GaussianState,
                  config: GVIConfig, method: str = "ngd",
                  start_iteration: int = 0, loop: LoopState | None = None):
    """The GVI loop over an engine: ``(final carry, GVIHistory)``.

    ``start_iteration`` / ``loop`` resume a run: iterations
    ``start_iteration..niters-1`` run (the scheduled temperature switch
    lands on the same global index), from ``loop``'s values.  On the
    fused-gradient path the carried covariance lags one update; it is
    recomputed here from the final precision, so the returned carry's
    covariance is always that of ``carry.state``."""
    axis = init_state.mu.ndim - 2   # after the problem axes
    return _gvi_loop(engine, init_state, config, engine.plan(config, method),
                     start_iteration, loop,
                     lambda carry, records, template: (
                         carry, _stack_records(records, template, axis)))


def _graph_call(engine: LocalEngine, plan: LoopPlan,
                init_state: GaussianState, config: GVIConfig,
                start_iteration: int, loop: LoopState | None):
    """``(key, tree, starts)`` of a call whose loop may replay as a CUDA
    graph (``loop_graph.run``): one the plan admits (``plan.captured``)
    over a window of at least one iteration; else None.  The tree: the
    initial state, the engine's operands (:meth:`LocalEngine.operands`)
    and ``loop``'s values as device tensors."""
    if not (plan.captured and start_iteration < config.niters):
        return None
    mu = init_state.mu
    if loop is not None:
        loop = _loop_values(loop, mu.shape[:-2], mu.dtype, mu.device)
    operands, starts = engine.operands()
    return ((config, start_iteration, loop is None, plan),
            (init_state, operands, loop), starts)


def _run_call(engine: LocalEngine, init_state: GaussianState,
              config: GVIConfig, method: str, start_iteration: int = 0,
              loop: LoopState | None = None):
    """:func:`run_gvi_carry`, or, for a call on the card that
    :func:`_graph_call` admits, its replay as one CUDA graph
    (``inference/loop_graph.py``): the same bits."""
    def eager():
        return run_gvi_carry(engine, init_state, config, method,
                             start_iteration, loop)

    plan = engine.plan(config, method)
    call = _graph_call(engine, plan, init_state, config, start_iteration,
                       loop)
    if call is None:
        return loop_graph.run(None, None, eager)
    key, tree, starts = call
    axis = init_state.mu.ndim - 2   # after the problem axes

    def region(static):
        state, operands, lp = static
        return _gvi_loop(engine.over(operands), state, config, plan,
                         start_iteration, lp,
                         lambda carry, records, template: (carry, records))

    def finish(out):
        carry, records = out
        return (loop_graph.map_tensors(carry, torch.clone),
                _stack_records(records, None, axis))

    return loop_graph.run(key, tree, eager, region, finish, starts)


def run_gvi(engine: LocalEngine, init_state: GaussianState,
            config: GVIConfig, method: str = "ngd"):
    """The GVI loop over an engine: ``(final state, GVIHistory)``."""
    carry, history = run_gvi_carry(engine, init_state, config, method)
    return carry.state, history


def optimize(graph: FactorGraph, init_state: GaussianState,
             config: GVIConfig = GVIConfig(), method: str = "ngd"):
    """Run the full GVI loop on a (problem-batched) graph; returns the final
    state and iteration history.  Raises ``ValueError`` for an unknown
    option value and for a kernel forced on where it is not eligible (see
    :mod:`.config`)."""
    state, history, _ = optimize_from(graph, init_state, config, method)
    return state, history


def optimize_from(graph: FactorGraph, init_state: GaussianState,
                  config: GVIConfig = GVIConfig(), method: str = "ngd",
                  start_iteration: int = 0,
                  loop_state: LoopState | None = None):
    """:func:`optimize` with checkpoint / resume: runs iterations
    ``start_iteration..niters-1`` from ``loop_state`` (None: a fresh start)
    and also returns the final :class:`LoopState`, which with the state and
    the iteration index is the whole loop state.  A run checkpointed
    mid-trajectory (across a temperature escalation or a convergence freeze
    too) and resumed here follows the uninterrupted trajectory exactly.
    The history covers the resumed window only."""
    with span("gvi.optimize"):
        check_config(config, method)
        set_precision_policy()
        with torch.no_grad():
            with span("gvi.engine"):
                engine = LocalEngine(graph, config, init_state.mu.device)
            carry, history = _run_call(engine, init_state, config, method,
                                       start_iteration, loop_state)
    return carry.state, history, LoopState(carry.temperature,
                                           carry.is_lowtemp, carry.converged)
