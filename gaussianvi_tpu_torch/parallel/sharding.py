"""SPMD execution of the GVI loop over a (dp, fp) mesh of ranks.

Counterpart of ``gaussianvi_tpu/parallel/sharding.py``:

* ``dp``: data parallel over independent problems; a rank holds the block
  of problems of its dp row, and nothing crosses rows;
* ``fp``: factor parallel; each rank of a row evaluates the sigma-point
  quadrature of its shard of every nonlinear factor batch, and the joint
  (Vdmu, Vddmu) and the nonlinear cost are summed over the row with one
  all-reduce each.  The chain (covariance, log det, solves) and the
  closed-form linear factors are cheap and computed by every rank.

JAX shards arrays over a device mesh inside one program (``shard_map``);
here every rank is a process that is handed the same global batch, keeps
its own shard (:func:`shard_graph`, :func:`shard_state`) and runs the
single-device loop (``inference.optimize.run_gvi``) through
:class:`FactorShardEngine`, so the loop semantics hold sharded.  Every rank
of a row takes the same line-search decisions because it compares the same
all-reduced costs; :func:`optimize_sharded` checks that they did.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..inference import gvi
from ..inference.config import GVIConfig
from ..inference.engine import LocalEngine, check_config, fold, unfold
from ..inference.graph import FactorGraph, GaussianState
from ..inference.optimize import GVIHistory, run_gvi
from ..kernels.fused_gradient import (
    gradient_accum_lanes,
    gradient_solve_lanes,
)
from ..ops.blocktridiag import BlockTridiag
from ..ops.precision import set_precision_policy
from .collective import Mesh


def _block(x: torch.Tensor, dim: int, index: int, count: int, what: str):
    """Block ``index`` of ``count`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % count:
        raise ValueError(f"{what}: {size} does not divide over {count} ranks")
    return x.narrow(dim, index * (size // count), size // count)


def shard_graph(graph_b: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's part of a problem-batched graph: its dp block of the
    problems, and of every nonlinear batch its fp shard of the factor axis
    K (start indices, params); rules and linear batches whole.  A sharded
    batch loses its ``slice_offset`` (valid for the whole K axis only).
    Raises ``ValueError`` where B does not divide over dp or K over fp."""
    dp, fp = mesh.dp, mesh.fp
    i_dp, i_fp = mesh.dp_index, mesh.fp_index

    def problems(x):
        return _block(x, 0, i_dp, dp, "problems")

    def factors(x, dim):
        return _block(x, dim, i_fp, fp, "nonlinear factors")

    nonlinear = []
    for fb in graph_b.nonlinear:
        start = fb.start if fb.start.ndim == 1 else problems(fb.start)
        new = dict(
            start=factors(start, -1),
            params=(None if fb.params is None else
                    {k: factors(problems(v), 1)
                     for k, v in fb.params.items()}),
            kernel_params=(None if fb.kernel_params is None else
                           factors(problems(fb.kernel_params), 1)),
        )
        if fp > 1:
            new["slice_offset"] = None
        nonlinear.append(replace(fb, **new))
    linear = []
    for lb in graph_b.linear:
        linear.append(replace(
            lb,
            start=lb.start if lb.start.ndim == 1 else problems(lb.start),
            **{name: problems(getattr(lb, name)) for name in (
                "lam", "psi", "target_mu", "target_prec", "constant")},
        ))
    return replace(graph_b, nonlinear=tuple(nonlinear), linear=tuple(linear))


def shard_state(state_b: GaussianState, mesh: Mesh) -> GaussianState:
    """This rank's dp block of a problem-batched state."""
    def problems(x):
        return _block(x, 0, mesh.dp_index, mesh.dp, "problems")

    return GaussianState(problems(state_b.mu), BlockTridiag(
        problems(state_b.precision.diag), problems(state_b.precision.off)))


class FactorShardEngine(LocalEngine):
    """Engine hooks with the nonlinear-factor axis sharded over ``fp``.

    The graph is this rank's shard (:func:`shard_graph`).  Only the
    quadrature is sharded: the joint (Vdmu, Vddmu) and the total nonlinear
    cost are assembled with one all-reduce over the fp group; the chain
    and the linear factors are computed by every rank.  With fp >= 2 the
    fused gradient step is the split pair (K6 ``"accum"`` on the shard, the
    all-reduce, K6 ``"solve"``); with fp == 1 it is the single kernel and
    the sums over fp are no-ops.  The block-form moments (``use_pallas``)
    are never taken, as in the JAX package."""

    # its plan: never captured (the mesh's collectives run from the host),
    # K6 in the modes of gradient_modes
    captures = False

    def __init__(self, graph: FactorGraph, config, device: torch.device,
                 mesh: Mesh):
        self.mesh = mesh
        super().__init__(graph, replace(config, use_pallas=False), device)

    @property
    def gradient_modes(self):
        """K6's split pair where fp >= 2, else the single kernel."""
        return ("accum", "solve") if self.mesh.fp > 1 else ("full",)

    def reduce_fc(self, fc_tuple, like):
        """The sharded (nonlinear) batches summed over fp, the linear ones
        added by every rank.  ``reduce_trial_costs`` comes through here
        too: the log det and the linear costs are every rank's own, only
        the shard's nonlinear sums travel."""
        n_nl = len(self.graph.nonlinear)
        total = torch.zeros_like(like)
        for f in fc_tuple[:n_nl]:
            total = total + f.sum(-1)
        if n_nl:
            total = self.mesh.psum_(total)
        for f in fc_tuple[n_nl:]:
            total = total + f.sum(-1)
        return total

    def ngd_gradients(self, mu, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        g = self.graph
        vdmu, vddmu = gvi.ngd_gradients(
            replace(g, linear=()), mu, cov_diag, cov_off, temperature,
            False, self.quad_batches, eval_dtype=eval_dtype)
        vdmu, diag, off = self.mesh.psum(vdmu, vddmu.diag, vddmu.off)
        return gvi.ngd_gradients(
            replace(g, nonlinear=()), mu, cov_diag, cov_off, temperature,
            onto=(vdmu, BlockTridiag(diag, off)))

    def prox_gradients(self, mu, cov_diag, cov_off, step_size):
        g = self.graph
        dmu, dprec = gvi.prox_gradients(
            replace(g, linear=()), mu, cov_diag, cov_off, step_size,
            self.quad_batches)
        dmu, diag, off = self.mesh.psum(dmu, dprec.diag, dprec.off)
        dmu_l, dprec_l = gvi.prox_gradients(
            replace(g, nonlinear=()), mu, cov_diag, cov_off, step_size)
        return dmu + dmu_l, BlockTridiag(diag, off) + dprec_l

    def fused_gradient(self, state: GaussianState, temperature,
                       eval_dtype=None):
        if self.mesh.fp == 1:
            return super().fused_gradient(state, temperature, eval_dtype)
        batch, prec = state.mu.shape[:-2], state.precision
        x = (*(fold(t, batch) for t in (state.mu, prec.diag, prec.off)),
             temperature.reshape(-1))
        nl_specs, nl = self._flat_nonlinear(batch, state.mu)
        lin_specs, lin = self._flat_linear(batch)
        partials = gradient_accum_lanes(*x, nl_specs, nl,
                                        eval_dtype=eval_dtype)
        # the one all-reduce of the step: Vdmu and both parts of Vddmu are
        # views of partials.buffer
        self.mesh.psum_(partials.buffer)
        out = gradient_solve_lanes(*x, partials, lin_specs, lin)
        cd, co, ld, dpd, dpo, dmu, dfb = (unfold(t, batch) for t in out)
        return cd, co, ld, BlockTridiag(dpd, dpo), dmu, dfb


def _check_batched(graph_b: FactorGraph, b: int) -> None:
    """Raise where a factor batch's per-problem data lacks the leading
    problem axis of ``b`` problems (``shard_graph`` would shard the wrong
    axis): a single problem's graph goes through ``stack_problems``, or
    ``parallel.restarts`` for restarts of one problem."""
    def batched(x, k):
        return x.ndim >= 2 and tuple(x.shape[:2]) == (b, k)

    ok = all(batched(x, fb.num_factors) for fb in graph_b.nonlinear
             for x in (*(fb.params or {}).values(),
                       *(() if fb.kernel_params is None
                         else (fb.kernel_params,))))
    ok = ok and all(lb.lam.ndim == 4 and lb.lam.shape[0] == b
                    for lb in graph_b.linear)
    if not ok:
        raise ValueError(
            f"optimize_sharded takes a problem-batched graph (per-factor "
            f"data [B={b}, K, ...], stack_problems), got a factor batch "
            "without the problem axis")


def _gather_factor_costs(hist: GVIHistory, graph_loc: FactorGraph,
                         mesh: Mesh) -> GVIHistory:
    """The history with every nonlinear batch's K axis reassembled over fp
    (global factor order); the linear batches are every rank's own."""
    if mesh.fp == 1:
        return hist
    sizes = [b.num_factors for b in (*graph_loc.nonlinear, *graph_loc.linear)]
    parts = list(hist.factor_costs.split(sizes, dim=-1))
    for j in range(len(graph_loc.nonlinear)):
        parts[j] = mesh.all_gather_cat(parts[j], dim=-1)
    return hist._replace(factor_costs=torch.cat(parts, dim=-1))


def _check_lockstep(mesh: Mesh, state: GaussianState, hist: GVIHistory):
    """Every rank of an fp row must hold the same run: raise on all of
    them together where one took another decision or ended elsewhere."""
    checks = (("accepted steps", hist.accepted_step),
              ("final mean", state.mu),
              ("final precision", state.precision.diag))
    for what, x in checks:
        if mesh.differs(x):
            raise RuntimeError(
                f"optimize_sharded: the ranks of fp row {mesh.dp_index} "
                f"disagree on the {what}: they did not run in lockstep "
                "(were they handed the same global batch?)")


def optimize_sharded(graph_b: FactorGraph, state_b: GaussianState,
                     config: GVIConfig, mesh: Mesh, method: str = "ngd"):
    """The full GVI loop (the semantics of ``optimize``), SPMD over
    (dp, fp).  Every rank of the mesh calls it with the same global batch
    (``graph_b`` / ``state_b`` with the leading problem axis, on the rank's
    own device) and gets back the final state and history of its dp block
    of problems, with the per-factor costs in global factor order.
    Trajectories match ``optimize`` up to the reassociation of the sums
    over fp, with every option of the loop: ``linesearch="seq"`` (each
    further trial is decided on the all-reduced trial costs, so every rank
    of a row takes the same branch and issues the same all-reduces),
    ``ema_alpha`` and ``moments_eval_dtype`` (bfloat16 rounded in K6
    ``accum`` and K5 where they run, float16 on the plain quadrature).
    ``"auto"`` implementations go by the tensors' device, as in
    ``optimize`` (the JAX package resolves them by the mesh's platform):
    the chain as ``inference.engine.resolve_chain_impl``."""
    if mesh.sp > 1:
        raise ValueError("optimize_sharded runs on a (dp, fp) mesh; an sp "
                         "mesh is optimize_time_sharded's")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.shape} "
                         "mesh")
    if state_b.mu.ndim != 3:
        raise ValueError("optimize_sharded takes a problem-batched state "
                         f"(mu [B, N, s]), got {tuple(state_b.mu.shape)}")
    _check_batched(graph_b, state_b.mu.shape[0])
    check_config(config, method)
    set_precision_policy()
    device = state_b.mu.device
    with torch.no_grad():
        graph_loc = shard_graph(graph_b, mesh)
        state_loc = shard_state(state_b, mesh)
        engine = FactorShardEngine(graph_loc, config, device, mesh)
        state, hist = run_gvi(engine, state_loc, config, method)
        hist = _gather_factor_costs(hist, graph_loc, mesh)
        _check_lockstep(mesh, state, hist)
    return state, hist


def sharded_ngd_step(graph_b, state_b, config: GVIConfig, mesh: Mesh,
                     temperature: float = 1.0, method: str = "ngd"):
    """One NGD / prox step, SPMD over (dp, fp), at a fixed temperature:
    the updated state of this rank's dp block and the per-problem cost at
    the top of the step."""
    cfg = replace(
        config,
        niters=1,
        temperature=float(temperature),
        # a single fixed-temperature step: no scheduled switch, and an
        # exhausted line search must not change the temperature
        niters_lowtemp=2**30,
        high_temperature=float(temperature),
    )
    state, hist = optimize_sharded(graph_b, state_b, cfg, mesh, method)
    return state, hist.cost[:, 0]
