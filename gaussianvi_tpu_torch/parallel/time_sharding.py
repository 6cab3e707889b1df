"""Sequence-parallel GVI: the trajectory axis sharded over the ranks of an
``sp`` mesh.

Counterpart of ``gaussianvi_tpu/parallel/time_sharding.py``.  With the
chain engine of :mod:`.chain_seqpar`, the whole GVI loop (covariance,
factor expectations, joint gradient assembly, natural-gradient solve,
lockstep line search, temperature schedule, EMA, convergence freeze) runs
with the N states sharded over ``sp``: the iteration body is the
single-device loop (``inference.optimize.run_gvi``) driven through
:class:`TimeShardEngine`.  Each iteration exchanges O(P) small messages:
the chain engine's segment summaries and halos, one mean / covariance halo
for the factors straddling a segment boundary, one reverse halo for their
gradient contributions, and the all-reduced costs
(``parallel/comm_model.py`` lists them).

Every rank of the mesh is handed the same whole problem (one problem per
call, as in the JAX package) and keeps its segment; the results are
gathered back, so every rank returns the whole final state and history.

Layout ("chain layout"): factors are stored per state or per edge so they
shard with the states they touch:

* every nonlinear batch must be unary (nb = 1) with exactly one factor per
  state, row j belonging to state j;
* binary (nb = 2) linear batches are stored per edge, padded to N rows
  with ``constant = 0`` (closed-form linear costs and gradients scale by
  the constant, so padding rows contribute exact zeros; the prox path
  masks padded rows explicitly, since the JKO step of even a zero
  potential carries entropy flow);
* unary linear batches are stored per state, masked the same way.

:func:`to_chain_layout` converts a standard :class:`FactorGraph` (from
``build_chain_estimation``, say) into this layout.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..factors import moments as mm
from ..inference.config import GVIConfig
from ..inference.engine import check_config, use_kernel
from ..inference.graph import FactorGraph, GaussianState
from ..inference.gvi import _bw_jko_step
from ..inference.optimize import GVIHistory, run_gvi
from ..ops.blocktridiag import BlockTridiag
from ..ops.precision import set_precision_policy
from .chain_seqpar import (
    gbp_covariance_logdet_seqpar,
    pad_off_for_seqpar,
    solve_seqpar,
)
from .collective import Mesh


def to_chain_layout(graph: FactorGraph) -> FactorGraph:
    """Reorder a chain-structured single-problem :class:`FactorGraph` into
    per-state / per-edge rows.  Raises ``ValueError`` where a nonlinear
    batch is not exactly one unary factor per state, where a linear batch
    repeats a start, and for a problem-batched graph.  A padded linear
    batch is no longer ``uniform``."""
    n = graph.num_states
    nl_out = []
    for fb in graph.nonlinear:
        if fb.nb != 1:
            raise ValueError("time sharding needs unary nonlinear factors")
        _one_problem(fb)
        order = np.argsort(fb.start.cpu().numpy())
        starts = fb.start.cpu().numpy()[order]
        if not np.array_equal(starts, np.arange(n)):
            raise ValueError(
                "each nonlinear batch must cover every state exactly once")
        perm = torch.as_tensor(order, device=fb.start.device)
        nl_out.append(replace(
            fb,
            start=torch.as_tensor(starts, device=fb.start.device),
            slice_offset=0,
            params=(None if fb.params is None else
                    {k: v[perm] for k, v in fb.params.items()}),
            kernel_params=(None if fb.kernel_params is None
                           else fb.kernel_params[perm]),
        ))
    lin_out = []
    for lb in graph.linear:
        _one_problem(lb)
        starts = lb.start.cpu().numpy()
        if len(np.unique(starts)) != len(starts):
            raise ValueError("duplicate linear-factor starts unsupported")
        rows = lb.start.to(torch.long)

        def spread(x):
            out = x.new_zeros((n, *x.shape[1:]))
            out[rows] = x
            return out

        lin_out.append(replace(
            lb,
            start=torch.arange(n, dtype=lb.start.dtype,
                               device=lb.start.device),
            slice_offset=0,
            uniform=False,
            lam=spread(lb.lam),
            psi=spread(lb.psi),
            target_mu=spread(lb.target_mu),
            target_prec=spread(lb.target_prec),
            constant=spread(lb.constant),   # missing rows: constant 0
        ))
    return FactorGraph(num_states=n, state_dim=graph.state_dim,
                       nonlinear=tuple(nl_out), linear=tuple(lin_out))


def _one_problem(batch):
    """Raise for a problem-batched factor batch (a leading problem axis on
    its starts or its per-factor data)."""
    if hasattr(batch, "lam"):
        ok = batch.lam.ndim == 3
    else:
        kp = batch.kernel_params
        ok = (kp is None or kp.ndim == 2) and all(
            v.shape[0] == batch.num_factors
            for v in (batch.params or {}).values())
    if batch.start.ndim != 1 or not ok:
        raise ValueError("time sharding takes one problem (per-factor data "
                         "[K, ...]), got a problem-batched factor batch")


def _segment_graph(graph: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's rows of a chain-layout graph (every batch has N rows,
    row j belonging to state j)."""
    n = graph.num_states
    nl = n // mesh.size
    lo = mesh.index * nl

    def rows(x):
        return x.narrow(0, lo, nl)

    for b in (*graph.nonlinear, *graph.linear):
        if b.start.ndim != 1 or b.num_factors != n:
            raise ValueError(
                "optimize_time_sharded needs a graph in chain layout (one row "
                "per state in every batch: to_chain_layout)")
    nonlinear = tuple(replace(
        fb, start=rows(fb.start), slice_offset=None,
        params=(None if fb.params is None else
                {k: rows(v) for k, v in fb.params.items()}),
        kernel_params=(None if fb.kernel_params is None
                       else rows(fb.kernel_params)))
        for fb in graph.nonlinear)
    linear = tuple(replace(
        lb, start=rows(lb.start), slice_offset=None,
        **{f: rows(getattr(lb, f)) for f in (
            "lam", "psi", "target_mu", "target_prec", "constant")})
        for lb in graph.linear)
    return replace(graph, nonlinear=nonlinear, linear=linear)


def _edge_marginals(mu_l, cov_diag, cov_off, mesh: Mesh):
    """Per-edge ``(mu [..., Nl, 2s], cov [..., Nl, 2s, 2s])``, the boundary
    edge's right state haloed from the right neighbour (one exchange)."""
    nbr_mu, nbr_cd = mesh.halo(mu_l[..., 0, :], cov_diag[..., 0, :, :],
                               offset=1)
    mu_r = torch.cat([mu_l[..., 1:, :], nbr_mu[..., None, :]], dim=-2)
    cd_r = torch.cat([cov_diag[..., 1:, :, :], nbr_cd[..., None, :, :]],
                     dim=-3)
    top = torch.cat([cov_diag, cov_off], dim=-1)
    bot = torch.cat([cov_off.transpose(-1, -2), cd_r], dim=-1)
    return torch.cat([mu_l, mu_r], dim=-1), torch.cat([top, bot], dim=-2)


def _scatter_edge(vd, vdd, vdmu, vddmu_d, vddmu_o, s, mesh: Mesh):
    """Add per-edge ``(vd [..., Nl, 2s], vdd [..., Nl, 2s, 2s])`` to the
    local per-state accumulators.  The right-state pieces of rows 0..Nl-2
    belong to local states 1..Nl-1; the boundary row's go to the right
    neighbour in one reverse halo (what enters rank 0 comes from the padded
    globally last edge: exact zeros)."""
    halo_mu, halo_dd = mesh.halo(vd[..., -1, s:], vdd[..., -1, s:, s:],
                                 offset=-1)
    vdmu = vdmu + vd[..., :s]
    vddmu_d = vddmu_d + vdd[..., :s, :s]
    vddmu_o = vddmu_o + vdd[..., :s, s:]
    vdmu = vdmu + torch.cat([halo_mu[..., None, :], vd[..., :-1, s:]],
                            dim=-2)
    vddmu_d = vddmu_d + torch.cat([halo_dd[..., None, :, :],
                                   vdd[..., :-1, s:, s:]], dim=-3)
    return vdmu, vddmu_d, vddmu_o


_WINDOWS = ("a patch-mode batch (kernel_prep) takes its cost_fn on the "
            "sequence-parallel engine, as in the JAX package: the window "
            "functor is another function")


class TimeShardEngine:
    """Engine hooks (those ``inference.optimize.run_gvi`` calls) with the
    trajectory axis sharded over the mesh's ``sp`` axis.

    The local state is the segment ``mu_l [..., Nl, s]`` with precision
    blocks ``BlockTridiag(diag [..., Nl, s, s], off [..., Nl, s, s])`` in
    the padded edge layout of :mod:`.chain_seqpar`.  The chain is always
    the sequence-parallel scan (``chain_impl`` is not read, as in the JAX
    package).  ``quad_impl``: ``"auto"`` and ``"xla"`` take the plain
    quadrature, the rule of the JAX engine, which runs the plain
    quadrature on every segment whatever ``quad_impl`` says; ``"lanes"``
    takes the quadrature kernel (K3) for every nonlinear batch, raising
    where the tensors are not on the card or a batch is not covered, as
    ``"lanes"`` does on the local engine.  A patch-mode batch
    (``kernel_prep``) is not covered: the JAX engine evaluates its
    ``cost_fn``, the whole-field lookup, and the window functor is another
    function, so ``"lanes"`` raises for it and ``"auto"`` / ``"xla"`` take
    its ``cost_fn``.  No fused kernel, nor K1's trial form."""

    chain_kernel = False
    fused_trials_ready = False
    fused_gradient_ready = False
    gbp_trials_ready = False
    fused_eval_dtype = None
    fused_grad_eval_dtype = None

    def __init__(self, graph: FactorGraph, config, mesh: Mesh,
                 device: torch.device):
        self.graph = graph
        self.mesh = mesh
        impl = config.quad_impl if config.quad_impl == "lanes" else "xla"
        self.quad_batches = tuple(
            use_kernel(impl, "xla", "quad_impl", device,
                       _WINDOWS if fb.kernel_prep is not None
                       else mm.kernel_covers(fb))
            for fb in graph.nonlinear)

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        return gbp_covariance_logdet_seqpar(prec.diag, prec.off, self.mesh)

    # -- costs ---------------------------------------------------------------
    def factor_costs_raw(self, mu_l, cov_diag, cov_off, eval_dtype=None):
        g = self.graph
        out = []
        for fb, kernel in zip(g.nonlinear, self.quad_batches):
            out.append(mm.batch_phi(fb, mu_l, cov_diag, kernel, eval_dtype))
        mu_e = cov_e = None
        for lb in g.linear:
            if lb.nb == 2 and mu_e is None:
                mu_e, cov_e = _edge_marginals(mu_l, cov_diag, cov_off,
                                              self.mesh)
            mk, ck = (mu_l, cov_diag) if lb.nb == 1 else (mu_e, cov_e)
            out.append(mm.linear_cost(lb.lam, lb.psi, lb.target_mu,
                                      lb.target_prec, lb.constant, mk, ck))
        return tuple(out)

    def reduce_fc(self, fc_tuple, like: torch.Tensor) -> torch.Tensor:
        """The segments' summed factor costs, all-reduced over sp."""
        local = torch.zeros_like(like)
        for f in fc_tuple:
            local = local + f.sum(-1)
        return self.mesh.psum(local)

    def reduce_trial_costs(self, trial_lds, fc_t) -> torch.Tensor:
        """The trials' log dets are already global (the chain's
        all-reduce); their factor costs are summed here."""
        return 0.5 * trial_lds + self.reduce_fc(fc_t, trial_lds)

    # -- gradients -----------------------------------------------------------
    def _accumulators(self, mu_l):
        s = mu_l.shape[-1]
        zeros = mu_l.new_zeros((*mu_l.shape, s))
        return torch.zeros_like(mu_l), zeros, zeros.clone()

    def ngd_gradients(self, mu_l, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        g = self.graph
        s = mu_l.shape[-1]
        vdmu, vddmu_d, vddmu_o = self._accumulators(mu_l)
        for fb, kernel in zip(g.nonlinear, self.quad_batches):
            e_phi, e_xmu, e_xxt = mm.batch_moments(
                fb, mu_l, cov_diag, use_kernel=kernel, eval_dtype=eval_dtype)
            vd, vdd = mm.ngd_local_gradients(e_phi, e_xmu, e_xxt, cov_diag,
                                             temperature)
            vdmu = vdmu + vd
            vddmu_d = vddmu_d + vdd
        mu_e = cov_e = None
        for lb in g.linear:
            if lb.nb == 1:
                vd, vdd = mm.linear_local_gradients(
                    lb.lam, lb.psi, lb.target_mu, lb.target_prec,
                    lb.constant, mu_l, temperature)
                vdmu = vdmu + vd
                vddmu_d = vddmu_d + vdd
                continue
            if mu_e is None:
                mu_e, cov_e = _edge_marginals(mu_l, cov_diag, cov_off,
                                              self.mesh)
            # vd [..., Nl, 2s], vdd [..., Nl, 2s, 2s]; padded rows exact zero
            vd, vdd = mm.linear_local_gradients(
                lb.lam, lb.psi, lb.target_mu, lb.target_prec, lb.constant,
                mu_e, temperature)
            vdmu, vddmu_d, vddmu_o = _scatter_edge(vd, vdd, vdmu, vddmu_d,
                                                   vddmu_o, s, self.mesh)
        return vdmu, BlockTridiag(vddmu_d, vddmu_o)

    def prox_gradients(self, mu_l, cov_diag, cov_off, step_size):
        """Per-factor Bures-Wasserstein JKO pseudo-gradients in chain
        layout.  Padded linear rows (constant == 0) are masked out: unlike
        the closed-form NGD gradients, the JKO step of a ZERO potential
        still moves the covariance (its Wasserstein entropy flow), so a
        padding row would otherwise contribute spurious expansion."""
        g = self.graph
        s = mu_l.shape[-1]
        dmu, dpd, dpo = self._accumulators(mu_l)
        for fb, kernel in zip(g.nonlinear, self.quad_batches):
            e_phi, e_xmu, e_xxt = mm.batch_moments(fb, mu_l, cov_diag,
                                                   use_kernel=kernel)
            b_k, s_k = mm.bw_local_gradients(e_phi, e_xmu, e_xxt, cov_diag)
            vd, vdd = _bw_jko_step(b_k, s_k, cov_diag, step_size)
            dmu = dmu + vd
            dpd = dpd + vdd
        mu_e = cov_e = None
        for lb in g.linear:
            if lb.nb == 2 and mu_e is None:
                mu_e, cov_e = _edge_marginals(mu_l, cov_diag, cov_off,
                                              self.mesh)
            mk, ck = (mu_l, cov_diag) if lb.nb == 1 else (mu_e, cov_e)
            # closed-form BW gradients, without the constant factor
            resid = (torch.einsum("...rd,...d->...r", lb.lam, mk)
                     - torch.einsum("...rt,...t->...r", lb.psi, lb.target_mu))
            b_k = torch.einsum("...rd,...rs,...s->...d", lb.lam,
                               lb.target_prec, resid)
            s_k = torch.einsum("...ra,...rs,...sb->...ab", lb.lam,
                               lb.target_prec, lb.lam)
            vd, vdd = _bw_jko_step(b_k, s_k, ck, step_size)
            mask = (lb.constant != 0).to(mu_l.dtype)
            vd = vd * mask[..., None]
            vdd = vdd * mask[..., None, None]
            if lb.nb == 1:
                dmu = dmu + vd
                dpd = dpd + vdd
            else:
                dmu, dpd, dpo = _scatter_edge(vd, vdd, dmu, dpd, dpo, s,
                                              self.mesh)
        return dmu, BlockTridiag(dpd, dpo)

    # -- solve ---------------------------------------------------------------
    def solve_pair(self, bt_main: BlockTridiag, bt_fallback: BlockTridiag,
                   rhs):
        """Both systems against the same rhs in ONE sequence-parallel solve
        (stacked on a leading axis: the collectives of one solve)."""
        x = solve_seqpar(torch.stack([bt_main.diag, bt_fallback.diag]),
                         torch.stack([bt_main.off, bt_fallback.off]),
                         rhs.expand(2, *rhs.shape), self.mesh)
        return x[0], x[1]

    def all_finite(self, x: torch.Tensor) -> torch.Tensor:
        """Agreed over sp, so every rank takes the same fallback branch."""
        n_bad = (~torch.isfinite(x)).flatten(-2).sum(-1)
        return self.mesh.psum(n_bad) == 0


def _gather_run(mesh: Mesh, state: GaussianState, hist: GVIHistory,
                n_batches: int):
    """The whole final state and history from every rank's segment, in one
    all-gather; the padded last edge row stripped."""
    nl = state.mu.shape[-2]
    fc = hist.factor_costs.split(nl, dim=-1)            # per batch [it, Nl]
    parts = (state.mu, state.precision.diag, state.precision.off,
             hist.mu, hist.cov_diag, hist.cov_off, hist.prec_diag,
             hist.prec_off, *fc)
    # the state axis of each part, from the end
    rest = (1, 2, 2, 1, 2, 2, 2, 2) + (0,) * n_batches
    stacked = mesh.all_gather(*parts)
    whole = [torch.cat(list(g.unbind(0)), dim=g.ndim - 2 - r)
             for g, r in zip(stacked, rest)]
    mu, pd, po, h_mu, h_cd, h_co, h_pd, h_po, *fc = whole
    final = GaussianState(mu, BlockTridiag(pd, po[..., :-1, :, :]))
    return final, hist._replace(
        mu=h_mu, cov_diag=h_cd, cov_off=h_co[..., :-1, :, :], prec_diag=h_pd,
        prec_off=h_po[..., :-1, :, :],
        factor_costs=torch.cat(fc, dim=-1))


def optimize_time_sharded(graph: FactorGraph, state: GaussianState,
                          config: GVIConfig, mesh: Mesh,
                          method: str = "ngd"):
    """The whole GVI loop with the trajectory axis sharded over the mesh's
    ``sp`` ranks: the semantics (and trajectories, up to the reassociation
    of the sums over sp) of ``optimize``.  Every rank of the mesh calls it
    with the same single problem, ``graph`` in chain layout
    (:func:`to_chain_layout`) and ``state`` with ``mu [N, s]``, and gets
    back the whole final state and history.  Raises ``ValueError`` where N
    does not divide over sp, for a problem-batched state and for a mesh
    with fp > 1."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.shape} "
                         "mesh")
    if mesh.fp > 1:
        raise ValueError("optimize_time_sharded runs on an sp mesh "
                         f"(make_mesh(dp, 1, sp)), got fp={mesh.fp}")
    if state.mu.ndim != 2:
        raise ValueError("optimize_time_sharded takes one problem (mu [N, "
                         f"s]), got {tuple(state.mu.shape)}")
    n, s = state.mu.shape
    p = mesh.size
    if n % p:
        raise ValueError(f"num_states {n} not divisible by sp={p}")
    check_config(config, method)
    set_precision_policy()
    nl = n // p
    rows = slice(mesh.index * nl, (mesh.index + 1) * nl)
    with torch.no_grad():
        off_pad = pad_off_for_seqpar(state.precision.off)
        state_l = GaussianState(state.mu[rows], BlockTridiag(
            state.precision.diag[rows], off_pad[rows]))
        graph_l = _segment_graph(graph, mesh)
        engine = TimeShardEngine(graph_l, config, mesh, state.mu.device)
        final, hist = run_gvi(engine, state_l, config, method)
        # every decision was taken on all-reduced values: the ranks agree
        for what, x in (("accepted steps", hist.accepted_step),
                        ("costs", hist.cost)):
            if mesh.differs(x):
                raise RuntimeError(
                    f"optimize_time_sharded: the sp ranks disagree on the "
                    f"{what}: they did not run in lockstep (were they "
                    "handed the same problem?)")
        return _gather_run(mesh, final, hist,
                           len(graph.nonlinear) + len(graph.linear))


def sharded_time_ngd_step(graph: FactorGraph, state: GaussianState,
                          config: GVIConfig, mesh: Mesh, temperature=1.0,
                          method: str = "ngd"):
    """One GVI step with the trajectory axis sharded over sp at a fixed
    temperature (the loop is :func:`optimize_time_sharded`): ``(the whole
    updated state, the cost at the top of the step)``."""
    cfg = replace(
        config,
        niters=1,
        temperature=float(temperature),
        niters_lowtemp=2**30,
        high_temperature=float(temperature),
    )
    final, hist = optimize_time_sharded(graph, state, cfg, mesh, method)
    return final, hist.cost[0]
