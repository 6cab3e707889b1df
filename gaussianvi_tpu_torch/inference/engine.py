"""Backend hooks for the GVI iteration loop (single device).

Counterpart of ``gaussianvi_tpu/inference/engine.py`` :class:`LocalEngine`.
The engine resolves ``chain_impl``, ``quad_impl``, ``fused_trials`` and
``fused_gradient`` once, from the config, the graph and the device the
problem lives on, as the JAX package's engine does: ``"auto"`` takes a
kernel where the device is the card and the kernel covers the shape (the
chain's block size and dtype, each nonlinear batch's cost functor and
support, the fused kernels' operands), and the plain version elsewhere;
``quad_impl="auto"`` follows the resolved chain, and the fused kernels are
gated on the resolved quadrature alone.  The loop reads which route each
of its stages takes from one :class:`LoopPlan` the engine resolves for a
method (:meth:`LocalEngine.plan`).  It exposes the loop's hooks over
problem-batched tensors: every result is per problem, never reduced over a
leading axis.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from ..factors import moments as mm
from ..kernels import QUAD_ROUTE_COUNTS, chain
from ..kernels import fused_trials as ft
from ..kernels import fused_gradient as fg
from ..kernels.fused_gradient import gradient_lanes
from ..kernels.fused_trials import (
    LinTrialSpec,
    NLTrialSpec,
    linear_residual_form,
    trial_costs_lanes,
)
from ..ops.blocktridiag import BlockTridiag
from ..ops.blocktridiag import gbp_covariance_logdet as gbp_plain
from ..ops.parallel_chain import gbp_covariance_logdet_assoc, solve_assoc
from .gvi import ngd_gradients, prox_gradients
from .graph import FactorGraph, GaussianState, gather_marginals, take_states


def use_kernel(impl: str, plain: str, field: str, device: torch.device,
               why_not: str | None = None) -> bool:
    """Resolve an implementation switch for one kernel family on one shape
    or batch: ``"auto"`` -> the CUDA kernel for GPU tensors it covers
    (``why_not`` None), else the plain version; ``"lanes"`` -> the kernel
    (raises for CPU tensors, and with ``why_not`` for what it does not
    cover); ``plain`` -> the plain version.  A resolution, made once: a
    covered CUDA tensor then launches the kernel or raises."""
    if impl == "auto":
        return device.type == "cuda" and why_not is None
    if impl == "lanes":
        if device.type != "cuda":
            raise ValueError(f"{field}='lanes' runs the CUDA kernels; the "
                             f"problem's tensors are on {device}")
        if why_not is not None:
            raise ValueError(f"{field}='lanes': {why_not}")
        return True
    if impl == plain:
        return False
    raise ValueError(f"unknown {field} {impl!r}")


def resolve_chain_impl(config, num_states: int, device: torch.device,
                       why_not: str | None = None) -> str:
    """The chain's route, ``"lanes"`` (K1 / K2), ``"assoc"`` or ``"seq"``
    (``resolve_chain_impl`` in the JAX package): ``"auto"`` takes the
    kernels for GPU tensors they cover (``why_not`` None), else the
    log-depth scans where ``num_states >= assoc_threshold``, else the
    sequential sweeps; ``"lanes"`` is the kernels or raises (see
    :func:`use_kernel`)."""
    impl = config.chain_impl
    if impl == "auto":
        if device.type == "cuda" and why_not is None:
            return "lanes"
        return "assoc" if num_states >= config.assoc_threshold else "seq"
    if impl in ("seq", "assoc"):
        return impl
    use_kernel(impl, "seq", "chain_impl", device, why_not)
    return "lanes"


def check_config(config, method: str) -> None:
    """Raise ``ValueError`` for an unknown method or option value."""
    if method not in ("ngd", "prox"):
        raise ValueError(f"unknown method {method!r}")
    for name in ("fused_trials", "fused_gradient"):
        value = getattr(config, name)
        if value not in ("auto", "on", "off"):
            raise ValueError(f"unknown {name} {value!r}")
    if config.linesearch not in ("batched", "seq"):
        raise ValueError(f"unknown linesearch {config.linesearch!r}")
    if config.fused_trials == "on" and config.linesearch != "batched":
        raise ValueError("fused_trials='on' needs linesearch='batched' (the "
                         "kernel evaluates every trial at once)")
    mm.as_eval_dtype(config.moments_eval_dtype)


def fused_operands(graph: FactorGraph, trials: bool = True):
    """Static eligibility and operand prep shared by the fused trial and
    gradient kernels (``engine._build_fused_specs`` in the JAX package):
    ``(nl_specs, lin_specs, nl_arrays, lin_arrays)`` as
    ``kernels/fused_trials.py`` describes them, or a string saying why the
    kernels do not cover the graph (checked before any call:
    ``fused_trials.covers``, for K5 or, ``trials=False``, for K6, which
    also takes the patch mode's batches, the JAX package's
    ``allow_prep``).  Per-problem leaves keep the graph's leading axes; a
    batch's field is shared by all problems, as its rule is; a patch-mode
    batch's params are its static row, which the engine replaces before
    each call by the ones its ``kernel_prep`` forms from the means
    (:meth:`LocalEngine._flat_nonlinear`)."""
    s = graph.state_dim
    if graph.num_states < 2:
        return "the fused kernels need N >= 2 states"
    nl_specs, lin_specs, nl_arrays, lin_arrays = [], [], [], []
    for fb in graph.nonlinear:
        if fb.nb != 1 or fb.kernel_cost is None or fb.kernel_params is None:
            return ("every nonlinear batch needs nb == 1 and a kernel_cost "
                    "with kernel_params")
        if fb.slice_offset is None and not fb.shared_start:
            return "nonlinear starts must be a slice or shared by all problems"
        why = mm.kernel_covers(fb)
        if why is not None:
            return why
        nl_specs.append(NLTrialSpec(fb.kernel_cost, fb.num_factors,
                                    fb.nodes.shape[0], fb.slice_offset,
                                    fb.quad_rdim, fb.nonneg_cost))
        nl_arrays.append((fb.start, fb.nodes, fb.weights, fb.kernel_params,
                          *(() if fb.kernel_field is None
                            else (fb.kernel_field,))))
    lin = linear_operands(graph)
    if isinstance(lin, str):
        return lin
    lin_specs, lin_arrays = lin
    why = ft.covers(s, graph.dtype, nl_specs, lin_specs, trials)
    if why is not None:
        return why
    return tuple(nl_specs), lin_specs, tuple(nl_arrays), lin_arrays


def linear_operands(graph: FactorGraph):
    """The linear half of :func:`fused_operands`, which K1's trial form
    takes too: ``(lin_specs, lin_arrays)`` in the residual form of
    ``kernels/fused_trials.py``, or a string saying why the batches are
    not covered (nb > 2, per-problem starts, ``fused_trials.linear_covers``)."""
    s = graph.state_dim
    lin_specs, lin_arrays = [], []
    for lb in graph.linear:
        if lb.nb not in (1, 2):
            return "every linear batch needs nb <= 2"
        if lb.slice_offset is None and not lb.shared_start:
            return "linear starts must be a slice or shared by all problems"
        rows = slice(0, 1) if lb.uniform else slice(None)
        lam = lb.lam[..., rows, :, :]
        a, pm, prec_c = linear_residual_form(
            lam, lb.psi[..., rows, :, :], lb.target_mu[..., rows, :],
            lb.target_prec[..., rows, :, :], lb.constant[..., rows])
        if lb.nb == 2:
            a = torch.stack([a[..., :s, :s], a[..., s:, s:], a[..., :s, s:]],
                            dim=-3)
        else:
            a = a[..., None, :, :]
        lin_specs.append(LinTrialSpec(lb.nb, lb.num_factors, a.shape[-4],
                                      lam.shape[-2], lb.slice_offset))
        lin_arrays.append((lb.start, a, lam, pm, prec_c))
    return ft.linear_covers(s, lin_specs) or (tuple(lin_specs),
                                              tuple(lin_arrays))


def _use_fused(field: str, value: str, why_not: str | None,
               quad_kernel: bool) -> bool:
    """``"auto"`` -> the fused kernel where the graph is covered and the
    quadrature resolved to its kernels; ``"on"`` -> asserts that the
    kernels cover the graph and the config (raises ``ValueError``, as the
    JAX package does); ``"off"`` -> the separate path."""
    if value == "on":
        if why_not is not None:
            raise ValueError(f"{field}='on' but the graph/config is not "
                             f"eligible: {why_not}")
        return True
    return value == "auto" and why_not is None and quad_kernel


@dataclass(frozen=True)
class LoopPlan:
    """Which route each stage of the GVI loop takes for one method on one
    engine, resolved once (:meth:`LocalEngine.plan`).

    * ``trials``, the line search: ``"seq"`` (one trial after another, on
      the separate route), ``"fused"`` (K5: every trial's cost, log det
      and factor costs in one kernel, no covariance), ``"chain"`` (K1's
      trial form: every trial's chain and linear costs in one launch, the
      nonlinear batches on its blocks) or ``"separate"`` (the chain and
      the quadrature over all trials at once);
    * ``gradient``: ``"prox"`` (the JKO pseudo-gradient), ``"fused"`` (K6
      in the engine's ``gradient_modes``, which also forms the iterate's
      covariance: the carried blocks lag and ``gvi.finish`` refreshes
      them) or ``"separate"``;
    * ``eval_dtype``: the sigma offsets' rounding (the config's for NGD;
      prox never quantizes);
    * ``captured``: whether a call's loop may replay as a CUDA graph
      (``inference/loop_graph.py``)."""

    trials: str
    gradient: str
    eval_dtype: torch.dtype | None
    captured: bool


def resolve_plan(config, method: str, fused_trials: bool = False,
                 chain_trials: bool = False, fused_gradient: bool = False,
                 capture: bool = False) -> LoopPlan:
    """The :class:`LoopPlan` of ``method`` on an engine that resolved K5
    (``fused_trials``), K1's trial form (``chain_trials``) and K6
    (``fused_gradient``) for ``config``, and whose hooks a CUDA graph may
    capture (``capture``); by default the separate routes, never
    captured.  A fused kernel rounds the offsets as the config says, so a
    run takes K5 only where it rounds them the same way (prox, which never
    quantizes, keeps the separate trials under a bfloat16 config); K6 and
    K1's trial form are NGD's.  A captured loop is NGD's batched search on
    offsets the kernels round."""
    ngd = method == "ngd"
    config_dtype = mm.as_eval_dtype(config.moments_eval_dtype)
    eval_dtype = config_dtype if ngd else None
    trials = ("seq" if config.linesearch == "seq"
              else "fused" if fused_trials and eval_dtype == config_dtype
              else "chain" if chain_trials and ngd else "separate")
    gradient = ("prox" if not ngd else "fused" if fused_gradient
                else "separate")
    return LoopPlan(trials, gradient, eval_dtype,
                    capture and ngd and trials != "seq"
                    and mm.kernel_quantizes(eval_dtype))


def fold(x: torch.Tensor, batch) -> torch.Tensor:
    """``x [*batch, ...]`` with the problem axes ``batch`` as one."""
    return x.reshape(batch.numel(), *x.shape[len(batch):])


def unfold(x: torch.Tensor, batch, lead: int = 0) -> torch.Tensor:
    """``x [*lead axes, prod(batch), ...]`` with the problem axes back."""
    return x.reshape((*x.shape[:lead], *batch, *x.shape[lead + 1:]))


def _flat(x: torch.Tensor, batch, tail: int) -> torch.Tensor:
    """``x [..., *rest]`` (``tail`` trailing axes) broadcast over the
    problem axes ``batch`` and flattened to ``[prod(batch), *rest]``."""
    rest = x.shape[x.ndim - tail:]
    return x.expand(*batch, *rest).reshape(-1, *rest)


class LocalEngine:
    """Single-device hooks: the whole (problem-batched) graph lives on one
    device.

    Resolved routes: ``chain_impl`` (``"lanes"``: K1/K2, ``"assoc"``,
    ``"seq"``), ``quad_batches`` (per nonlinear batch, whether that batch
    takes the quadrature kernel where the call's ``eval_dtype`` is None or
    bfloat16; a float16 call takes the plain quadrature),
    ``fused_trials_ready`` (K5) and ``fused_gradient_ready`` (K6 in the
    modes of ``gradient_modes``), for the config's ``moments_eval_dtype``;
    and, where no fused kernel covers the chain, K1's trial form (the
    chain on K1 at a block size of the wide layout and every linear batch
    in residual form).  The loop reads them through :meth:`plan` only."""

    # the modes of K6 the fused gradient step runs
    gradient_modes = ("full",)
    # whether a call's loop may replay as a CUDA graph (where the card runs
    # every nonlinear batch's quadrature kernel)
    captures = True

    def __init__(self, graph: FactorGraph, config, device: torch.device):
        self.graph = graph
        self.device = device
        self.use_pallas = config.use_pallas
        self.chain_impl = resolve_chain_impl(
            config, graph.num_states, device,
            chain.covers(graph.state_dim, graph.dtype))
        chain_kernel = self.chain_impl == "lanes"
        # quad_impl="auto" follows the resolved chain (the JAX package's
        # bundle); each batch then takes the kernel where it is covered
        quad_impl = config.quad_impl
        if quad_impl == "auto" and not chain_kernel:
            quad_impl = "xla"
        quad_kernel = use_kernel(quad_impl, "xla", "quad_impl", device)
        self.quad_batches = tuple(
            quad_kernel and use_kernel(quad_impl, "xla", "quad_impl",
                                       device, mm.kernel_covers(fb))
            for fb in graph.nonlinear)
        for kernel in self.quad_batches:
            QUAD_ROUTE_COUNTS["kernel" if kernel else "plain"] += 1
        # the fused kernels are gated on the quadrature alone
        # (gaussianvi_tpu/inference/engine.py): "on" is refused where the
        # config forces the plain quadrature, on any device.  K6 takes the
        # patch mode's batches, K5 does not (its trial means exist only
        # in the kernel, and the windows follow the means)
        ops = fused_operands(graph, trials=False)
        why_not = ops if isinstance(ops, str) else None
        if config.quad_impl == "xla" or (
                config.quad_impl == "auto"
                and config.chain_impl in ("seq", "assoc")):
            why_not = ("quad_impl='xla' (or 'auto' with chain_impl 'seq' "
                       "or 'assoc') forces the plain quadrature")
        if why_not is None and not mm.kernel_quantizes(
                mm.as_eval_dtype(config.moments_eval_dtype)):
            why_not = (f"moments_eval_dtype={config.moments_eval_dtype!r} "
                       "keeps the plain quadrature (the kernels round "
                       "offsets through bfloat16 only)")
        self.fused_trials_ready = _use_fused(
            "fused_trials", config.fused_trials,
            why_not or (None if config.linesearch == "batched"
                        else "linesearch must be 'batched'")
            or ft.covers(graph.state_dim, graph.dtype, *ops[:2]),
            quad_kernel)
        self.fused_gradient_ready = _use_fused(
            "fused_gradient", config.fused_gradient,
            why_not or fg.covers(graph.state_dim, self.gradient_modes,
                                 {fb.kernel_cost for fb in graph.nonlinear}),
            quad_kernel)
        lin = (linear_operands(graph) if chain_kernel
               and graph.state_dim in chain.WIDE_BLOCK_SIZES
               and not self.fused_trials_ready
               else "the trial form is K1's at s = 14, where K5 is not")
        self._chain_trials = not isinstance(lin, str)
        # the kernels' operands, (specs, arrays) each: both halves where the
        # fused kernels cover the graph, the linear half for K1's trial form
        self._nl_ops, self._lin_ops = (
            ((ops[0], ops[2]), (ops[1], ops[3])) if why_not is None
            else (None, lin if self._chain_trials else None))

    def plan(self, config, method: str) -> LoopPlan:
        """The loop's routes for ``method`` under ``config`` (the config
        the engine was built with)."""
        return resolve_plan(
            config, method, self.fused_trials_ready, self._chain_trials,
            self.fused_gradient_ready,
            self.captures and self.device.type == "cuda"
            and all(self.quad_batches)
            and all(fb.kernel_prep is None for fb in self.graph.nonlinear))

    def operands(self):
        """``(tree, starts)``: the tensors the hooks read (the graph and
        the kernels' operands), of which a captured loop reads static
        copies (:meth:`over`), and ``[(start, N)]``, each kernel batch's
        start on the chain of N states, whose per-state index the kernels
        read."""
        starts = [(arrays[0], self.graph.num_states)
                  for ops in (self._nl_ops, self._lin_ops) if ops is not None
                  for arrays in ops[1]]
        return (self.graph, self._nl_ops, self._lin_ops), starts

    def over(self, tree) -> LocalEngine:
        """This engine's hooks on ``tree`` (:meth:`operands`' tree with
        other tensors of the same layout)."""
        local = copy.copy(self)
        local.graph, local._nl_ops, local._lin_ops = tree
        return local

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        """(cov_diag, cov_off, logdet) of the joint precision."""
        if self.chain_impl == "lanes":
            return chain.gbp_covariance_logdet_lanes(prec.diag, prec.off)
        if self.chain_impl == "assoc":
            return gbp_covariance_logdet_assoc(prec)
        return gbp_plain(prec)

    # -- costs ---------------------------------------------------------------
    def factor_costs_raw(self, mu, cov_diag, cov_off, eval_dtype=None):
        """Untempered per-factor E[psi_k], one ``[..., K]`` tensor per batch
        (nonlinear batches first, then linear); ``eval_dtype``: the sigma
        offsets' rounding."""
        return (*self.nonlinear_costs_raw(mu, cov_diag, cov_off, eval_dtype),
                *(mm.batch_linear_cost(lb, mu, cov_diag, cov_off)
                  for lb in self.graph.linear))

    def nonlinear_costs_raw(self, mu, cov_diag, cov_off, eval_dtype=None):
        """The nonlinear batches' part of :meth:`factor_costs_raw`."""
        out = []
        for fb, kernel in zip(self.graph.nonlinear, self.quad_batches):
            mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                           cov_off, fb.slice_offset)
            out.append(mm.batch_phi(fb, mu_k, cov_k, kernel, eval_dtype))
        return tuple(out)

    def reduce_fc(self, fc_tuple, like: torch.Tensor) -> torch.Tensor:
        """Per-problem sum of (already tempered) per-factor costs,
        ``[..., K] -> [...]``, in the JAX package's order.  A sharded
        engine sums its sharded batches over its ranks here."""
        total = torch.zeros_like(like)
        for f in fc_tuple:
            total = total + f.sum(-1)
        return total

    def reduce_trial_costs(self, trial_lds, fc_t) -> torch.Tensor:
        """Total cost of every line-search trial ``[T, ...]``: 0.5 log det
        plus the (already tempered) per-factor sums.  A sharded engine
        sums over its ranks here, so that every rank sees the same costs
        and takes the same accept decisions."""
        return 0.5 * trial_lds + self.reduce_fc(fc_t, trial_lds)

    # -- gradients -----------------------------------------------------------
    def ngd_gradients(self, mu, cov_diag, cov_off, temperature,
                      eval_dtype=None):
        return ngd_gradients(self.graph, mu, cov_diag, cov_off, temperature,
                             self.use_pallas, self.quad_batches,
                             eval_dtype=eval_dtype)

    def prox_gradients(self, mu, cov_diag, cov_off, step_size):
        return prox_gradients(self.graph, mu, cov_diag, cov_off, step_size,
                              self.quad_batches)

    # -- solve ---------------------------------------------------------------
    def solve_pair(self, bt_main: BlockTridiag, bt_fallback: BlockTridiag,
                   rhs):
        """Solve both systems (main metric + SPD fallback) against the same
        rhs ``[..., N, s]`` in ONE chain call (K2 reads the rhs once)."""
        if self.chain_impl == "assoc":
            return solve_assoc(bt_main, rhs), solve_assoc(bt_fallback, rhs)
        solve = (chain.solve_pair_lanes if self.chain_impl == "lanes"
                 else chain.solve_pair_plain)
        return solve(bt_main.diag, bt_main.off, bt_fallback.diag,
                     bt_fallback.off, rhs)

    # -- fused kernels ---------------------------------------------------------
    def _flat_nonlinear(self, batch, mu):
        """The nonlinear operands ``(specs, arrays)`` with the problem axes
        flattened to one ``[B, ...]`` axis (B = prod(batch)); a patch-mode
        batch's params formed from the means ``mu [*batch, N, s]`` (the
        JAX package's ``_splice_preps``)."""
        nl_specs, nl_arrays = self._nl_ops
        return nl_specs, tuple(
            (st, nd, w, _flat(p if fb.kernel_prep is None else fb.kernel_prep(
                take_states(mu, fb.start, fb.slice_offset, 1)), batch, 2),
             *field)
            for fb, (st, nd, w, p, *field) in zip(self.graph.nonlinear,
                                                   nl_arrays))

    def _flat_linear(self, batch):
        """The linear operands ``(specs, arrays)``, flattened likewise."""
        lin_specs, lin_arrays = self._lin_ops
        return lin_specs, tuple(
            (st, _flat(a, batch, 4), _flat(lam, batch, 3), _flat(pm, batch, 2),
             _flat(pc, batch, 3)) for st, a, lam, pm, pc in lin_arrays)

    def fused_trial_costs(self, state: GaussianState, dmu,
                          dprec: BlockTridiag, trials, eval_dtype=None):
        """All line-search trials in one kernel (K5): ``(ld [T, ...],
        fc tuple of [T, ..., K])``, nonlinear batches first, then linear
        (the order of :meth:`factor_costs_raw`)."""
        batch, prec = state.mu.shape[:-2], state.precision
        x = [fold(x, batch) for x in (state.mu, dmu, prec.diag, prec.off,
                                      dprec.diag, dprec.off)]
        nl_specs, nl = self._flat_nonlinear(batch, state.mu)
        lin_specs, lin = self._flat_linear(batch)
        ld, fc = trial_costs_lanes(*x, trials, nl_specs, lin_specs, nl, lin,
                                   eval_dtype=eval_dtype)
        return unfold(ld, batch, 1), tuple(unfold(f, batch, 1) for f in fc)

    def gbp_trials(self, state: GaussianState, dmu, dprec: BlockTridiag,
                   trials):
        """Every line-search trial's chain in one launch of K1's trial form
        (``kernels/chain.py`` ``gbp_trials_lanes``): ``(cov_diag [T, ...,
        N, s, s], cov_off, logdet [T, ...], linear fc tuple of [T, ...,
        K])``, the linear batches' untempered costs in
        :meth:`factor_costs_raw`'s order."""
        batch, prec = state.mu.shape[:-2], state.precision
        lin_specs, lin = self._flat_linear(batch)
        cd, co, ld, fc = chain.gbp_trials_lanes(
            *(fold(x, batch) for x in (prec.diag, prec.off, dprec.diag,
                                       dprec.off, state.mu, dmu)),
            trials, lin_specs, lin)
        return (*(unfold(x, batch, 1) for x in (cd, co, ld)),
                tuple(unfold(f, batch, 1) for f in fc))

    def fused_gradient(self, state: GaussianState, temperature,
                       eval_dtype=None):
        """The whole NGD gradient step in one kernel (K6): covariance of
        the current iterate, joint (Vdmu, Vddmu), both solves; a
        patch-mode batch's windows follow the current means.  Returns
        ``(cov_diag, cov_off, logdet, dprec BlockTridiag, dmu,
        dmu_fallback)``."""
        batch, prec = state.mu.shape[:-2], state.precision
        x = (*(fold(x, batch) for x in (state.mu, prec.diag, prec.off)),
             temperature.reshape(-1))
        nl_specs, nl = self._flat_nonlinear(batch, state.mu)
        lin_specs, lin = self._flat_linear(batch)
        out = gradient_lanes(*x, nl_specs, lin_specs, nl, lin,
                             eval_dtype=eval_dtype)
        cd, co, ld, dpd, dpo, dmu, dfb = (unfold(x, batch) for x in out)
        return cd, co, ld, BlockTridiag(dpd, dpo), dmu, dfb

    @staticmethod
    def all_finite(x: torch.Tensor) -> torch.Tensor:
        """Per problem: is every element of ``x [..., N, s]`` finite."""
        return torch.isfinite(x).flatten(-2).all(-1)
