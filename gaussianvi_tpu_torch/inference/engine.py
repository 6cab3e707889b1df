"""Backend hooks for the GVI iteration loop (single device).

Counterpart of ``gaussianvi_tpu/inference/engine.py`` :class:`LocalEngine`.
The engine resolves ``chain_impl``, ``quad_impl``, ``fused_trials`` and
``fused_gradient`` once, from the config, the graph and the device the
problem lives on, as the JAX package's engine does: ``"auto"`` takes a
kernel where the device is the card and the kernel covers the shape (the
chain's block size and dtype, each nonlinear batch's cost functor and
support, the fused kernels' operands), and the plain version elsewhere;
``quad_impl="auto"`` follows the resolved chain, and the fused kernels are
gated on the resolved quadrature alone.  It exposes the loop's hooks over
problem-batched tensors: every result is per problem, never reduced over a
leading axis.
"""

from __future__ import annotations

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
    (:meth:`LocalEngine._flat_operands`)."""
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


class LocalEngine:
    """Single-device hooks: the whole (problem-batched) graph lives on one
    device.

    Resolved routes: ``chain_impl`` (``"lanes"``: K1/K2, ``"assoc"``,
    ``"seq"``; ``chain_kernel`` is whether it is the kernels),
    ``quad_kernel`` (the
    quadrature's route: its kernel family, or the plain version for every
    batch), ``quad_batches`` (per nonlinear batch, whether that batch takes
    the quadrature kernel where the call's ``eval_dtype`` is None or
    bfloat16; a float16 call takes the plain quadrature),
    ``fused_trials_ready``, ``fused_gradient_ready`` (K6 in the modes of
    ``gradient_modes``), ``gbp_trials_ready`` (K1's trial form for the
    batched line search: the chain on K1 at a block size of the wide
    layout, which no fused kernel covers, and every linear batch in
    residual form; its operands are ``_fused_ops``' linear half), and the
    ``eval_dtype`` the fused kernels round
    the offsets through, ``fused_eval_dtype`` / ``fused_grad_eval_dtype``
    (the config's ``moments_eval_dtype``: the loop takes a fused kernel
    only where its own eval_dtype matches, so prox, which never
    quantizes, takes neither under a bfloat16 config)."""

    # the modes of K6 the fused gradient step runs
    gradient_modes = ("full",)
    fused_eval_dtype = None
    fused_grad_eval_dtype = None

    def __init__(self, graph: FactorGraph, config, device: torch.device):
        self.graph = graph
        self.device = device
        self.use_pallas = config.use_pallas
        self.chain_impl = resolve_chain_impl(
            config, graph.num_states, device,
            chain.covers(graph.state_dim, graph.dtype))
        self.chain_kernel = self.chain_impl == "lanes"
        # quad_impl="auto" follows the resolved chain (the JAX package's
        # bundle); each batch then takes the kernel where it is covered
        quad_impl = config.quad_impl
        if quad_impl == "auto" and not self.chain_kernel:
            quad_impl = "xla"
        self.quad_kernel = use_kernel(quad_impl, "xla", "quad_impl", device)
        self.quad_batches = tuple(
            self.quad_kernel and use_kernel(quad_impl, "xla", "quad_impl",
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
        eval_dtype = mm.as_eval_dtype(config.moments_eval_dtype)
        if why_not is None and not mm.kernel_quantizes(eval_dtype):
            why_not = (f"moments_eval_dtype={config.moments_eval_dtype!r} "
                       "keeps the plain quadrature (the kernels round "
                       "offsets through bfloat16 only)")
        self.fused_trials_ready = _use_fused(
            "fused_trials", config.fused_trials,
            why_not or (None if config.linesearch == "batched"
                        else "linesearch must be 'batched'")
            or ft.covers(graph.state_dim, graph.dtype, *ops[:2]),
            self.quad_kernel)
        self.fused_gradient_ready = _use_fused(
            "fused_gradient", config.fused_gradient,
            why_not or fg.covers(graph.state_dim, self.gradient_modes,
                                 {fb.kernel_cost for fb in graph.nonlinear}),
            self.quad_kernel)
        if self.fused_trials_ready:
            self.fused_eval_dtype = eval_dtype
        if self.fused_gradient_ready:
            self.fused_grad_eval_dtype = eval_dtype
        self._fused_ops = ops if why_not is None else None
        lin = (linear_operands(graph) if self.chain_kernel
               and graph.state_dim in chain.WIDE_BLOCK_SIZES
               and not self.fused_trials_ready
               else "the trial form is K1's at s = 14, where K5 is not")
        self.gbp_trials_ready = not isinstance(lin, str)
        if self.gbp_trials_ready and self._fused_ops is None:
            self._fused_ops = ((), lin[0], (), lin[1])

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        """(cov_diag, cov_off, logdet) of the joint precision."""
        if self.chain_kernel:
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
        solve = (chain.solve_pair_lanes if self.chain_kernel
                 else chain.solve_pair_plain)
        return solve(bt_main.diag, bt_main.off, bt_fallback.diag,
                     bt_fallback.off, rhs)

    # -- fused kernels ---------------------------------------------------------
    def _flat_operands(self, batch, mu):
        """The fused operands with the problem axes flattened to one
        ``[B, ...]`` axis (B = prod(batch)); a patch-mode batch's params
        formed from the means ``mu [*batch, N, s]`` (the JAX package's
        ``_splice_preps``)."""
        nl_specs, lin_specs, nl_arrays, lin_arrays = self._fused_ops

        def flat(x, tail):
            return x.expand(*batch, *x.shape[x.ndim - tail:]).reshape(
                -1, *x.shape[x.ndim - tail:])

        nl = tuple(
            (st, nd, w, flat(p if fb.kernel_prep is None else fb.kernel_prep(
                take_states(mu, fb.start, fb.slice_offset, 1)), 2), *field)
            for fb, (st, nd, w, p, *field) in zip(self.graph.nonlinear,
                                                   nl_arrays))
        lin = tuple((st, flat(a, 4), flat(lam, 3), flat(pm, 2), flat(pc, 3))
                    for st, a, lam, pm, pc in lin_arrays)
        return nl_specs, lin_specs, nl, lin

    def fused_trial_costs(self, state: GaussianState, dmu,
                          dprec: BlockTridiag, trials):
        """All line-search trials in one kernel (K5): ``(ld [T, ...],
        fc tuple of [T, ..., K])``, nonlinear batches first, then linear
        (the order of :meth:`factor_costs_raw`)."""
        batch = state.mu.shape[:-2]

        def flat(x):
            return x.reshape(-1, *x.shape[len(batch):])

        prec = state.precision
        ld, fc = trial_costs_lanes(
            flat(state.mu), flat(dmu), flat(prec.diag), flat(prec.off),
            flat(dprec.diag), flat(dprec.off), trials,
            *self._flat_operands(batch, state.mu),
            eval_dtype=self.fused_eval_dtype)
        t = trials.shape[0]
        return (ld.reshape(t, *batch),
                tuple(f.reshape(t, *batch, f.shape[-1]) for f in fc))

    def gbp_trials(self, state: GaussianState, dmu, dprec: BlockTridiag,
                   trials):
        """Every line-search trial's chain in one launch of K1's trial form
        (``kernels/chain.py`` ``gbp_trials_lanes``): ``(cov_diag [T, ...,
        N, s, s], cov_off, logdet [T, ...], linear fc tuple of [T, ...,
        K])``, the linear batches' untempered costs in
        :meth:`factor_costs_raw`'s order."""
        batch = state.mu.shape[:-2]

        def flat(x):   # an N = 1 chain has no off-diagonal blocks
            return x.reshape(batch.numel(), *x.shape[len(batch):])

        def unflat(x):
            return x.reshape(x.shape[0], *batch, *x.shape[2:])

        _, lin_specs, _, lin = self._flat_operands(batch, state.mu)
        prec = state.precision
        out = chain.gbp_trials_lanes(
            flat(prec.diag), flat(prec.off), flat(dprec.diag), flat(dprec.off),
            flat(state.mu), flat(dmu), trials, lin_specs, lin)
        cd, co, ld, fc = out
        return unflat(cd), unflat(co), unflat(ld), tuple(unflat(f) for f in fc)

    def fused_gradient(self, state: GaussianState, temperature):
        """The whole NGD gradient step in one kernel (K6): covariance of
        the current iterate, joint (Vdmu, Vddmu), both solves; a
        patch-mode batch's windows follow the current means.  Returns
        ``(cov_diag, cov_off, logdet, dprec BlockTridiag, dmu,
        dmu_fallback)``."""
        batch = state.mu.shape[:-2]

        def flat(x):
            return x.reshape(-1, *x.shape[len(batch):])

        def unflat(x):
            return x.reshape(batch + x.shape[1:])

        prec = state.precision
        out = gradient_lanes(
            flat(state.mu), flat(prec.diag), flat(prec.off),
            temperature.reshape(-1), *self._flat_operands(batch, state.mu),
            eval_dtype=self.fused_grad_eval_dtype)
        cd, co, ld, dpd, dpo, dmu, dfb = (unflat(x) for x in out)
        return cd, co, ld, BlockTridiag(dpd, dpo), dmu, dfb

    @staticmethod
    def all_finite(x: torch.Tensor) -> torch.Tensor:
        """Per problem: is every element of ``x [..., N, s]`` finite."""
        return torch.isfinite(x).flatten(-2).all(-1)
