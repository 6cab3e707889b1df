"""Backend hooks for the GVI iteration loop (single device).

Counterpart of ``gaussianvi_tpu/inference/engine.py`` :class:`LocalEngine`.
The engine resolves ``chain_impl``, ``quad_impl``, ``fused_trials`` and
``fused_gradient`` once, from the config, the graph and the device the
problem lives on, and exposes the loop's hooks over problem-batched
tensors: every result is per problem, never reduced over a leading axis.
"""

from __future__ import annotations

import torch

from ..factors import moments as mm
from ..kernels.chain import gbp_covariance_logdet_lanes, solve_lanes
from ..kernels.fused_gradient import gradient_lanes
from ..kernels.fused_trials import (
    LinTrialSpec,
    NLTrialSpec,
    linear_residual_form,
    trial_costs_lanes,
)
from ..ops.blocktridiag import BlockTridiag
from ..ops.blocktridiag import gbp_covariance_logdet as gbp_plain
from ..ops.blocktridiag import solve as solve_plain
from .gvi import ngd_gradients, prox_gradients
from .graph import FactorGraph, GaussianState, gather_marginals

_TODO = "not ported yet (ROADMAP.md, Queue A)"


def use_kernel(impl: str, plain: str, field: str, device: torch.device) -> bool:
    """Resolve an implementation switch: ``"auto"`` -> the CUDA kernel for
    GPU tensors and the plain version for CPU tensors; ``"lanes"`` -> the
    kernel (raises for CPU tensors); ``plain`` -> the plain version."""
    if impl == "auto":
        return device.type == "cuda"
    if impl == "lanes":
        if device.type != "cuda":
            raise ValueError(f"{field}='lanes' runs the CUDA kernels; the "
                             f"problem's tensors are on {device}")
        return True
    if impl == plain:
        return False
    raise NotImplementedError(f"{field}={impl!r} is {_TODO}")


def check_config(config, method: str) -> None:
    """Raise for every option the port does not cover yet."""
    if method not in ("ngd", "prox"):
        raise ValueError(f"unknown method {method!r}")
    for name in ("fused_trials", "fused_gradient"):
        value = getattr(config, name)
        if value not in ("auto", "on", "off"):
            raise ValueError(f"unknown {name} {value!r}")
    if config.fused_trials == "on" and config.linesearch != "batched":
        raise ValueError("fused_trials='on' needs linesearch='batched' (the "
                         "kernel evaluates every trial at once)")
    if config.linesearch != "batched":
        raise NotImplementedError(f"linesearch={config.linesearch!r} is {_TODO}")
    if config.ema_alpha != 1.0:
        raise NotImplementedError(f"ema_alpha != 1 is {_TODO}")
    if config.moments_eval_dtype is not None:
        raise NotImplementedError(f"moments_eval_dtype is {_TODO}")


def fused_operands(graph: FactorGraph):
    """Static eligibility and operand prep shared by the fused trial and
    gradient kernels (``engine._build_fused_specs`` in the JAX package):
    ``(nl_specs, lin_specs, nl_arrays, lin_arrays)`` as
    ``kernels/fused_trials.py`` describes them, or a string saying why the
    graph is not eligible.  Per-problem leaves keep the graph's leading
    axes."""
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
        nl_specs.append(NLTrialSpec(fb.kernel_cost, fb.num_factors,
                                    fb.nodes.shape[0], fb.slice_offset,
                                    fb.quad_rdim, fb.nonneg_cost))
        nl_arrays.append((fb.start, fb.nodes, fb.weights, fb.kernel_params))
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
    return (tuple(nl_specs), tuple(lin_specs), tuple(nl_arrays),
            tuple(lin_arrays))


def _use_fused(field: str, value: str, why_not: str | None,
               kernels: bool) -> bool:
    """``"auto"`` -> the fused kernel when eligible and the chain and
    quadrature run the kernels; ``"on"`` -> asserts eligibility (raises
    ``ValueError``); ``"off"`` -> the separate path."""
    if value == "on":
        if why_not is not None:
            raise ValueError(f"{field}='on' but the graph/config is not "
                             f"eligible: {why_not}")
        return True
    return value == "auto" and why_not is None and kernels


class LocalEngine:
    """Single-device hooks: the whole (problem-batched) graph lives on one
    device."""

    def __init__(self, graph: FactorGraph, config, device: torch.device):
        self.graph = graph
        self.use_pallas = config.use_pallas
        self.chain_kernel = use_kernel(config.chain_impl, "seq",
                                       "chain_impl", device)
        self.quad_kernel = use_kernel(config.quad_impl, "xla", "quad_impl",
                                      device)
        if self.quad_kernel:
            for fb in graph.nonlinear:
                if fb.nb != 1:
                    raise NotImplementedError(
                        f"nonlinear factors spanning nb={fb.nb} states on "
                        f"the quadrature kernel are {_TODO}")
        # the fused kernels stand in for the chain and quadrature kernels:
        # "on" is refused where those are forced to their plain versions
        ops = fused_operands(graph)
        why_not = ops if isinstance(ops, str) else None
        if config.chain_impl == "seq" or config.quad_impl == "xla":
            why_not = "chain_impl='seq' / quad_impl='xla' force the plain path"
        kernels = self.chain_kernel and self.quad_kernel
        self.fused_trials_ready = _use_fused(
            "fused_trials", config.fused_trials,
            why_not or (None if config.linesearch == "batched"
                        else "linesearch must be 'batched'"), kernels)
        self.fused_gradient_ready = _use_fused(
            "fused_gradient", config.fused_gradient, why_not, kernels)
        self._fused_ops = ops if why_not is None else None

    # -- chain ---------------------------------------------------------------
    def cov_logdet(self, prec: BlockTridiag):
        """(cov_diag, cov_off, logdet) of the joint precision."""
        if self.chain_kernel:
            return gbp_covariance_logdet_lanes(prec.diag, prec.off)
        return gbp_plain(prec)

    # -- costs ---------------------------------------------------------------
    def factor_costs_raw(self, mu, cov_diag, cov_off):
        """Untempered per-factor E[psi_k], one ``[..., K]`` tensor per batch
        (nonlinear batches first, then linear)."""
        g = self.graph
        out = []
        for fb in g.nonlinear:
            mu_k, cov_k = gather_marginals(fb.start, fb.nb, mu, cov_diag,
                                           cov_off, fb.slice_offset)
            out.append(mm.batch_phi(fb, mu_k, cov_k, self.quad_kernel))
        for lb in g.linear:
            out.append(mm.batch_linear_cost(lb, mu, cov_diag, cov_off))
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
    def ngd_gradients(self, mu, cov_diag, cov_off, temperature):
        return ngd_gradients(self.graph, mu, cov_diag, cov_off, temperature,
                             self.use_pallas, self.quad_kernel)

    def prox_gradients(self, mu, cov_diag, cov_off, step_size):
        return prox_gradients(self.graph, mu, cov_diag, cov_off, step_size,
                              self.quad_kernel)

    # -- solve ---------------------------------------------------------------
    def solve_pair(self, bt_main: BlockTridiag, bt_fallback: BlockTridiag,
                   rhs):
        """Solve both systems (main metric + SPD fallback) against the same
        rhs ``[..., N, s]`` in ONE chain call (2B chains)."""
        diag = torch.stack([bt_main.diag, bt_fallback.diag])
        off = torch.stack([bt_main.off, bt_fallback.off])
        b = rhs.expand(2, *rhs.shape)
        if self.chain_kernel:
            sols = solve_lanes(diag, off, b)
        else:
            sols = solve_plain(BlockTridiag(diag, off), b)
        return sols[0], sols[1]

    # -- fused kernels ---------------------------------------------------------
    def _flat_operands(self, batch):
        """The fused operands with the problem axes flattened to one
        ``[B, ...]`` axis (B = prod(batch))."""
        nl_specs, lin_specs, nl_arrays, lin_arrays = self._fused_ops

        def flat(x, tail):
            return x.expand(*batch, *x.shape[x.ndim - tail:]).reshape(
                -1, *x.shape[x.ndim - tail:])

        nl = tuple((st, nd, w, flat(p, 2)) for st, nd, w, p in nl_arrays)
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
            *self._flat_operands(batch))
        t = trials.shape[0]
        return (ld.reshape(t, *batch),
                tuple(f.reshape(t, *batch, f.shape[-1]) for f in fc))

    def fused_gradient(self, state: GaussianState, temperature):
        """The whole NGD gradient step in one kernel (K6): covariance of
        the current iterate, joint (Vdmu, Vddmu), both solves.  Returns
        ``(cov_diag, cov_off, logdet, dprec BlockTridiag, dmu,
        dmu_fallback)``."""
        batch = state.mu.shape[:-2]

        def flat(x):
            return x.reshape(-1, *x.shape[len(batch):])

        def unflat(x):
            return x.reshape(*batch, *x.shape[1:])

        prec = state.precision
        out = gradient_lanes(
            flat(state.mu), flat(prec.diag), flat(prec.off),
            temperature.reshape(-1), *self._flat_operands(batch))
        cd, co, ld, dpd, dpo, dmu, dfb = (unflat(x) for x in out)
        return cd, co, ld, BlockTridiag(dpd, dpo), dmu, dfb

    @staticmethod
    def all_finite(x: torch.Tensor) -> torch.Tensor:
        """Per problem: is every element of ``x [..., N, s]`` finite."""
        return torch.isfinite(x).flatten(-2).all(-1)
