"""Backend hooks for the GVI iteration loop (single device).

Counterpart of ``gaussianvi_tpu/inference/engine.py`` :class:`LocalEngine`,
separate-kernel path only.  The engine resolves ``chain_impl`` and
``quad_impl`` once, from the config and the device the problem lives on,
and exposes the loop's hooks over problem-batched tensors: every result is
per problem, never reduced over a leading axis.
"""

from __future__ import annotations

import torch

from ..factors import moments as mm
from ..kernels.chain import gbp_covariance_logdet_lanes, solve_lanes
from ..ops.blocktridiag import BlockTridiag
from ..ops.blocktridiag import gbp_covariance_logdet as gbp_plain
from ..ops.blocktridiag import solve as solve_plain
from .gvi import ngd_gradients
from .graph import FactorGraph, gather_marginals

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
    if method != "ngd":
        raise NotImplementedError(f"method={method!r} is {_TODO}")
    for name in ("fused_trials", "fused_gradient"):
        value = getattr(config, name)
        if value == "on":
            raise NotImplementedError(
                f"{name}='on': the fused kernels are {_TODO}; 'auto' runs "
                "the separate kernels")
        if value not in ("auto", "off"):
            raise ValueError(f"unknown {name} {value!r}")
    if config.linesearch != "batched":
        raise NotImplementedError(f"linesearch={config.linesearch!r} is {_TODO}")
    if config.ema_alpha != 1.0:
        raise NotImplementedError(f"ema_alpha != 1 is {_TODO}")
    if config.moments_eval_dtype is not None:
        raise NotImplementedError(f"moments_eval_dtype is {_TODO}")
    if config.use_pallas:
        raise NotImplementedError(f"use_pallas is {_TODO}")


class LocalEngine:
    """Single-device hooks: the whole (problem-batched) graph lives on one
    device."""

    def __init__(self, graph: FactorGraph, config, device: torch.device):
        self.graph = graph
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

    @staticmethod
    def reduce_fc(fc_tuple, like: torch.Tensor) -> torch.Tensor:
        """Per-problem sum of (already tempered) per-factor costs,
        ``[..., K] -> [...]``, in the JAX package's order."""
        total = torch.zeros_like(like)
        for f in fc_tuple:
            total = total + f.sum(-1)
        return total

    # -- gradients -----------------------------------------------------------
    def ngd_gradients(self, mu, cov_diag, cov_off, temperature):
        return ngd_gradients(self.graph, mu, cov_diag, cov_off, temperature,
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

    @staticmethod
    def all_finite(x: torch.Tensor) -> torch.Tensor:
        """Per problem: is every element of ``x [..., N, s]`` finite."""
        return torch.isfinite(x).flatten(-2).all(-1)
