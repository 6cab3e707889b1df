"""Factor batches: all factors of one type, batched over problems.

Counterpart of ``gaussianvi_tpu/factors/base.py``.  A factor spans ``nb``
consecutive trajectory states of dimension ``s``; its local dim is
``d = nb * s``.  Per-factor data carries the problem axis first
(``[B, K, ...]``; a single problem may omit it); the quadrature rule and,
when they agree across problems, the start indices are shared.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..quadrature.table import get_rule


@dataclass(frozen=True)
class NonlinearFactorBatch:
    """K same-type nonlinear factors integrated by sigma-point quadrature.

    ``cost_fn(pts [M, ..., K, d], params) -> [M, ..., K]`` is the negative
    log potential, sigma-point axis first; ``params`` is a dict whose
    leaves are ``[B, K, *leaf]`` (``[K, *leaf]`` for one problem) and
    broadcast against the points' component arrays from the right.
    ``nodes [M, d]``/``weights [M]`` are the shared zero-mean rule.

    ``kernel_cost`` names the CUDA cost functor (``csrc/costs.cuh``) that
    the quadrature kernel evaluates in place of ``cost_fn``;
    ``kernel_params [B, K, P]`` are the leaves packed for it in sorted-key
    order (:func:`pack_params`); ``kernel_field`` is the one tensor the
    functor reads in place where it reads one (a signed-distance field),
    shared by every factor and problem, like the rule.  The kernel path
    raises for a batch that names no functor.

    ``kernel_prep`` (the patch mode's planner batches, counterpart of the
    JAX package's ``lanes_prep``): ``kernel_prep(mu_k [..., K, d]) ->
    kernel_params [..., K, P]``, the params for factors whose marginal
    means are ``mu_k``, for a functor whose params carry a window that
    follows the mean; the kernel routes call it before every launch
    (``moments.kernel_params_at``), with the trial means on the line
    search's cost path and the current means on the gradient path.  Such
    a batch's ``kernel_params`` hold the same row with every window at the
    field's origin.

    ``block_cost`` says the batch has a block form, which the block-form
    moments kernel (``kernels/fused_moments.py``, ``GVIConfig.use_pallas``)
    integrates: on the card that is the functor ``kernel_cost`` names; the
    field itself is the same cost in PyTorch,
    ``block_cost(pts [..., d], *leaves [..., *leaf]) -> [...]`` with the
    leaves in sorted-key order, which the kernel's plain version evaluates.
    """

    start: torch.Tensor          # [K] (shared) or [B, K] int64
    nodes: torch.Tensor          # [M, d]
    weights: torch.Tensor        # [M]
    params: dict | None
    cost_fn: Callable
    nb: int = 1
    kernel_cost: str | None = None
    kernel_params: torch.Tensor | None = None   # [B, K, P]
    kernel_field: torch.Tensor | None = None    # shared, e.g. [rows, cols]
    kernel_prep: Callable | None = None
    block_cost: Callable | None = None
    # start == slice_offset + arange(K): gathers/scatters become slices
    slice_offset: int | None = None
    # start indices identical across the stacked problems
    shared_start: bool = True
    # contract: cost_fn >= 0 everywhere; negative E[phi] estimates inside
    # the rounding band are poisoned (moments.expectation_phi)
    nonneg_cost: bool = False
    # marginal quadrature: cost reads only the leading quad_rdim dims and
    # ``nodes`` hold an r-dim rule zero-padded to d (marginal_rule)
    quad_rdim: int | None = None

    @property
    def num_factors(self) -> int:
        return self.start.shape[-1]

    @property
    def dim(self) -> int:
        return self.nodes.shape[-1]


@dataclass(frozen=True)
class LinearFactorBatch:
    """K closed-form linear-Gaussian factors,
    ``psi(x) = C ||Lam x - Psi mu_t||^2_{prec_t}``."""

    start: torch.Tensor          # [K] (shared) or [B, K] int64
    lam: torch.Tensor            # [B, K, r, d]
    psi: torch.Tensor            # [B, K, r, dt]
    target_mu: torch.Tensor      # [B, K, dt]
    target_prec: torch.Tensor    # [B, K, r, r]
    constant: torch.Tensor       # [B, K]
    nb: int = 1
    slice_offset: int | None = None
    # all K rows equal (e.g. a constant-dt minimum-acc prior)
    uniform: bool = False
    shared_start: bool = True

    @property
    def num_factors(self) -> int:
        return self.start.shape[-1]

    @property
    def dim(self) -> int:
        return self.lam.shape[-1]


def param_leaves(params: dict | None) -> tuple:
    """The param leaves in sorted-key order (``jax.tree.leaves`` order)."""
    return tuple(params[k] for k in sorted(params)) if params else ()


def pack_params(params: dict) -> torch.Tensor:
    """One problem's leaves ``[K, *leaf]`` in sorted-key order (the
    ``jax.tree.leaves`` order the JAX kernels take them in), flattened and
    concatenated into ``[K, P]``."""
    return torch.cat(
        [p.reshape(p.shape[0], -1) for p in param_leaves(params)], dim=-1)


def make_nonlinear_batch(
    cost_fn: Callable,
    start_indices,
    state_dim: int,
    nb: int = 1,
    params: dict | None = None,
    gh_degree: int = 10,
    kind: str = "sparse",
    kernel_cost: str | None = None,
    block_cost: Callable | None = None,
    nonneg_cost: bool = False,
    quad_rdim: int | None = None,
    dtype=torch.float64,
    device=None,
) -> NonlinearFactorBatch:
    """Build a NonlinearFactorBatch with a (dim, degree) quadrature rule
    (the configuration-marginal rule when ``quad_rdim < nb * state_dim``)."""
    device = resolve_device(device)
    dim = nb * state_dim
    if quad_rdim is not None and quad_rdim < dim:
        nodes, weights = marginal_rule(dim, quad_rdim, gh_degree, kind)
    else:
        nodes, weights = get_rule(dim, gh_degree, kind)
        quad_rdim = None
    start_np = np.asarray(start_indices, dtype=np.int64)
    return NonlinearFactorBatch(
        start=torch.as_tensor(start_np, device=device),
        nodes=torch.as_tensor(np.asarray(nodes), dtype=dtype, device=device),
        weights=torch.as_tensor(np.asarray(weights), dtype=dtype,
                                device=device),
        params=params,
        cost_fn=cost_fn,
        nb=nb,
        kernel_cost=kernel_cost,
        kernel_params=(pack_params(params)
                       if kernel_cost is not None and params else None),
        block_cost=block_cost,
        nonneg_cost=nonneg_cost,
        quad_rdim=quad_rdim,
        slice_offset=detect_slice_offset(start_np),
    )


def marginal_rule(state_dim: int, config_dim: int, gh_degree: int,
                  kind: str = "sparse"):
    """``config_dim``-dim rule zero-padded to ``state_dim`` (numpy)."""
    nodes, weights = get_rule(config_dim, gh_degree, kind)
    nodes = np.asarray(nodes)
    pad = np.zeros((nodes.shape[0], state_dim - config_dim), nodes.dtype)
    return np.concatenate([nodes, pad], axis=1), weights


def detect_slice_offset(start_np) -> int | None:
    """offset such that start == offset + arange(K), else None (K == 1
    batches return None, as in the JAX package)."""
    start_np = np.asarray(start_np)
    if start_np.ndim != 1 or start_np.size < 2:
        return None
    o = int(start_np[0])
    if np.array_equal(start_np, o + np.arange(start_np.size)):
        return o
    return None
