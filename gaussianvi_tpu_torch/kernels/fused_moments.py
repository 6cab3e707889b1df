"""Block-form sigma-point moments kernel (K4).

Counterpart of ``gaussianvi_tpu/kernels/fused_moments.py``
(``fused_moments``): from the factors' marginals, the shared rule and the
cost, one pass gives E[phi] ``[..., K]``, E[(x-mu) phi] ``[..., K, d]`` and
E[(x-mu)(x-mu)^T phi] ``[..., K, d, d]`` without the sigma points ever
reaching device memory.  Unguarded (the gradient path).  Unlike the JAX
kernel's caller, this one applies the marginal-rule lift
``L[:, r:] L[:, r:]^T E[phi]`` for ``rdim``, so a rule over the leading
``rdim`` dims gives the moments of ``factors.moments.gh_moments``.

The Cholesky factor is taken outside the kernel with ``chol_small``, as
the JAX wrapper does; leading axes flatten onto one factor axis.  On the
card the cost is the CUDA functor ``kernel_cost`` names
(``csrc/costs.cuh``) with its packed params; the kernel
(``csrc/fused_moments.cu``) runs one warp per factor with the rule's nodes
across the lanes.  For CPU tensors the wrapper runs
:func:`fused_moments_plain`, which takes the cost as a block-form callable
(``NonlinearFactorBatch.block_cost`` with the param leaves, or the
functor's PyTorch form with the packed params as its one leaf);
``fused_moments.launches`` counts kernel launches only.
"""

from __future__ import annotations

import math

import torch

from ..ops.smallmat import chol_small
from . import _build
from .quad import _MAX_SMEM, KERNEL_COSTS


def fused_moments_plain(nodes, weights, mu, cov, block_cost, params=(),
                        rdim=None):
    """Plain version, step by step: ``mu [K, d]``, ``cov [K, d, d]``,
    ``block_cost(pts [K, M, d], *rows [K, 1, *leaf]) -> [K, M]`` with
    ``params`` a tuple of leaves with leading K."""
    chol = chol_small(cov)                                   # [K, d, d]
    # diff[k, m, e] = sum_d nodes[m, d] * chol[k, e, d]
    diff = torch.sum(nodes[None, :, None, :] * chol[:, None, :, :], dim=-1)
    pts = diff + mu[:, None, :]                              # [K, M, d]
    phi = block_cost(pts, *[p[:, None] for p in params])     # [K, M]
    wphi = phi * weights[None, :]
    e_phi = torch.sum(wphi, dim=1)
    wd = wphi[:, :, None] * diff                             # [K, M, d]
    e_xmu = torch.sum(wd, dim=1)
    e_xxt = torch.sum(wd[:, :, :, None] * diff[:, :, None, :], dim=1)
    if rdim is not None and rdim < mu.shape[-1]:
        lhi = chol[..., rdim:]
        e_xxt = e_xxt + (lhi @ lhi.transpose(-1, -2)) * e_phi[:, None, None]
    return e_phi, e_xmu, e_xxt


def _launch(nodes, weights, mu, chol, cost, params, rdim):
    """One kernel launch on flat factor-major operands ``mu [K, d]``,
    ``chol [K, d, d]``, ``params [K, P]``."""
    if cost not in KERNEL_COSTS:
        raise ValueError(f"fused_moments: unknown kernel cost {cost!r} "
                         f"(have {sorted(KERNEL_COSTS)})")
    cost_id, _, dims = KERNEL_COSTS[cost]
    k, d = mu.shape
    p = params.shape[-1]
    if dims.get(d) != p:
        raise ValueError(f"fused_moments: cost {cost!r} not instantiated for "
                         f"d={d}, P={p} (have {dims})")
    if mu.dtype not in _build.DTYPES:
        raise ValueError(f"fused_moments: dtype {mu.dtype} not supported")
    for t in (chol, nodes, weights, params):
        if t.device != mu.device or t.dtype != mu.dtype:
            raise ValueError("fused_moments: operands on different "
                             "devices/dtypes")
    if nodes.ndim != 2 or nodes.shape[1] != d:
        raise ValueError(f"fused_moments: rule {tuple(nodes.shape)} does not "
                         f"match d={d}")
    m = nodes.shape[0]
    if m * (d + 1) * mu.element_size() > _MAX_SMEM:
        raise ValueError(f"fused_moments: rule of {m} nodes exceeds shared "
                         "memory")
    e_phi = torch.empty((k,), dtype=mu.dtype, device=mu.device)
    e_xmu = torch.empty((k, d), dtype=mu.dtype, device=mu.device)
    e_xxt = torch.empty((k, d, d), dtype=mu.dtype, device=mu.device)
    err = _build.load().gvi_fused_moments(
        _build.DTYPES[mu.dtype], d, cost_id, mu.data_ptr(), chol.data_ptr(),
        nodes.data_ptr(), weights.data_ptr(), params.data_ptr(),
        e_phi.data_ptr(), e_xmu.data_ptr(), e_xxt.data_ptr(), k, m, p,
        d if rdim is None else rdim,
        torch.cuda.current_stream(mu.device).cuda_stream,
    )
    _build.check(err, "gvi_fused_moments")
    return e_phi, e_xmu, e_xxt


def fused_moments(nodes, weights, mu, cov, kernel_cost, kernel_params,
                  rdim: int | None = None):
    """K4: ``nodes [M, d]``, ``weights [M]``, ``mu [..., K, d]``,
    ``cov [..., K, d, d]``, the cost as the functor name ``kernel_cost``
    with ``kernel_params`` (packed, broadcastable to ``[..., K, P]``) ->
    the three moments, with the marginal-rule lift for ``rdim``.

    GPU tensors launch the kernel; CPU tensors run the plain version with
    the functor's PyTorch form, which is a block cost with the packed
    params as its one leaf."""
    if kernel_cost is None or kernel_params is None:
        raise ValueError(
            "the block-form moments kernel needs a factor batch with "
            "kernel_cost and kernel_params set (a CUDA cost functor in "
            "csrc/costs.cuh)")
    lead = mu.shape[:-1]
    d = mu.shape[-1]
    count = math.prod(lead)
    if cov.shape != (*lead, d, d):
        raise ValueError(f"fused_moments: shape mismatch mu {tuple(mu.shape)},"
                         f" cov {tuple(cov.shape)}")
    p = kernel_params.shape[-1]
    mu_f, cov_f = mu.reshape(count, d), cov.reshape(count, d, d)
    par_f = kernel_params.expand(*lead, p).reshape(count, p)
    if mu.device.type == "cpu":
        out = fused_moments_plain(nodes, weights, mu_f, cov_f,
                                  KERNEL_COSTS[kernel_cost][1], (par_f,),
                                  rdim)
    else:
        out = _launch(nodes.contiguous(), weights.contiguous(),
                      mu_f.contiguous(), chol_small(cov_f).contiguous(),
                      kernel_cost, par_f.contiguous(), rdim)
        fused_moments.launches += 1
    e_phi, e_xmu, e_xxt = out
    return (e_phi.reshape(lead), e_xmu.reshape(*lead, d),
            e_xxt.reshape(*lead, d, d))


fused_moments.launches = 0
