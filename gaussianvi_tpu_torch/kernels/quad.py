"""Sigma-point quadrature kernel (K3), phi-only and moments variants.

Counterpart of ``gaussianvi_tpu/kernels/quad_lanes.py``.  The cost is not a
Python callable here: a factor batch names a CUDA functor
(``csrc/costs.cuh``) with ``kernel_cost`` and carries its params packed as
``[..., K, P]``.  :data:`KERNEL_COSTS` maps each name to the functor's id
and to its plain PyTorch form (same arithmetic, same packed params), which
the plain versions evaluate.

Each wrapper launches the kernel (``csrc/quad.cu``, one thread per
(problem, factor) pair) for GPU tensors and runs the plain version for CPU
tensors; ``<wrapper>.launches`` counts kernel launches only.
"""

from __future__ import annotations

import math

import torch

from ..factors.moments import expectation_phi, gh_moments
from . import _build



def _range_cost_packed(x, p):
    """(r - |pos - beacon|)^2 / (2 sig_r^2); ``p = [beacon..., r, sig_r_sq]``
    (``RangeCost`` in csrc/costs.cuh).  ``x [M, ..., d]``, ``p [..., P]``."""
    dim_x = p.shape[-1] - 2
    d2 = 0
    for j in range(dim_x):
        d2 = d2 + (x[..., j] - p[..., j]) ** 2
    dist = torch.sqrt(d2 + 1e-12)
    return (p[..., dim_x] - dist) ** 2 / (2.0 * p[..., dim_x + 1])


# name -> (functor id in csrc/costs.cuh, plain PyTorch form, instantiated
# local dims d with their param counts P)
KERNEL_COSTS = {
    "range": (0, _range_cost_packed, {2: 3, 4: 4}),
}

_MAX_SMEM = 48 * 1024


def quad_phi_plain(mu, cov, nodes, weights, cost, params, nonneg=False):
    """Plain version of the phi-only variant: guarded E[phi] [..., K]
    (``moments.expectation_phi`` with the named cost's PyTorch form)."""
    return expectation_phi(nodes, weights, mu, cov, KERNEL_COSTS[cost][1],
                           params, nonneg=nonneg)


def quad_moments_plain(mu, cov, nodes, weights, cost, params, rdim=None):
    """Plain version of the moments variant (``moments.gh_moments`` with
    the named cost's PyTorch form), marginal-rule lift included."""
    return gh_moments(nodes, weights, mu, cov, KERNEL_COSTS[cost][1], params,
                      rdim=rdim)


def covers(cost: str | None, d: int, p: int, m: int,
           dtype: torch.dtype) -> str | None:
    """Why K3 does not cover a batch with the kernel cost ``cost`` (P =
    ``p`` packed params) at local dim ``d`` on an ``m``-node rule in
    ``dtype``, or None where it does.  The engine resolves
    ``quad_impl="auto"`` per batch by it; the wrappers check it."""
    if cost is None:
        return ("the quadrature kernels need a factor batch with kernel_cost "
                "and kernel_params set (a CUDA cost functor in "
                "csrc/costs.cuh)")
    if cost not in KERNEL_COSTS:
        return f"unknown kernel cost {cost!r} (have {sorted(KERNEL_COSTS)})"
    dims = KERNEL_COSTS[cost][2]
    if dims.get(d) != p:
        return f"cost {cost!r} not instantiated for d={d}, P={p} (have {dims})"
    if dtype not in _build.DTYPES:
        return f"dtype {dtype} not supported (float32 or float64)"
    if m * (d + 1) * dtype.itemsize > _MAX_SMEM:
        return f"rule of {m} nodes exceeds shared memory"
    return None


def _launch(name, mu, cov, nodes, weights, cost, params, with_moments,
            nonneg, rdim):
    d = mu.shape[-1]
    k = mu.shape[-2]
    lead = mu.shape[:-2]
    p = params.shape[-1]
    m = nodes.shape[0]
    why = covers(cost, d, p, m, mu.dtype)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    cost_id = KERNEL_COSTS[cost][0]
    for t in (cov, nodes, weights, params):
        if t.device != mu.device or t.dtype != mu.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    if cov.shape != (*lead, k, d, d) or nodes.ndim != 2 or nodes.shape[1] != d:
        raise ValueError(f"{name}: shape mismatch mu {tuple(mu.shape)}, "
                         f"cov {tuple(cov.shape)}, nodes {tuple(nodes.shape)}")
    count = math.prod(lead) * k
    mu_l = mu.reshape(count, d).t().contiguous()
    cov_l = cov.reshape(count, d * d).t().contiguous()
    par_l = params.expand(*lead, k, p).reshape(count, p).t().contiguous()
    nodes_c, weights_c = nodes.contiguous(), weights.contiguous()
    e_phi = torch.empty((count,), dtype=mu.dtype, device=mu.device)
    e_xmu = e_xxt = e_phi
    if with_moments:
        e_xmu = torch.empty((d, count), dtype=mu.dtype, device=mu.device)
        e_xxt = torch.empty((d * d, count), dtype=mu.dtype, device=mu.device)
    err = _build.load().gvi_quad(
        _build.DTYPES[mu.dtype], d, cost_id, int(with_moments),
        mu_l.data_ptr(), cov_l.data_ptr(), nodes_c.data_ptr(), weights_c.data_ptr(),
        par_l.data_ptr(), e_phi.data_ptr(),
        e_xmu.data_ptr(), e_xxt.data_ptr(), count, m, p, int(nonneg),
        d if rdim is None else rdim,
        torch.cuda.current_stream(mu.device).cuda_stream,
    )
    _build.check(err, "gvi_quad")
    if not with_moments:
        return e_phi.reshape(*lead, k)
    return (e_phi.reshape(*lead, k), e_xmu.t().reshape(*lead, k, d),
            e_xxt.t().reshape(*lead, k, d, d))


def quad_lanes_phi(mu, cov, nodes, weights, cost: str, params,
                   nonneg: bool = False):
    """K3, phi-only: ``mu [..., K, d]``, ``cov [..., K, d, d]``,
    ``nodes [M, d]``, ``weights [M]``, packed ``params`` broadcastable to
    ``[..., K, P]`` -> guarded E[phi] ``[..., K]``."""
    if mu.device.type == "cpu":
        return quad_phi_plain(mu, cov, nodes, weights, cost, params, nonneg)
    out = _launch("quad_lanes_phi", mu, cov, nodes, weights, cost, params,
                  False, nonneg, None)
    quad_lanes_phi.launches += 1
    return out


def quad_lanes_moments(mu, cov, nodes, weights, cost: str, params,
                       rdim: int | None = None):
    """K3, moments: as :func:`quad_lanes_phi` -> (E[phi] ``[..., K]``,
    E[(x-mu)phi] ``[..., K, d]``, E[(x-mu)(x-mu)^T phi] ``[..., K, d, d]``),
    unguarded, with the marginal-rule lift for ``rdim``."""
    if mu.device.type == "cpu":
        return quad_moments_plain(mu, cov, nodes, weights, cost, params, rdim)
    out = _launch("quad_lanes_moments", mu, cov, nodes, weights, cost,
                  params, True, False, rdim)
    quad_lanes_moments.launches += 1
    return out


quad_lanes_phi.launches = 0
quad_lanes_moments.launches = 0
