"""Sigma-point quadrature kernel (K3), phi-only and moments variants.

Counterpart of ``gaussianvi_tpu/kernels/quad_lanes.py``.  The cost is not a
Python callable here: a factor batch names a CUDA functor
(``csrc/costs.cuh``) with ``kernel_cost`` and carries its params packed as
``[..., K, P]``.  :data:`KERNEL_COSTS` maps each name to the functor's id
and to its plain PyTorch form (same arithmetic, same packed params), which
the plain versions evaluate.

Each wrapper launches the kernel (``csrc/quad.cu`` -> ``csrc/quad.cuh``:
a group of lanes per factor, sized by :func:`quad_plan`) for GPU tensors
and runs the plain version for CPU tensors; ``<wrapper>.launches`` counts
kernel launches only.  The kernel reads the operands where they lie: mu
and cov at their batch and factor strides, the params through their
broadcast (a period over the flat factor index), and writes outputs
allocated in their final shapes; an operand is copied only where the
kernel cannot read it in place (a non-dense block, leading axes that do
not collapse, or a broadcast other than over leading axes).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

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
    if quad_plan(m, d, True, dtype).smem > _MAX_SMEM:
        return f"rule of {m} nodes exceeds shared memory"
    return None


class QuadPlan(NamedTuple):
    """How the quadrature kernels (csrc/quad.cuh) lay factors on the card."""

    group: int        # lanes per factor, a power of two from 1 to 32
    threads: int      # threads per block
    smem: int         # dynamic shared memory of a block, bytes: the rule,
                      # and for the moments each warp's staging area


# Lanes per factor, fixed by ``scripts/torch_profile.py --quad-plans`` on
# an H100 (PERF.md, section 6) for the 7-, 29- and 137-node rules in
# float32 and float64.  Each further lane of a group repeats the factor's
# loads, Cholesky, butterfly and stores, so a group only pays where the
# card would otherwise idle: the phi variant's line-search batch (11 x B x
# K factors) fills it with one thread per factor; the moments variant (B x
# K factors) is fastest with two lanes per factor on every rule measured.
PHI_GROUP = 1
MOMENTS_GROUP = 2
QUAD_THREADS = 128


def quad_plan(m: int, d: int, moments: bool, dtype: torch.dtype) -> QuadPlan:
    """The layout of a launch over an ``m``-node rule at local dim ``d``:
    phi only (``moments=False``) or the moments (K3 moments and K4)."""
    group = MOMENTS_GROUP if moments else PHI_GROUP
    staged = QUAD_THREADS // group * (1 + d + d * d) if moments else 0
    return QuadPlan(group, QUAD_THREADS,
                    (m * (d + 1) + staged) * dtype.itemsize)


def _rows(x: torch.Tensor, inner: int):
    """``x [..., K, *block]`` (``inner`` trailing block axes) as the kernel
    reads it: ``(x, batch stride, factor stride)`` in elements, the leading
    axes collapsed into one.  ``x`` is copied only where its block is not
    dense or its leading axes do not collapse into one stride."""
    shape, stride = x.shape, x.stride()
    n = x.ndim
    size = 1
    dense = True
    for i in range(n - 1, n - 1 - inner, -1):
        dense = dense and (shape[i] == 1 or stride[i] == size)
        size *= shape[i]
    lead = [(shape[i], stride[i]) for i in range(n - 1 - inner)
            if shape[i] != 1]
    collapses = all(a[1] == b[1] * b[0] for a, b in zip(lead, lead[1:]))
    if not (dense and collapses):
        return _rows(x.contiguous(), inner)
    return x, (lead[-1][1] if lead else 0), stride[n - 1 - inner]


def _param_rows(params: torch.Tensor, full: tuple, name: str):
    """Packed params broadcastable to ``[*full, P]`` as ``(rows [period, P],
    period)``: factor f of the flat batch reads row ``f % period``.  That
    is the broadcast wherever the params' axes (leading ones dropped) are
    the batch's trailing axes; any other broadcast is expanded."""
    p = params.shape[-1]
    if torch.broadcast_shapes(params.shape, (*full, p)) != (*full, p):
        raise ValueError(f"{name}: params {tuple(params.shape)} do not "
                         f"broadcast to {(*full, p)}")
    own = list(params.shape[:-1])
    while own and own[0] == 1:
        own.pop(0)
    if tuple(own) == full[len(full) - len(own):]:
        return params.contiguous(), math.prod(own)
    return params.expand(*full, p).contiguous(), math.prod(full)


class QuadCall(NamedTuple):
    """A launch's operands as the C entries take them."""

    args: tuple       # the entry's arguments from mu to np (QUAD_OPERANDS)
    outs: tuple       # (e_phi, e_xmu, e_xxt); None where not computed
    plan: QuadPlan
    cost_id: int
    held: tuple       # the tensors the pointers point into, kept alive


def _operands(name, mu, cov, nodes, weights, cost, params, moments):
    """Check a launch's operands and lay them out as the C entries take
    them.  Nothing is copied that the kernel can read in place."""
    if mu.ndim < 2:
        raise ValueError(f"{name}: mu {tuple(mu.shape)} is not [..., K, d]")
    d, k, lead = mu.shape[-1], mu.shape[-2], tuple(mu.shape[:-2])
    m = nodes.shape[0]
    why = covers(cost, d, params.shape[-1], m, mu.dtype)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    for t in (cov, nodes, weights, params):
        if t.device != mu.device or t.dtype != mu.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    if cov.shape != (*lead, k, d, d) or nodes.ndim != 2 or nodes.shape[1] != d:
        raise ValueError(f"{name}: shape mismatch mu {tuple(mu.shape)}, "
                         f"cov {tuple(cov.shape)}, nodes {tuple(nodes.shape)}")
    plan = quad_plan(m, d, moments, mu.dtype)
    count = math.prod(lead) * k
    if count * plan.group >= 2**31:
        raise ValueError(f"{name}: {count} factors exceed the kernel's "
                         f"32-bit lane index at {plan.group} lanes each")
    mu, mu_sb, mu_sk = _rows(mu, 1)
    cov, cov_sb, cov_sk = _rows(cov, 2)
    par, period = _param_rows(params, (*lead, k), name)
    nodes, weights = nodes.contiguous(), weights.contiguous()
    new = functools.partial(torch.empty, dtype=mu.dtype, device=mu.device)
    outs = (new((*lead, k)), new((*lead, k, d)) if moments else None,
            new((*lead, k, d, d)) if moments else None)
    args = (mu.data_ptr(), mu_sb, mu_sk, cov.data_ptr(), cov_sb, cov_sk,
            nodes.data_ptr(), weights.data_ptr(), par.data_ptr(), period,
            *(None if o is None else o.data_ptr() for o in outs),
            count, k, m, params.shape[-1])
    return QuadCall(args, outs, plan, KERNEL_COSTS[cost][0],
                    (mu, cov, par, nodes, weights))


def _launch(name, mu, cov, nodes, weights, cost, params, moments, nonneg,
            rdim):
    """One K3 launch (``gvi_quad``)."""
    d = mu.shape[-1]
    call = _operands(name, mu, cov, nodes, weights, cost, params, moments)
    err = _build.load().gvi_quad(
        _build.DTYPES[mu.dtype], d, call.cost_id, int(moments), *call.args,
        int(nonneg), d if rdim is None else rdim,
        call.plan.group.bit_length() - 1, call.plan.threads,
        _build.current_stream(mu.device))
    _build.check(err, "gvi_quad")
    return call.outs if moments else call.outs[0]


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
