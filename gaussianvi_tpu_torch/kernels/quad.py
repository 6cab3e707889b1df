"""Sigma-point quadrature kernel (K3), phi-only and moments variants.

Counterpart of ``gaussianvi_tpu/kernels/quad_lanes.py``.  The cost is not a
Python callable here: a factor batch names a CUDA functor
(``csrc/costs.cuh``) with ``kernel_cost`` and carries its params packed as
``[..., K, P]`` and, for a cost that reads one, its field (one tensor every
factor and problem shares, ``kernel_field``).  :data:`KERNEL_COSTS` maps
each name to the functor's id and to its plain PyTorch form (same
arithmetic, same packed params and field), which the plain versions
evaluate.

Each wrapper launches the kernel (``csrc/quad.cu`` -> ``csrc/quad.cuh``:
a group of lanes per factor, sized by :func:`quad_plan`) for GPU tensors
and runs the plain version for CPU tensors; ``<wrapper>.launches`` counts
kernel launches only.  The 7-DOF arm's cost (``"arm_sdf"``,
:data:`GROUP_COSTS`) takes a layout of its own (``csrc/quad_arm.cu``: a
factor on 16 lanes, the moments staged through shared memory), launched
through the same entry and counted apart (:func:`quad_arm_phi`,
:func:`quad_arm_moments`).  The kernel reads the operands where they lie: mu
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

from ..factors.moments import (
    as_eval_dtype,
    expectation_phi,
    gh_moments,
    kernel_quantizes,
)
from ..utils.profiling import span
from . import _build


def _range_cost_packed(x, p, field=None):
    """(r - |pos - beacon|)^2 / (2 sig_r^2); ``p = [beacon..., r, sig_r_sq]``
    (``RangeCost`` in csrc/costs.cuh).  ``x [M, ..., d]``, ``p [..., P]``;
    no field."""
    dim_x = p.shape[-1] - 2
    d2 = 0
    for j in range(dim_x):
        d2 = d2 + (x[..., j] - p[..., j]) ** 2
    dist = torch.sqrt(d2 + 1e-12)
    return (p[..., dim_x] - dist) ** 2 / (2.0 * p[..., dim_x + 1])


def _planar_sdf_cost_packed(x, p, field):
    """``sigma * (slope * max(0, eps + radius - sd(x[0], x[1])))^2`` with
    ``sd`` the clamped bilinear lookup of ``field [rows, cols]`` (row <-> y,
    col <-> x): ``factors.sdf.PlanarSDF.signed_distance`` followed by
    ``factors.sdf.hinge_obstacle_cost`` for one ball, step for step
    (``PlanarSdfCost`` in csrc/costs.cuh).  ``p = [eps, radius, sigma,
    slope, x0, y0, cell]``; ``x [M, ..., d]``, ``p [..., P]``."""
    rows, cols = field.shape
    x0, y0, cell = p[..., 4], p[..., 5], p[..., 6]
    px = torch.clamp(x[..., 0], x0, x0 + (cols - 1.0) * cell)
    py = torch.clamp(x[..., 1], y0, y0 + (rows - 1.0) * cell)
    c = (px - x0) / cell
    r = (py - y0) / cell
    lr, lc = torch.floor(r), torch.floor(c)
    lri = torch.clamp(lr.long(), 0, rows - 1)
    lci = torch.clamp(lc.long(), 0, cols - 1)
    hri = torch.clamp(lri + 1, 0, rows - 1)
    hci = torch.clamp(lci + 1, 0, cols - 1)
    wr, wc = r - lr, c - lc
    sd = ((1 - wr) * (1 - wc) * field[lri, lci]
          + wr * (1 - wc) * field[hri, lci]
          + (1 - wr) * wc * field[lri, hci]
          + wr * wc * field[hri, hci])
    err = torch.clamp_min(p[..., 0] + p[..., 1] - sd, 0.0) * p[..., 3]
    return err * err * p[..., 2]


def _trilinear(field, x, y, z, x0, y0, z0, cell):
    """The clamped trilinear lookup of ``field [nz, rows, cols]`` (z, row
    <-> y, col <-> x) at ``(x, y, z)``: ``factors.sdf.SDF3D.signed_distance``
    step for step (``trilinear`` in csrc/costs.cuh), blended along rows,
    then columns, then z."""
    nz, rows, cols = field.shape
    px = torch.clamp(x, x0, x0 + (cols - 1.0) * cell)
    py = torch.clamp(y, y0, y0 + (rows - 1.0) * cell)
    pz = torch.clamp(z, z0, z0 + (nz - 1.0) * cell)
    c = (px - x0) / cell
    r = (py - y0) / cell
    zz = (pz - z0) / cell
    lr, lc, lz = torch.floor(r), torch.floor(c), torch.floor(zz)
    lri = torch.clamp(lr.long(), 0, rows - 1)
    lci = torch.clamp(lc.long(), 0, cols - 1)
    lzi = torch.clamp(lz.long(), 0, nz - 1)
    hri = torch.clamp(lri + 1, 0, rows - 1)
    hci = torch.clamp(lci + 1, 0, cols - 1)
    hzi = torch.clamp(lzi + 1, 0, nz - 1)
    wr, wc, wz = r - lr, c - lc, zz - lz
    c00 = (1 - wr) * field[lzi, lri, lci] + wr * field[lzi, hri, lci]
    c01 = (1 - wr) * field[hzi, lri, lci] + wr * field[hzi, hri, lci]
    c10 = (1 - wr) * field[lzi, lri, hci] + wr * field[lzi, hri, hci]
    c11 = (1 - wr) * field[hzi, lri, hci] + wr * field[hzi, hri, hci]
    c0 = (1 - wc) * c00 + wc * c10
    c1 = (1 - wc) * c01 + wc * c11
    return (1 - wz) * c0 + wz * c1


def _sdf3d_cost_packed(x, p, field):
    """``sigma * (slope * max(0, eps + radius - sd(x[0], x[1], x[2])))^2``
    with ``sd`` the clamped trilinear lookup of ``field [nz, rows, cols]``
    (:func:`_trilinear`) followed by ``factors.sdf.hinge_obstacle_cost``
    for one ball, step for step (``Sdf3dCost`` in csrc/costs.cuh).  ``p =
    [eps, radius, sigma, slope, x0, y0, z0, cell]``; ``x [M, ..., d]``,
    ``p [..., P]``."""
    sd = _trilinear(field, x[..., 0], x[..., 1], x[..., 2], p[..., 4],
                    p[..., 5], p[..., 6], p[..., 7])
    err = torch.clamp_min(p[..., 0] + p[..., 1] - sd, 0.0) * p[..., 3]
    return err * err * p[..., 2]


# ``ArmSdfCost``'s params (csrc/costs.cuh): a, cos alpha, sin alpha, d,
# theta_bias (a value a joint each), each sphere's frame, its center in
# that frame (x, y, z), its radius, then eps, sigma, slope, the field's
# origin (x0, y0, z0) and cell
ARM_JOINTS = ARM_SPHERES = 7
ARM_PARAMS = {"a": 0, "cos_alpha": 7, "sin_alpha": 14, "d": 21, "bias": 28,
              "frames": 35, "centers": 42, "radii": 63, "eps": 70,
              "sigma": 71, "slope": 72, "origin": 73, "cell": 76}
ARM_NP = 77


def _arm_sdf_cost_packed(x, p, field):
    """The 7-DOF arm's collision cost (``ArmSdfCost`` in csrc/costs.cuh),
    step for step: DH forward kinematics over the joint angles ``x[..., :7]``
    (``factors.robots.DHForwardKinematics``: frame j is the product of the
    joints' transforms up to j, each ``[[ct, -st ca, st sa, a ct], [st,
    ct ca, -ct sa, a st], [0, sa, ca, d]]``), each sphere's center as its
    frame's origin plus its rotation times the center, the trilinear
    lookup (:func:`_trilinear`) and the hinge summed over the spheres in
    order.  ``p`` as :data:`ARM_PARAMS` lays it out; ``x [M, ..., d]``,
    ``p [..., 77]``."""
    o = ARM_PARAMS

    def at(name, i=0):
        return p[..., o[name] + i]

    one, zero = torch.ones_like(x[..., 0]), torch.zeros_like(x[..., 0])
    r = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    org = [zero, zero, zero]
    frames = []
    for j in range(ARM_JOINTS):
        theta = x[..., j] + at("bias", j)
        st, ct = torch.sin(theta), torch.cos(theta)
        ca, sa = at("cos_alpha", j), at("sin_alpha", j)
        a, d = at("a", j), at("d", j)
        a01, a02, a11, a12 = -st * ca, st * sa, ct * ca, -ct * sa
        a03, a13 = a * ct, a * st
        new_r, new_o = [], []
        for r0, r1, r2 in r:
            new_r.append([r0 * ct + r1 * st, r0 * a01 + r1 * a11 + r2 * sa,
                          r0 * a02 + r1 * a12 + r2 * ca])
        for (r0, r1, r2), oi in zip(r, org):
            new_o.append(r0 * a03 + r1 * a13 + r2 * d + oi)
        r, org = new_r, new_o
        frames.append((r, org))
    total = 0.0
    for s in range(ARM_SPHERES):
        frame = at("frames", s)
        c = [at("centers", 3 * s + k) for k in range(3)]
        pos = [zero] * 3
        for j, (rj, oj) in enumerate(frames):
            here = [oj[i] + (rj[i][0] * c[0] + rj[i][1] * c[1]
                             + rj[i][2] * c[2]) for i in range(3)]
            pos = [torch.where(frame == j, h, q) for h, q in zip(here, pos)]
        sd = _trilinear(field, *pos, at("origin"), at("origin", 1),
                        at("origin", 2), at("cell"))
        err = torch.clamp_min(at("eps") + at("radii", s) - sd, 0.0) \
            * at("slope")
        total = total + err * err * at("sigma")
    return total


def _window_axis(v, v0, cell, o, patch, extent):
    """One axis of the patch mode's lookup (``WindowAxis`` in
    csrc/costs.cuh), step for step: the coordinate relative to the window
    of ``patch`` cells from cell ``o``, clipped to ``[0, patch - 1]``; the
    two corners' field indices (the high one clamped to the window, both to
    the field) and their weights as the hat sum takes them."""
    q = torch.minimum(torch.clamp_min((v - v0) / cell - o, 0.0), patch - 1.0)
    low = torch.floor(q)
    last = patch.long() - 1
    li = torch.minimum(torch.clamp_min(low.long(), 0), last)
    hi = torch.minimum(li + 1, last)
    base = o.long()
    lo_f = torch.clamp(base + li, 0, extent - 1)
    hi_f = torch.clamp(base + hi, 0, extent - 1)
    return lo_f, hi_f, 1.0 - (q - low), 1.0 - ((low + 1.0) - q)


def _planar_patch_cost_packed(x, p, field):
    """The patch mode's planar cost (``PlanarPatchCost`` in csrc/costs.cuh):
    the bilinear lookup with each coordinate clipped to the factor's window
    of P x P cells, blended along the row first, as the JAX package's hat
    sum (``make_patch_cost_2d``) adds its terms, then the hinge.  ``p =
    [eps, radius, sigma, slope, x0, y0, cell, P, c0, r0]`` (the window's
    first column and row, ``NonlinearFactorBatch.kernel_prep``); ``x
    [M, ..., d]``, ``p [..., 10]``."""
    rows, cols = field.shape
    cl, ch, wc0, wc1 = _window_axis(x[..., 0], p[..., 4], p[..., 6],
                                    p[..., 8], p[..., 7], cols)
    rl, rh, wr0, wr1 = _window_axis(x[..., 1], p[..., 5], p[..., 6],
                                    p[..., 9], p[..., 7], rows)
    sd = (wr0 * (wc0 * field[rl, cl] + wc1 * field[rl, ch])
          + wr1 * (wc0 * field[rh, cl] + wc1 * field[rh, ch]))
    err = torch.clamp_min(p[..., 0] + p[..., 1] - sd, 0.0) * p[..., 3]
    return err * err * p[..., 2]


def _sdf3d_patch_cost_packed(x, p, field):
    """The patch mode's 3-D cost (``Sdf3dPatchCost`` in csrc/costs.cuh):
    the trilinear lookup with each coordinate clipped to the factor's
    window of P^3 voxels, blended along rows, across rows, across planes
    (``make_patch_cost_3d``'s order), then the hinge.  ``p = [eps, radius,
    sigma, slope, x0, y0, z0, cell, P, c0, r0, z0w]``; ``x [M, ..., d]``,
    ``p [..., 12]``."""
    nz, rows, cols = field.shape
    cell, patch = p[..., 7], p[..., 8]
    cl, ch, wc0, wc1 = _window_axis(x[..., 0], p[..., 4], cell, p[..., 9],
                                    patch, cols)
    rl, rh, wr0, wr1 = _window_axis(x[..., 1], p[..., 5], cell, p[..., 10],
                                    patch, rows)
    zl, zh, wz0, wz1 = _window_axis(x[..., 2], p[..., 6], cell, p[..., 11],
                                    patch, nz)

    def plane(z):
        return (wr0 * (wc0 * field[z, rl, cl] + wc1 * field[z, rl, ch])
                + wr1 * (wc0 * field[z, rh, cl] + wc1 * field[z, rh, ch]))

    sd = wz0 * plane(zl) + wz1 * plane(zh)
    err = torch.clamp_min(p[..., 0] + p[..., 1] - sd, 0.0) * p[..., 3]
    return err * err * p[..., 2]


# name -> (functor id in csrc/costs.cuh, plain PyTorch form
# ``form(x, p, field)``, instantiated local dims d with their param counts
# P, the dims of the field the cost reads or None)
KERNEL_COSTS = {
    "range": (0, _range_cost_packed, {2: 3, 4: 4, 6: 5}, None),
    "planar_sdf": (1, _planar_sdf_cost_packed, {2: 7, 4: 7}, 2),
    "sdf3d": (2, _sdf3d_cost_packed, {6: 8}, 3),
    "planar_patch": (3, _planar_patch_cost_packed, {2: 10, 4: 10}, 2),
    "sdf3d_patch": (4, _sdf3d_patch_cost_packed, {6: 12}, 3),
    "arm_sdf": (5, _arm_sdf_cost_packed, {14: ARM_NP}, 3),
}
# costs with a K3 layout of their own (csrc/quad_arm.cu: a factor on a
# group of lanes), K3 only, on a marginal rule over the leading r dims
# (the moments' lift), r by name
GROUP_COSTS = {"arm_sdf": ARM_JOINTS}
# the patch mode's costs: their params carry each factor's window, which
# follows its marginal mean (``NonlinearFactorBatch.kernel_prep`` forms
# them before every call); K3 and K6 take them, K4 and K5 do not
WINDOW_COSTS = frozenset({"planar_patch", "sdf3d_patch"})


def cost_form(cost: str, field=None):
    """The named cost's plain PyTorch form as a ``cost_fn(x, p)`` over
    packed params, its field bound."""
    form = KERNEL_COSTS[cost][1]
    return form if field is None else functools.partial(form, field=field)

_MAX_SMEM = 48 * 1024


def quad_phi_plain(mu, cov, nodes, weights, cost, params, nonneg=False,
                   field=None, eval_dtype=None):
    """Plain version of the phi-only variant: guarded E[phi] [..., K]
    (``moments.expectation_phi`` with the named cost's PyTorch form).  An
    ``eval_dtype`` rounds each offset, summed in the kernel's order
    (``moments.kernel_offsets``), through it and back."""
    return expectation_phi(nodes, weights, mu, cov, cost_form(cost, field),
                           params, eval_dtype, nonneg=nonneg,
                           kernel_order=eval_dtype is not None)


def quad_moments_plain(mu, cov, nodes, weights, cost, params, rdim=None,
                       field=None, eval_dtype=None):
    """Plain version of the moments variant (``moments.gh_moments`` with
    the named cost's PyTorch form), marginal-rule lift included;
    ``eval_dtype`` as in :func:`quad_phi_plain`."""
    return gh_moments(nodes, weights, mu, cov, cost_form(cost, field),
                      params, eval_dtype, rdim=rdim,
                      kernel_order=eval_dtype is not None)


def quant_flag(name: str, eval_dtype) -> int:
    """The kernels' offset rounding as their C entries take it: 0 none,
    1 bfloat16; ``ValueError`` for what they do not round (float16)."""
    if not kernel_quantizes(eval_dtype):
        raise ValueError(f"{name}: the kernels round offsets through "
                         f"bfloat16 only, not {eval_dtype}")
    return int(as_eval_dtype(eval_dtype) is not None)


def field_dims(field) -> tuple:
    """``(rows, cols, depth)`` of a field as the C entries take them: a
    planar field has depth 1, a 3-D one ``[depth, rows, cols]``; no field
    is ``(0, 0, 0)``."""
    if field is None:
        return 0, 0, 0
    if field.ndim == 2:
        return (*field.shape, 1)
    return field.shape[1], field.shape[2], field.shape[0]


def field_covers(cost: str, field, dtype: torch.dtype) -> str | None:
    """Why the kernels cannot take ``field`` for the kernel cost ``cost``
    in ``dtype``, or None where they can (none for a cost without one)."""
    ndim = KERNEL_COSTS[cost][3]
    if ndim is None:
        return (None if field is None else
                f"cost {cost!r} reads no field, but the batch carries one")
    if field is None:
        return (f"cost {cost!r} reads a {ndim}-D field: the batch carries "
                "none (kernel_field)")
    if field.ndim != ndim or min(field.shape) < 1:
        return (f"cost {cost!r} reads a {ndim}-D field, got "
                f"{tuple(field.shape)}")
    if field.dtype != dtype:
        return f"field dtype {field.dtype} is not the batch's {dtype}"
    if field.numel() >= 2**31:
        return f"field of {field.numel()} values exceeds a 32-bit index"
    return None


def covers(cost: str | None, d: int, p: int, m: int,
           dtype: torch.dtype, field=None, rdim=None) -> str | None:
    """Why K3 does not cover a batch with the kernel cost ``cost`` (P =
    ``p`` packed params, the field ``field`` where the cost reads one) at
    local dim ``d`` on an ``m``-node rule in ``dtype``, or None where it
    does; a cost of :data:`GROUP_COSTS` also needs its marginal rule,
    ``rdim`` (the batch's ``quad_rdim``).  The engine resolves
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
    why = field_covers(cost, field, dtype)
    if why is not None:
        return why
    if cost in GROUP_COSTS and rdim != GROUP_COSTS[cost]:
        return (f"cost {cost!r} takes the marginal rule over the leading "
                f"{GROUP_COSTS[cost]} dims (quad_rdim), got {rdim}")
    if quad_plan(m, d, True, dtype, cost).smem > _MAX_SMEM:
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
# The arm's layout (csrc/quad_arm.cu, compiled in): a factor on 16 lanes,
# a node a lane on the (7, 2) rule; the moments stage each factor's L21
# and a round's nodes (14 offsets, 1, w phi a node) in shared memory.
ARM_GROUP = 16


def quad_plan(m: int, d: int, moments: bool, dtype: torch.dtype,
              cost: str | None = None) -> QuadPlan:
    """The layout of a launch over an ``m``-node rule at local dim ``d``:
    phi only (``moments=False``) or the moments (K3 moments and K4); a
    cost of :data:`GROUP_COSTS` takes its own (``csrc/quad_arm.cu``)."""
    if cost in GROUP_COSTS:
        r = GROUP_COSTS[cost]
        stage = (QUAD_THREADS // ARM_GROUP * (r * r + ARM_GROUP * (d + 2))
                 if moments else 0)
        return QuadPlan(ARM_GROUP, QUAD_THREADS,
                        (m * (r + 1) + stage) * dtype.itemsize)
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
    # leading axes of one entry or of stride 0 (an expanded view) are the
    # broadcast itself
    lead = 0
    while lead < params.ndim - 1 and (params.shape[lead] == 1
                                      or params.stride(lead) == 0):
        lead += 1
    own = tuple(params.shape[lead:-1])
    if own == full[len(full) - len(own):]:
        return params[(0,) * lead].contiguous(), math.prod(own)
    return params.expand(*full, p).contiguous(), math.prod(full)


class QuadCall(NamedTuple):
    """A launch's operands as the C entries take them."""

    args: tuple       # the entry's arguments from mu to np (QUAD_OPERANDS)
    outs: tuple       # (e_phi, e_xmu, e_xxt); None where not computed
    plan: QuadPlan
    cost_id: int
    held: tuple       # the tensors the pointers point into, kept alive


def _operands(name, mu, cov, nodes, weights, cost, params, moments,
              field=None, rdim=None):
    """Check a launch's operands and lay them out as the C entries take
    them.  Nothing is copied that the kernel can read in place.  The phi
    variant reads the points' leading coordinates alone, so a
    :data:`GROUP_COSTS` cost's rule is checked for the moments only."""
    if mu.ndim < 2:
        raise ValueError(f"{name}: mu {tuple(mu.shape)} is not [..., K, d]")
    d, k, lead = mu.shape[-1], mu.shape[-2], tuple(mu.shape[:-2])
    m = nodes.shape[0]
    if not moments:
        rdim = GROUP_COSTS.get(cost)
    why = covers(cost, d, params.shape[-1], m, mu.dtype, field, rdim)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    for t in (cov, nodes, weights, params,
              *(() if field is None else (field,))):
        if t.device != mu.device or t.dtype != mu.dtype:
            raise ValueError(f"{name}: operands on different devices/dtypes")
    if cov.shape != (*lead, k, d, d) or nodes.ndim != 2 or nodes.shape[1] != d:
        raise ValueError(f"{name}: shape mismatch mu {tuple(mu.shape)}, "
                         f"cov {tuple(cov.shape)}, nodes {tuple(nodes.shape)}")
    plan = quad_plan(m, d, moments, mu.dtype, cost)
    count = math.prod(lead) * k
    if count * plan.group >= 2**31:
        raise ValueError(f"{name}: {count} factors exceed the kernel's "
                         f"32-bit lane index at {plan.group} lanes each")
    mu, mu_sb, mu_sk = _rows(mu, 1)
    cov, cov_sb, cov_sk = _rows(cov, 2)
    par, period = _param_rows(params, (*lead, k), name)
    nodes, weights = nodes.contiguous(), weights.contiguous()
    fld = None if field is None else field.contiguous()
    new = functools.partial(torch.empty, dtype=mu.dtype, device=mu.device)
    outs = (new((*lead, k)), new((*lead, k, d)) if moments else None,
            new((*lead, k, d, d)) if moments else None)
    args = (mu.data_ptr(), mu_sb, mu_sk, cov.data_ptr(), cov_sb, cov_sk,
            nodes.data_ptr(), weights.data_ptr(), par.data_ptr(), period,
            None if fld is None else fld.data_ptr(), *field_dims(fld),
            *(None if o is None else o.data_ptr() for o in outs),
            count, k, m, params.shape[-1])
    return QuadCall(args, outs, plan, KERNEL_COSTS[cost][0],
                    (mu, cov, par, nodes, weights, fld))


def _launch(name, mu, cov, nodes, weights, cost, params, moments, nonneg,
            rdim, field=None, eval_dtype=None):
    """One K3 launch (``gvi_quad``)."""
    d = mu.shape[-1]
    quant = quant_flag(name, eval_dtype)
    call = _operands(name, mu, cov, nodes, weights, cost, params, moments,
                     field, rdim)
    err = _build.load().gvi_quad(
        _build.DTYPES[mu.dtype], d, call.cost_id, int(moments), *call.args,
        int(nonneg), d if rdim is None else rdim, quant,
        call.plan.group.bit_length() - 1, call.plan.threads,
        _build.current_stream(mu.device))
    _build.check(err, "gvi_quad")
    return call.outs if moments else call.outs[0]


def quad_lanes_phi(mu, cov, nodes, weights, cost: str, params,
                   nonneg: bool = False, field=None, eval_dtype=None):
    """K3, phi-only: ``mu [..., K, d]``, ``cov [..., K, d, d]``,
    ``nodes [M, d]``, ``weights [M]``, packed ``params`` broadcastable to
    ``[..., K, P]`` and the cost's ``field`` where it reads one -> guarded
    E[phi] ``[..., K]``.  ``eval_dtype`` None or bfloat16: each sigma
    offset rounded through it and back (centered quantization)."""
    if mu.device.type == "cpu":
        return quad_phi_plain(mu, cov, nodes, weights, cost, params, nonneg,
                              field, eval_dtype)
    if cost in GROUP_COSTS:
        return quad_arm_phi(mu, cov, nodes, weights, cost, params, nonneg,
                            field, eval_dtype)
    with span("gvi.kernel.quad_phi"):
        out = _launch("quad_lanes_phi", mu, cov, nodes, weights, cost, params,
                      False, nonneg, None, field, eval_dtype)
        quad_lanes_phi.launches += 1
        return out


def quad_lanes_moments(mu, cov, nodes, weights, cost: str, params,
                       rdim: int | None = None, field=None, eval_dtype=None):
    """K3, moments: as :func:`quad_lanes_phi` -> (E[phi] ``[..., K]``,
    E[(x-mu)phi] ``[..., K, d]``, E[(x-mu)(x-mu)^T phi] ``[..., K, d, d]``),
    unguarded, with the marginal-rule lift for ``rdim``; the moments
    accumulate the rounded offsets."""
    if mu.device.type == "cpu":
        return quad_moments_plain(mu, cov, nodes, weights, cost, params, rdim,
                                  field, eval_dtype)
    if cost in GROUP_COSTS:
        return quad_arm_moments(mu, cov, nodes, weights, cost, params, rdim,
                                field, eval_dtype)
    with span("gvi.kernel.quad_moments"):
        out = _launch("quad_lanes_moments", mu, cov, nodes, weights, cost,
                      params, True, False, rdim, field, eval_dtype)
        quad_lanes_moments.launches += 1
        return out


def quad_arm_phi(mu, cov, nodes, weights, cost: str, params,
                 nonneg: bool = False, field=None, eval_dtype=None):
    """K3, phi-only, for a cost of :data:`GROUP_COSTS` (the arm,
    ``csrc/quad_arm.cu``): :func:`quad_lanes_phi`'s operands and result,
    its launches counted apart."""
    with span("gvi.kernel.quad_arm_phi"):
        out = _launch("quad_arm_phi", mu, cov, nodes, weights, cost, params,
                      False, nonneg, None, field, eval_dtype)
        quad_arm_phi.launches += 1
        return out


def quad_arm_moments(mu, cov, nodes, weights, cost: str, params,
                     rdim: int | None = None, field=None, eval_dtype=None):
    """K3, moments, for a cost of :data:`GROUP_COSTS` on its marginal rule
    (``rdim``): :func:`quad_lanes_moments`' operands and results, its
    launches counted apart."""
    with span("gvi.kernel.quad_arm_moments"):
        out = _launch("quad_arm_moments", mu, cov, nodes, weights, cost,
                      params, True, False, rdim, field, eval_dtype)
        quad_arm_moments.launches += 1
        return out


quad_lanes_phi.launches = 0
quad_lanes_moments.launches = 0
quad_arm_phi.launches = 0
quad_arm_moments.launches = 0
