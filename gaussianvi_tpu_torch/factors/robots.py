"""Robot collision models: check-ball placement, DH forward kinematics and
the obstacle factors built on them.

Counterpart of ``gaussianvi_tpu/factors/robots.py``.  Each model maps a
robot state to a set of collision-check sphere centers; the obstacle factor
composes it with an SDF lookup and the hinge loss (``factors/sdf.py``).
The functions take batched states ``[..., d]`` where the JAX package takes
one state under ``vmap``.

What differs from the JAX package:

* ``interp="auto"`` resolves to the gather (``"gather"``): the JAX package
  takes the hat-function matmul on a TPU only, where gathers serialize.
* The planar and the 3-D point robot's factors with the gather name the
  CUDA cost functors ``"planar_sdf"`` and ``"sdf3d"`` (``csrc/costs.cuh``
  ``PlanarSdfCost``, ``Sdf3dCost``) and carry their packed params
  ``[eps, radius, sigma, slope, x0, y0, (z0,) cell]`` and the field, which
  the quadrature kernels (K3, and K5 / K6 on the fused path) read from
  device memory; ``interp="matmul"`` and the other robots (the quadrotor's
  five balls, the arm) give a ``cost_fn``-only batch, which the plain
  routes take.
* ``patch_size`` (the patch mode) names the window functors
  ``"planar_patch"`` / ``"sdf3d_patch"`` (``PlanarPatchCost``,
  ``Sdf3dPatchCost``): the same lookup with each coordinate clipped to a
  P-cell window around the factor's marginal mean, which a TPU kernel
  reads from a pre-gathered copy (it has no per-lane gather) and the CUDA
  functors read in place.  The window's origin rides in the params, which
  the batch's ``kernel_prep`` (:func:`make_window_prep`) forms from the
  means before every kernel call; the rule is the full-state one, and
  ``cost_fn`` stays the whole-field lookup, which the plain routes take,
  as in the JAX package.  The window functions of the TPU kernels
  (``make_patch_prep_*``, ``make_patch_cost_*``) are ported as plain
  tensor functions.
* Like the JAX factors these batches have no block form, so
  ``GVIConfig.use_pallas`` never routes them to the block-form moments
  kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..quadrature.table import get_rule
from .base import NonlinearFactorBatch, detect_slice_offset, marginal_rule
from .sdf import SDF3D, PlanarSDF, hinge_obstacle_cost

def planar_point_balls(pose: torch.Tensor) -> torch.Tensor:
    """Planar point robot: one ball at (x, y): ``[..., 1, 2]``."""
    return pose[..., None, :2]


def planar_quad_balls(pose: torch.Tensor, n_balls: int = 5,
                      length: float = 5.0, radius: float = 1.0):
    """Planar quadrotor: n balls along the body axis, ``[..., n, 2]``;
    pose = (x, z, phi, ...)."""
    x, z, phi = pose[..., 0], pose[..., 1], pose[..., 2]
    l_x = x - (length - radius * 1.5) * torch.cos(phi) / 2.0
    l_z = z - (length - radius * 1.5) * torch.sin(phi) / 2.0
    i = torch.arange(n_balls, dtype=pose.dtype, device=pose.device)
    pt_x = l_x[..., None] + (length * torch.cos(phi) / n_balls)[..., None] * i
    pt_z = l_z[..., None] + (length * torch.sin(phi) / n_balls)[..., None] * i
    return torch.stack([pt_x, pt_z], dim=-1)


def point3d_balls(pose: torch.Tensor) -> torch.Tensor:
    """3-D point robot: one ball at (x, y, z): ``[..., 1, 3]``."""
    return pose[..., None, :3]


@dataclass(frozen=True)
class DHForwardKinematics:
    """Denavit-Hartenberg chain with attached collision spheres."""

    a: torch.Tensor           # [J]
    alpha: torch.Tensor       # [J]
    d: torch.Tensor           # [J]
    theta_bias: torch.Tensor  # [J]
    frames: torch.Tensor      # [S] int: sphere -> joint frame
    centers: torch.Tensor     # [S, 3] sphere center in its frame

    def _dh_matrix(self, i: int, theta: torch.Tensor) -> torch.Tensor:
        """Joint i's transform at angles ``theta [...]``: ``[..., 4, 4]``."""
        ct, st = torch.cos(theta), torch.sin(theta)
        ca, sa = torch.cos(self.alpha[i]), torch.sin(self.alpha[i])
        a_i, d_i = self.a[i], self.d[i]
        zero, one = torch.zeros_like(theta), torch.ones_like(theta)
        rows = [
            [ct, -st * ca, st * sa, a_i * ct],
            [st, ct * ca, -ct * sa, a_i * st],
            [zero, sa + zero, ca + zero, d_i + zero],
            [zero, zero, zero, one],
        ]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def joint_transforms(self, theta: torch.Tensor) -> torch.Tensor:
        """Cumulative base -> frame transforms T_0..T_{J-1} at joint angles
        ``theta [..., J]``: ``[..., J, 4, 4]``, one 4x4 product a joint."""
        full = theta + self.theta_bias
        t = torch.eye(4, dtype=theta.dtype, device=theta.device)
        out = []
        for i in range(self.a.shape[0]):
            t = torch.matmul(t, self._dh_matrix(i, full[..., i]))
            out.append(t)
        return torch.stack(out, dim=-3)

    def sphere_centers(self, theta: torch.Tensor) -> torch.Tensor:
        """World positions of all collision spheres, ``[..., S, 3]``."""
        t_s = self.joint_transforms(theta)[..., self.frames, :, :]
        rot = t_s[..., :3, :3]
        pos = t_s[..., :3, 3]
        return pos + torch.einsum("...sij,sj->...si", rot, self.centers)


def _resolve_interp(interp: str) -> str:
    """``interp="auto"`` -> the direct gather: on the card a thread gathers
    freely (the JAX package takes the matmul on a TPU only)."""
    return "gather" if interp == "auto" else interp


def make_patch_prep_2d(sdf: PlanarSDF, patch: int):
    """The window prep of the patch mode for a planar point robot: a
    ``patch x patch`` cell window of the field around each factor's
    marginal-mean ball center.  ``prep(mu_k [K, >=2])`` -> ``(patches
    [K, P, P], r0 [K], c0 [K])`` (window origin in cell units, in mu's
    dtype)."""

    def prep(mu_k):
        rows, cols = sdf.data.shape
        c = (mu_k[:, 0] - sdf.origin[0]) / sdf.cell_size
        r = (mu_k[:, 1] - sdf.origin[1]) / sdf.cell_size
        r0 = torch.clamp(torch.floor(r).long() - patch // 2 + 1, 0,
                         rows - patch)
        c0 = torch.clamp(torch.floor(c).long() - patch // 2 + 1, 0,
                         cols - patch)
        step = torch.arange(patch, device=mu_k.device)
        ri = (r0[:, None] + step)[:, :, None]
        ci = (c0[:, None] + step)[:, None, :]
        return sdf.data[ri, ci], r0.to(mu_k.dtype), c0.to(mu_k.dtype)

    return prep


def make_patch_cost_2d(sdf: PlanarSDF, patch: int, epsilon, radius, sigma,
                       slope=1.0):
    """The patch mode's planar point-robot cost on a pre-gathered window:
    bilinear interpolation as a separable hat-function sum
    ``sd = sum_ij relu(1-|r-i|) relu(1-|c-j|) patch[i, j]`` (the 4-corner
    blend for in-window points; points outside the window clamp to its
    edge), then the hinge.  ``cost(x [..., >=2], patches [..., P, P],
    r0 [...], c0 [...]) -> [...]``."""
    ox, oy = float(sdf.origin[0]), float(sdf.origin[1])
    cell = float(sdf.cell_size)

    def cost(x, patches, r0, c0):
        c_rel = torch.clamp((x[..., 0] - ox) / cell - c0, 0.0, patch - 1.0)
        r_rel = torch.clamp((x[..., 1] - oy) / cell - r0, 0.0, patch - 1.0)
        wc = [torch.clamp_min(1.0 - torch.abs(c_rel - j), 0.0)
              for j in range(patch)]
        sd = None
        for i in range(patch):
            row = None
            for j in range(patch):
                term = wc[j] * patches[..., i, j]
                row = term if row is None else row + term
            wr = torch.clamp_min(1.0 - torch.abs(r_rel - i), 0.0)
            contrib = wr * row
            sd = contrib if sd is None else sd + contrib
        return hinge_obstacle_cost(sd[..., None], epsilon, radius, sigma,
                                   slope)

    return cost


def make_patch_prep_3d(sdf: SDF3D, patch: int):
    """3-D analog of :func:`make_patch_prep_2d`: a P^3 voxel window around
    each factor's marginal-mean ball center.  ``prep(mu_k [K, >=3])`` ->
    ``(patches [K, P, P, P], z0 [K], r0 [K], c0 [K])``."""

    def prep(mu_k):
        nz, rows, cols = sdf.data.shape
        c = (mu_k[:, 0] - sdf.origin[0]) / sdf.cell_size
        r = (mu_k[:, 1] - sdf.origin[1]) / sdf.cell_size
        z = (mu_k[:, 2] - sdf.origin[2]) / sdf.cell_size
        h = patch // 2 - 1
        z0 = torch.clamp(torch.floor(z).long() - h, 0, nz - patch)
        r0 = torch.clamp(torch.floor(r).long() - h, 0, rows - patch)
        c0 = torch.clamp(torch.floor(c).long() - h, 0, cols - patch)
        step = torch.arange(patch, device=mu_k.device)
        zi = (z0[:, None] + step)[:, :, None, None]
        ri = (r0[:, None] + step)[:, None, :, None]
        ci = (c0[:, None] + step)[:, None, None, :]
        return (sdf.data[zi, ri, ci], z0.to(mu_k.dtype), r0.to(mu_k.dtype),
                c0.to(mu_k.dtype))

    return prep


def make_patch_cost_3d(sdf: SDF3D, patch: int, epsilon, radius, sigma,
                       slope=1.0):
    """The patch mode's 3-D point-robot cost: trilinear interpolation as a
    separable hat-function sum over the pre-gathered P^3 window (see
    :func:`make_patch_cost_2d`).  ``cost(x [..., >=3], patches
    [..., P, P, P], z0, r0, c0) -> [...]``."""
    ox, oy, oz = (float(sdf.origin[0]), float(sdf.origin[1]),
                  float(sdf.origin[2]))
    cell = float(sdf.cell_size)

    def cost(x, patches, z0, r0, c0):
        c_rel = torch.clamp((x[..., 0] - ox) / cell - c0, 0.0, patch - 1.0)
        r_rel = torch.clamp((x[..., 1] - oy) / cell - r0, 0.0, patch - 1.0)
        z_rel = torch.clamp((x[..., 2] - oz) / cell - z0, 0.0, patch - 1.0)
        wc = [torch.clamp_min(1.0 - torch.abs(c_rel - j), 0.0)
              for j in range(patch)]
        wr = [torch.clamp_min(1.0 - torch.abs(r_rel - i), 0.0)
              for i in range(patch)]
        sd = None
        for kz in range(patch):
            plane = None
            for i in range(patch):
                row = None
                for j in range(patch):
                    term = wc[j] * patches[..., kz, i, j]
                    row = term if row is None else row + term
                t = wr[i] * row
                plane = t if plane is None else plane + t
            wz = torch.clamp_min(1.0 - torch.abs(z_rel - kz), 0.0)
            contrib = wz * plane
            sd = contrib if sd is None else sd + contrib
        return hinge_obstacle_cost(sd[..., None], epsilon, radius, sigma,
                                   slope)

    return cost


def make_window_prep(row: torch.Tensor, origin: torch.Tensor, cell,
                     extents, patch: int):
    """The patch mode's ``kernel_prep``: ``prep(mu_k [..., K, d]) ->
    [..., K, len(row) + len(extents)]``, the static params ``row`` followed
    by each factor's window origin along x, y (, z), in cell units:
    ``floor((mu - origin) / cell) - (patch // 2 - 1)`` clipped to
    ``[0, extent - patch]``, the arithmetic of the JAX package's
    ``make_patch_prep_2d`` / ``_3d`` (a division, not a reciprocal)."""

    def prep(mu_k):
        first = []
        for axis, extent in enumerate(extents):
            cells = torch.floor((mu_k[..., axis] - origin[axis]) / cell)
            first.append(torch.clamp(cells.long() - (patch // 2 - 1), 0,
                                     extent - patch).to(mu_k.dtype))
        lead = mu_k.shape[:-1]
        return torch.cat([row.expand(*lead, row.shape[0]),
                          torch.stack(first, dim=-1)], dim=-1)

    return prep


def _window_kernel(name, row, sdf, extents, patch, k):
    """The batch fields of the patch mode's functor ``name``: its params
    with every window at the field's origin, the field and the prep."""
    if patch < 1 or patch > min(extents):
        raise ValueError(f"patch_size={patch} does not fit the field "
                         f"{tuple(sdf.data.shape)}")
    row = torch.cat([row, row.new_tensor([float(patch)])])
    width = row.shape[0] + len(extents)
    prep = make_window_prep(row, sdf.origin, sdf.cell_size, extents, patch)
    return dict(kernel_cost=name,
                kernel_params=torch.cat([row, row.new_zeros(len(extents))])
                .expand(k, width).contiguous(),
                kernel_field=sdf.data, kernel_prep=prep)


def _obstacle_batch(cost_fn, start_indices, state_dim, rdim, gh_degree,
                    dtype, device, **kernel):
    """A hinge-cost factor batch (nonnegative cost) on the marginal rule
    over the leading ``rdim`` dims, or the full-state rule for None."""
    if rdim is not None:
        nodes, weights = marginal_rule(state_dim, rdim, gh_degree)
    else:
        nodes, weights = get_rule(state_dim, gh_degree)
    start_np = np.asarray(start_indices, np.int64)
    return NonlinearFactorBatch(
        start=torch.as_tensor(start_np, device=device),
        slice_offset=detect_slice_offset(start_np),
        nodes=torch.as_tensor(np.asarray(nodes), dtype=dtype, device=device),
        weights=torch.as_tensor(np.asarray(weights), dtype=dtype,
                                device=device),
        params=None,
        cost_fn=cost_fn,
        nb=1,
        nonneg_cost=True,   # hinge loss: phi >= 0 everywhere
        quad_rdim=rdim,
        **kernel,
    )


def make_planar_obstacle_factor(
    sdf: PlanarSDF,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    radius: float = 1.0,
    slope: float = 1.0,
    balls_fn=planar_point_balls,
    gh_degree: int = 3,
    patch_size: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=torch.float64,
    device=None,
) -> NonlinearFactorBatch:
    """Per-state planar collision factor psi(x) = hinge(sd(balls(x))).
    The field lives on the device once, shared by all factors.

    ``interp``: "auto" (the gather here), "gather" or "matmul" (the
    hat-function contraction, same values).  ``marginal_quad``: the rule
    over the configuration marginal (2 dims for the point robot, 3 for the
    quadrotor; other ``balls_fn`` keep the full-state rule).  The point
    robot with the gather also names the kernel cost ``"planar_sdf"``.
    ``patch_size`` (the point robot only; other ``balls_fn`` ignore it, as
    in the JAX package): the patch mode, the kernel cost
    ``"planar_patch"`` on a window of that many cells a side, on the
    full-state rule.  ``device=None`` is the card."""
    device = resolve_device(device)
    sdf = sdf.to(dtype, device)
    gather = _resolve_interp(interp) != "matmul"
    lookup = sdf.signed_distance if gather else sdf.signed_distance_matmul

    def cost_fn(x, params):
        del params
        sd = lookup(balls_fn(x))
        return hinge_obstacle_cost(sd, epsilon, radius, cost_sigma, slope)

    patch = patch_size if balls_fn is planar_point_balls else None
    rdim = None
    if marginal_quad and patch is None:
        rdim = (2 if balls_fn is planar_point_balls
                else 3 if balls_fn is planar_quad_balls else None)
    # PlanarSdfCost's params: eps, radius, sigma, slope, x0, y0, cell;
    # PlanarPatchCost's add P and the window's first column and row
    row = torch.cat([torch.tensor([epsilon, radius, cost_sigma, slope],
                                  dtype=dtype, device=device),
                     sdf.origin, sdf.cell_size[None]])
    k = len(np.atleast_1d(start_indices))
    kernel = {}
    if patch is not None:
        rows, cols = sdf.data.shape
        kernel = _window_kernel("planar_patch", row, sdf, (cols, rows),
                                patch, k)
    elif gather and balls_fn is planar_point_balls:
        kernel = dict(kernel_cost="planar_sdf",
                      kernel_params=row.expand(k, 7).contiguous(),
                      kernel_field=sdf.data)
    return _obstacle_batch(cost_fn, start_indices, state_dim, rdim,
                           gh_degree, dtype, device, **kernel)


def make_point3d_obstacle_factor(
    sdf: SDF3D,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    radius: float = 1.0,
    slope: float = 1.0,
    gh_degree: int = 3,
    patch_size: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=torch.float64,
    device=None,
) -> NonlinearFactorBatch:
    """3-D point-robot collision factor: one ball at (x, y, z) -> trilinear
    SDF lookup -> hinge (state = [pos3; vel3]); position-marginal rule.
    With the gather (``interp`` "auto" or "gather") the batch also names
    the kernel cost ``"sdf3d"``; ``interp="matmul"`` gives a
    ``cost_fn``-only batch.  ``patch_size``: the patch mode, the kernel
    cost ``"sdf3d_patch"`` on a window of that many voxels a side, on the
    full-state rule.  ``device=None`` is the card."""
    device = resolve_device(device)
    sdf = sdf.to(dtype, device)
    gather = _resolve_interp(interp) != "matmul"
    lookup = sdf.signed_distance if gather else sdf.signed_distance_matmul

    def cost_fn(x, params):
        del params
        sd = lookup(point3d_balls(x))
        return hinge_obstacle_cost(sd, epsilon, radius, cost_sigma, slope)

    # Sdf3dCost's params: eps, radius, sigma, slope, x0, y0, z0, cell;
    # Sdf3dPatchCost's add P and the window's first column, row and plane
    row = torch.cat([torch.tensor([epsilon, radius, cost_sigma, slope],
                                  dtype=dtype, device=device),
                     sdf.origin, sdf.cell_size[None]])
    k = len(np.atleast_1d(start_indices))
    kernel = {}
    if patch_size is not None:
        nz, rows, cols = sdf.data.shape
        kernel = _window_kernel("sdf3d_patch", row, sdf, (cols, rows, nz),
                                patch_size, k)
    elif gather:
        kernel = dict(kernel_cost="sdf3d",
                      kernel_params=row.expand(k, 8).contiguous(),
                      kernel_field=sdf.data)
    rdim = 3 if marginal_quad and patch_size is None else None
    return _obstacle_batch(cost_fn, start_indices, state_dim, rdim,
                           gh_degree, dtype, device, **kernel)


def make_arm_obstacle_factor(
    sdf: SDF3D,
    fk: DHForwardKinematics,
    radii,
    start_indices,
    state_dim: int,
    cost_sigma: float = 15.5,
    epsilon: float = 0.5,
    slope: float = 1.0,
    gh_degree: int = 3,
    n_joints: int | None = None,
    interp: str = "auto",
    marginal_quad: bool = True,
    dtype=torch.float64,
    device=None,
) -> NonlinearFactorBatch:
    """Arm collision factor: DH forward kinematics -> sphere centers -> 3-D
    SDF -> hinge (state = [theta; theta_dot], the first ``n_joints``
    entries are joint angles); joint-angle-marginal rule.  A
    ``cost_fn``-only batch, on the plain routes.  ``device=None`` is the
    card."""
    device = resolve_device(device)
    sdf = sdf.to(dtype, device)
    radii = torch.as_tensor(radii, dtype=dtype, device=device)
    nj = n_joints if n_joints is not None else state_dim // 2
    lookup = (sdf.signed_distance_matmul
              if _resolve_interp(interp) == "matmul" else sdf.signed_distance)

    def cost_fn(x, params):
        del params
        sd = lookup(fk.sphere_centers(x[..., :nj]))
        return hinge_obstacle_cost(sd, epsilon, radii, cost_sigma, slope)

    rdim = nj if (marginal_quad and nj < state_dim) else None
    return _obstacle_batch(cost_fn, start_indices, state_dim, rdim,
                           gh_degree, dtype, device)
