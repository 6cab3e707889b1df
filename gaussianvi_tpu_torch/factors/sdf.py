"""Signed-distance fields and hinge-loss obstacle costs.

Counterpart of ``gaussianvi_tpu/factors/sdf.py``: an SDF is a frozen
dataclass of tensors with the JAX package's layout (``data[row, col]``,
row <-> y, col <-> x, origin (x0, y0); a 3-D field stacks z as its leading
axis), and the obstacle cost every robot model uses is

    cost(x) = sum_balls sigma * (slope * max(0, eps + radius - sd(ball)))^2

Two interpolations give the same values:

* ``signed_distance``: the clamped four- (eight-) corner gather and the
  bilinear (trilinear) blend;
* ``signed_distance_matmul``: the same blend as a contraction of
  hat-function weights ``relu(1 - |r - i|)`` against the whole field, one
  ``torch.einsum``.  The JAX package added it because gathers serialize on
  a TPU; the port keeps it for parity and resolves ``interp="auto"`` to the
  gather (``factors/robots.py``), which the planar and the 3-D kernel costs
  compute too: the point robots' obstacle batches hand a field's ``data``
  to the kernels as their ``kernel_field``, read in place.

The JAX package's ``set_sdf_matmul_precision`` (a TPU matrix-unit pass
count) has no counterpart: float32 contractions here run at full float32
precision (``ops/precision.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _hat(u, n: int):
    """Hat-function weights ``relu(1 - |u - i|)`` for i < n: ``[..., n]``."""
    grid = torch.arange(n, dtype=u.dtype, device=u.device)
    return torch.clamp_min(1.0 - torch.abs(u[..., None] - grid), 0.0)


@dataclass(frozen=True)
class PlanarSDF:
    """2-D signed distance field on a regular grid: ``data[row, col]`` with
    row <-> y and col <-> x, origin at (x0, y0), square cells."""

    data: torch.Tensor       # [rows, cols]
    origin: torch.Tensor     # [2] (x0, y0)
    cell_size: torch.Tensor  # []

    def to(self, dtype=None, device=None) -> "PlanarSDF":
        return PlanarSDF(*(t.to(dtype=dtype, device=device)
                           for t in (self.data, self.origin, self.cell_size)))

    def point_to_cell(self, point: torch.Tensor) -> torch.Tensor:
        """(x, y) -> fractional (row, col), clamped to the field extent."""
        rows, cols = self.data.shape
        x = torch.clamp(point[..., 0], self.origin[0],
                        self.origin[0] + (cols - 1.0) * self.cell_size)
        y = torch.clamp(point[..., 1], self.origin[1],
                        self.origin[1] + (rows - 1.0) * self.cell_size)
        col = (x - self.origin[0]) / self.cell_size
        row = (y - self.origin[1]) / self.cell_size
        return torch.stack([row, col], dim=-1)

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        """Bilinear-interpolated signed distance at points [..., 2] (x, y)."""
        idx = self.point_to_cell(points)
        r, c = idx[..., 0], idx[..., 1]
        rows, cols = self.data.shape
        lr, lc = torch.floor(r), torch.floor(c)
        lri = torch.clamp(lr.long(), 0, rows - 1)
        lci = torch.clamp(lc.long(), 0, cols - 1)
        hri = torch.clamp(lri + 1, 0, rows - 1)
        hci = torch.clamp(lci + 1, 0, cols - 1)
        wr, wc = r - lr, c - lc
        d = self.data
        return ((1 - wr) * (1 - wc) * d[lri, lci]
                + wr * (1 - wc) * d[hri, lci]
                + (1 - wr) * wc * d[lri, hci]
                + wr * wc * d[hri, hci])

    def signed_distance_matmul(self, points: torch.Tensor) -> torch.Tensor:
        """The bilinear blend as hat-function weights contracted against
        the whole field (no gather).  points [..., 2]."""
        idx = self.point_to_cell(points)
        rows, cols = self.data.shape
        wr = _hat(idx[..., 0], rows)
        wc = _hat(idx[..., 1], cols)
        return torch.einsum("...i,ij,...j->...", wr, self.data, wc)


@dataclass(frozen=True)
class SDF3D:
    """3-D signed distance field, trilinear interpolation: ``data[z, row,
    col]``, origin (x0, y0, z0), cubic cells."""

    data: torch.Tensor       # [z, rows, cols]
    origin: torch.Tensor     # [3] (x0, y0, z0)
    cell_size: torch.Tensor  # []

    def to(self, dtype=None, device=None) -> "SDF3D":
        return SDF3D(*(t.to(dtype=dtype, device=device)
                       for t in (self.data, self.origin, self.cell_size)))

    def _cells(self, points):
        """Fractional (row, col, z) of points [..., 3], clamped."""
        nz, rows, cols = self.data.shape
        x = torch.clamp(points[..., 0], self.origin[0],
                        self.origin[0] + (cols - 1.0) * self.cell_size)
        y = torch.clamp(points[..., 1], self.origin[1],
                        self.origin[1] + (rows - 1.0) * self.cell_size)
        z = torch.clamp(points[..., 2], self.origin[2],
                        self.origin[2] + (nz - 1.0) * self.cell_size)
        c = (x - self.origin[0]) / self.cell_size
        r = (y - self.origin[1]) / self.cell_size
        zz = (z - self.origin[2]) / self.cell_size
        return r, c, zz

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        nz, rows, cols = self.data.shape
        r, c, zz = self._cells(points)
        lr, lc, lz = torch.floor(r), torch.floor(c), torch.floor(zz)
        lri = torch.clamp(lr.long(), 0, rows - 1)
        lci = torch.clamp(lc.long(), 0, cols - 1)
        lzi = torch.clamp(lz.long(), 0, nz - 1)
        hri = torch.clamp(lri + 1, 0, rows - 1)
        hci = torch.clamp(lci + 1, 0, cols - 1)
        hzi = torch.clamp(lzi + 1, 0, nz - 1)
        wr, wc, wz = r - lr, c - lc, zz - lz
        d = self.data
        c00 = (1 - wr) * d[lzi, lri, lci] + wr * d[lzi, hri, lci]
        c01 = (1 - wr) * d[hzi, lri, lci] + wr * d[hzi, hri, lci]
        c10 = (1 - wr) * d[lzi, lri, hci] + wr * d[lzi, hri, hci]
        c11 = (1 - wr) * d[hzi, lri, hci] + wr * d[hzi, hri, hci]
        c0 = (1 - wc) * c00 + wc * c10
        c1 = (1 - wc) * c01 + wc * c11
        return (1 - wz) * c0 + wz * c1

    def signed_distance_matmul(self, points: torch.Tensor) -> torch.Tensor:
        """Trilinear interpolation as hat-function contractions (no
        gather).  points [..., 3].  The (z, row) hats form one
        ``[..., nz, rows]`` operand before the contraction against the
        field: Q * nz * rows values for Q queries."""
        nz, rows, cols = self.data.shape
        r, c, zz = self._cells(points)
        wr, wc, wz = _hat(r, rows), _hat(c, cols), _hat(zz, nz)
        wzr = wz[..., :, None] * wr[..., None, :]          # [..., nz, rows]
        t = torch.einsum("...zi,zij->...j", wzr, self.data)  # [..., cols]
        return torch.sum(t * wc, dim=-1)


def hinge_obstacle_cost(signed_distances: torch.Tensor, epsilon, radius,
                        sigma, slope=1.0) -> torch.Tensor:
    """sum_i sigma * (slope * max(0, eps + radius_i - sd_i))^2 over the last
    axis (one term per ball)."""
    radius = torch.as_tensor(radius, dtype=signed_distances.dtype,
                             device=signed_distances.device)
    radius = radius.expand(signed_distances.shape)
    err = torch.clamp_min(epsilon + radius - signed_distances, 0.0) * slope
    return torch.sum(err * err * sigma, dim=-1)
