"""Signed-distance-field map IO and occupancy-grid generation.

Counterpart of ``gaussianvi_tpu/factors/sdf_io.py``, host-side NumPy until
the field is handed over as tensors:

* :func:`sdf_from_occupancy`: occupancy grid -> exact Euclidean signed
  distance field (``edt(free) - edt(occupied)``), by scipy's
  ``distance_transform_edt`` where scipy imports and the
  Felzenszwalb-Huttenlocher transform in NumPy otherwise;
* :func:`save_sdf` / :func:`load_sdf`: ``.npz`` archives with the JAX
  package's keys (``kind``, ``data``, ``origin``, ``cell_size``), so a file
  saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .sdf import SDF3D, PlanarSDF

_INF = 1e20


def _dt1d_sq(f: np.ndarray) -> np.ndarray:
    """1-D squared-distance transform under the parabola envelope
    (Felzenszwalb & Huttenlocher 2012, Thm 1).  ``f`` is the per-cell
    squared source cost (0 at sources, +inf elsewhere)."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.zeros(n, np.int64)     # parabola sites
    z = np.empty(n + 1)           # envelope breakpoints
    k = 0
    z[0], z[1] = -_INF, _INF
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = _INF
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def _edt_numpy(mask: np.ndarray) -> np.ndarray:
    """Exact Euclidean distance (in cells) from every cell to the nearest
    True cell, by separable 1-D passes along each axis."""
    sq = np.where(mask, 0.0, _INF)
    for axis in range(mask.ndim):
        moved = np.moveaxis(sq, axis, -1)
        flat = moved.reshape(-1, moved.shape[-1])
        for i in range(flat.shape[0]):
            flat[i] = _dt1d_sq(flat[i])
        sq = np.moveaxis(flat.reshape(moved.shape), -1, axis)
    return np.sqrt(sq)


def _edt(mask: np.ndarray, use_scipy: bool | None = None) -> np.ndarray:
    """Distance to the nearest True cell; 0 everywhere if none."""
    if not mask.any():
        return np.zeros(mask.shape)
    if use_scipy is None or use_scipy:
        try:
            from scipy.ndimage import distance_transform_edt

            # scipy measures distance to the nearest ZERO of its input
            return distance_transform_edt(~mask)
        except ImportError:
            if use_scipy:
                raise
    return _edt_numpy(mask)


def _field(kind: str, data, origin, cell, dtype, device):
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    cls = PlanarSDF if kind == "planar" else SDF3D
    return cls(t(data), t(origin), t(cell))


def sdf_from_occupancy(occupancy: np.ndarray, cell_size: float, origin=None,
                       dtype=torch.float64, use_scipy: bool | None = None,
                       device=None) -> PlanarSDF | SDF3D:
    """Exact Euclidean SDF from a boolean occupancy grid.

    ``occupancy`` is [rows, cols] (2-D, row <-> y / col <-> x as in
    PlanarSDF) or [z, rows, cols] (3-D).  Positive outside obstacles,
    negative inside, measured between cell centers:
    ``sd = (edt(free) - edt(occupied)) * cell``.  ``device=None`` is the
    card (``device.default_device``)."""
    occ = np.asarray(occupancy).astype(bool)
    if occ.ndim not in (2, 3):
        raise ValueError(f"occupancy must be 2-D or 3-D, got {occ.ndim}-D")
    if origin is None:
        origin = np.zeros(occ.ndim)
    origin = np.asarray(origin, float)
    d_out = _edt(occ, use_scipy)        # distance of free cells to obstacle
    d_in = _edt(~occ, use_scipy)        # distance of occupied cells to free
    sd = (d_out - d_in) * float(cell_size)
    return _field("planar" if occ.ndim == 2 else "3d", sd, origin,
                  cell_size, dtype, device)


def save_sdf(path, sdf: PlanarSDF | SDF3D) -> None:
    """Save a field to ``.npz`` (the JAX package's keys and kinds)."""
    kind = "planar" if isinstance(sdf, PlanarSDF) else "3d"
    np.savez(
        path,
        kind=kind,
        data=sdf.data.detach().cpu().numpy(),
        origin=sdf.origin.detach().cpu().numpy(),
        cell_size=sdf.cell_size.detach().cpu().numpy(),
    )


def load_sdf(path, dtype=torch.float64, device=None) -> PlanarSDF | SDF3D:
    """Load a field saved by :func:`save_sdf` (either package's)."""
    with np.load(path, allow_pickle=False) as f:
        kind = str(f["kind"])
        data, origin, cell = f["data"], f["origin"], f["cell_size"]
    return _field(kind, data, origin, cell, dtype, device)
