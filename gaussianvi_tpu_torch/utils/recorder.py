"""Run records and CSV export (the reference's VIMPResults).

Counterpart of ``gaussianvi_tpu/utils/recorder.py``: a ``GVIHistory``
converted to the reference recorder's matrices, iterations as columns,
and written as its CSV set, byte for byte as the JAX package writes it.
The history is one problem's (``mu [T, N, s]``); index a batched one
first (``GVIHistory(*(x[b] for x in hist))``).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from .checkpoint import _numpy

if TYPE_CHECKING:
    from ..inference.optimize import GVIHistory


def _dense_joint(diag: np.ndarray, off: np.ndarray) -> np.ndarray:
    """[T, N, s, s] + [T, N-1, s, s] blocks -> dense [T, N*s, N*s]."""
    t, n, s, _ = diag.shape
    out = np.zeros((t, n * s, n * s), diag.dtype)
    for i in range(n):
        out[:, i * s:(i + 1) * s, i * s:(i + 1) * s] = diag[:, i]
    for i in range(n - 1):
        out[:, i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = off[:, i]
        out[:, (i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = np.swapaxes(
            off[:, i], -1, -2)
    return out


def history_to_arrays(history: GVIHistory,
                      full_joint: bool | None = None) -> dict[str, np.ndarray]:
    """The reference recorder's matrices, iterations as columns: mean, cov
    and precision (marginal blocks), joint_cov and joint_precision (dense,
    by default where N s <= 512), cost, factor_costs, zk_sdf / Sk_sdf (the
    last iteration's means and marginal covariances, states as columns),
    and the chain's off-diagonal blocks and accepted steps besides."""
    mu = _numpy(history.mu)
    if mu.ndim != 3:
        raise ValueError(f"history_to_arrays takes one problem's history "
                         f"(mu [T, N, s]), got mu {mu.shape}")
    cov_d, cov_o = _numpy(history.cov_diag), _numpy(history.cov_off)
    prec_d, prec_o = _numpy(history.prec_diag), _numpy(history.prec_off)
    t, n, s = mu.shape
    out = {
        "mean": mu.reshape(t, -1).T,
        "cov": cov_d.reshape(t, -1).T,
        "precision": prec_d.reshape(t, -1).T,
        "cov_off": cov_o.reshape(t, -1).T if cov_o.size else np.zeros((0, t)),
        "prec_off": (prec_o.reshape(t, -1).T if prec_o.size
                     else np.zeros((0, t))),
        "cost": _numpy(history.cost).reshape(1, t),
        "factor_costs": _numpy(history.factor_costs).T,
        "accepted_step": _numpy(history.accepted_step).reshape(1, t),
        "zk_sdf": mu[-1].T,
        "Sk_sdf": cov_d[-1].reshape(n, s * s).T,
    }
    if full_joint is None:
        full_joint = n * s <= 512
    if full_joint:
        jp = _dense_joint(prec_d, prec_o)
        # the exact joint covariance is the inverse of the joint precision
        # (the recorded blocks are only its tridiagonal part)
        jc = np.linalg.inv(jp)
        out["joint_precision"] = jp.reshape(t, -1).T
        out["joint_cov"] = jc.reshape(t, -1).T
    return out


def save_history_csv(history: GVIHistory, prefix: str,
                     full_joint: bool | None = None) -> list[str]:
    """Write the reference's CSV set under ``prefix`` (mean, cov,
    precision, joint_cov, joint_precision, cost, factor_costs, zk_sdf,
    Sk_sdf, and cov_off / prec_off / accepted_step): the paths written."""
    os.makedirs(prefix, exist_ok=True)
    paths = []
    for name, arr in history_to_arrays(history, full_joint).items():
        path = os.path.join(prefix, f"{name}.csv")
        np.savetxt(path, arr, delimiter=", ", fmt="%.12g")
        paths.append(path)
    return paths


def save_factor_expectations(graph, state, prefix: str) -> list[str]:
    """The final state's per-factor expectations E[phi], E[(x-mu) phi],
    E[(x-mu)(x-mu)^T phi] of every nonlinear batch, one CSV each (one
    problem's state)."""
    from ..inference.introspect import factor_expectations

    os.makedirs(prefix, exist_ok=True)
    paths = []
    for i, exp in enumerate(factor_expectations(graph, state)):
        for key, arr in exp.items():
            path = os.path.join(prefix, f"factor{i}_{key}.csv")
            a = _numpy(arr)
            np.savetxt(path, a.reshape(a.shape[0], -1), delimiter=", ",
                       fmt="%.12g")
            paths.append(path)
    return paths


def cost_map_1d(graph, config=None, x_start: float = 18.0,
                x_end: float = 25.0, y_start: float = 0.05,
                y_end: float = 1.0, nmesh: int = 40) -> np.ndarray:
    """The 1-D cost landscape over (mean, precision), the reference's
    ``cost_map``: ``Z[j, i] = V(x_i, y_j)``, all nmesh^2 points in one
    batched evaluation on the graph's device."""
    from ..inference.gvi import joint_cost
    from ..ops.blocktridiag import BlockTridiag

    del config
    fb = (graph.nonlinear or graph.linear)[0]
    like = fb.nodes if graph.nonlinear else fb.lam
    dtype, device = like.dtype, like.device
    res_x = (x_end - x_start) / nmesh
    res_y = (y_end - y_start) / nmesh
    xs = x_start + torch.arange(nmesh, dtype=dtype, device=device) * res_x
    ys = y_start + torch.arange(nmesh, dtype=dtype, device=device) * res_y
    mu = xs[:, None, None, None].expand(nmesh, nmesh, 1, 1)
    prec = BlockTridiag(
        ys[None, :, None, None, None].expand(nmesh, nmesh, 1, 1, 1),
        torch.zeros((nmesh, nmesh, 0, 1, 1), dtype=dtype, device=device))
    grid = joint_cost(graph, mu, prec, 1.0)        # [x, y]
    return _numpy(grid).T


def save_costmap(graph, filename: str, **kwargs) -> str:
    z = cost_map_1d(graph, **kwargs)
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    np.savetxt(filename, z, delimiter=", ", fmt="%.12g")
    return filename
