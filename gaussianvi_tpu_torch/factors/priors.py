"""GP prior factor builders (closed-form linear-Gaussian factors).

Counterpart of the flagship's builders in ``gaussianvi_tpu/factors/
priors.py``: the anchor ``fixed_prior`` and the constant-velocity
``minimum_acc_prior``.  Matrices are built in numpy float64 exactly as in
JAX and converted once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .base import LinearFactorBatch, detect_slice_offset


def _as_batch(start, lam, psi, target_mu, target_prec, constant, nb, dtype,
              device=None):
    device = resolve_device(device)
    start_np = np.asarray(start, np.int64)
    arrays = [np.asarray(a) for a in (lam, psi, target_mu, target_prec,
                                      constant)]
    # every K row identical (concrete inputs): consumers may keep one row
    uniform = all(
        np.array_equal(a, np.broadcast_to(a[:1], a.shape)) for a in arrays
    )

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return LinearFactorBatch(
        start=torch.as_tensor(start_np, device=device),
        lam=t(arrays[0]),
        psi=t(arrays[1]),
        target_mu=t(arrays[2]),
        target_prec=t(arrays[3]),
        constant=t(arrays[4]),
        nb=nb,
        slice_offset=detect_slice_offset(start_np),
        uniform=uniform,
    )


def fixed_prior(state_index: int, mu0, covariance, dtype=torch.float64,
                device=None) -> LinearFactorBatch:
    """Anchor prior psi(x) = ||x - mu0||^2_{K^{-1}} at one state
    (Lam = Psi = I, C = 1)."""
    mu0 = np.asarray(mu0, np.float64)
    cov = np.asarray(covariance, np.float64)
    s = mu0.shape[0]
    return _as_batch(
        [state_index], np.eye(s)[None], np.eye(s)[None], mu0[None],
        np.linalg.inv(cov)[None], [1.0], nb=1, dtype=dtype, device=device,
    )


def min_acc_q(qc: np.ndarray, dt: float) -> np.ndarray:
    """Constant-velocity process noise
    Q = [[dt^3/3 Qc, dt^2/2 Qc], [dt^2/2 Qc, dt Qc]]."""
    d = qc.shape[0]
    q = np.zeros((2 * d, 2 * d))
    q[:d, :d] = qc * dt**3 / 3.0
    q[:d, d:] = qc * dt**2 / 2.0
    q[d:, :d] = qc * dt**2 / 2.0
    q[d:, d:] = qc * dt
    return q


def min_acc_q_inv(qc_inv: np.ndarray, dt: float) -> np.ndarray:
    """Closed-form Q^{-1}."""
    d = qc_inv.shape[0]
    qi = np.zeros((2 * d, 2 * d))
    qi[:d, :d] = 12.0 * qc_inv / dt**3
    qi[:d, d:] = -6.0 * qc_inv / dt**2
    qi[d:, :d] = -6.0 * qc_inv / dt**2
    qi[d:, d:] = 4.0 * qc_inv / dt
    return qi


def minimum_acc_prior(qc, delta_t: float, num_states: int,
                      dtype=torch.float64, device=None) -> LinearFactorBatch:
    """Constant-velocity GP prior between every consecutive state pair:
    Lam = [-Phi, I] over the pair, Psi = 0, C = 1/2."""
    qc = np.atleast_2d(np.asarray(qc, np.float64))
    d = qc.shape[0]
    s = 2 * d
    k = num_states - 1
    phi = np.eye(s)
    phi[:d, d:] = delta_t * np.eye(d)
    lam = np.zeros((s, 2 * s))
    lam[:, :s] = -phi
    lam[:, s:] = np.eye(s)
    qinv = min_acc_q_inv(np.linalg.inv(qc), delta_t)
    return _as_batch(
        np.arange(k),
        np.broadcast_to(lam, (k, s, 2 * s)),
        np.zeros((k, s, 2 * s)),
        np.zeros((k, 2 * s)),
        np.broadcast_to(qinv, (k, s, s)),
        np.full(k, 0.5),
        nb=2, dtype=dtype, device=device,
    )
