"""GP prior factor builders (closed-form linear-Gaussian factors).

Counterpart of ``gaussianvi_tpu/factors/priors.py``: the anchor
``fixed_prior``, the constant-velocity ``minimum_acc_prior`` and its
numerically integrated twin ``minimum_acc_prior_integral``, and the
linear time-varying (LTV) prior ``ltv_prior``, whose transition matrix and
controllability Gramian come from a fixed-step RK4 integration
(``ltv_transition_and_gramian``).  Matrices are built in numpy float64 on
the host (offline model building, as in JAX, whose matrix products there
are its own float64 ``matmul``) and converted once.
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


def minimum_acc_prior_integral(qc, delta_t: float, num_states: int,
                               nsteps: int = 200, dtype=torch.float64,
                               device=None) -> LinearFactorBatch:
    """The constant-velocity prior with Phi and Q integrated numerically
    (:func:`ltv_transition_and_gramian` with A = [[0, I], [0, 0]],
    B = [[0], [chol(Qc)]]): a cross-check of the LTV machinery against
    the closed forms."""
    qc = np.atleast_2d(np.asarray(qc, np.float64))
    d = qc.shape[0]
    s = 2 * d
    a = np.zeros((s, s))
    a[:d, d:] = np.eye(d)
    b = np.zeros((s, d))
    b[d:, :] = np.linalg.cholesky(qc)
    phi, q = ltv_transition_and_gramian(
        np.broadcast_to(a, (5, s, s)), np.broadcast_to(b, (5, s, d)),
        delta_t, nsteps)
    k = num_states - 1
    lam = np.zeros((s, 2 * s))
    lam[:, :s] = -phi
    lam[:, s:] = np.eye(s)
    return _as_batch(
        np.arange(k), np.broadcast_to(lam, (k, s, 2 * s)),
        np.zeros((k, s, 2 * s)), np.zeros((k, 2 * s)),
        np.broadcast_to(np.linalg.inv(q), (k, s, s)), np.full(k, 0.5),
        nb=2, dtype=dtype, device=device)


def _rk4_matrix(rhs, y0: np.ndarray, t0: float, t1: float, nsteps: int):
    """Classical fixed-step RK4 for a matrix ODE ``y' = rhs(t, y)``."""
    h = (t1 - t0) / nsteps
    y, t = y0, t0
    for _ in range(nsteps):
        k1 = rhs(t, y)
        k2 = rhs(t + h / 2, y + h / 2 * k1)
        k3 = rhs(t + h / 2, y + h / 2 * k2)
        k4 = rhs(t + h, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t += h
    return y


def ltv_transition_and_gramian(a_seg: np.ndarray, b_seg: np.ndarray,
                               delta_t: float, nsteps: int = 200):
    """Phi(dt, 0) and the controllability Gramian Q of one segment.

    ``a_seg [P, s, s]`` / ``b_seg [P, s, m]``: piecewise-constant system
    matrices over P - 1 equal sub-intervals (the reference's P = 5, whose
    last slot is active only at t = dt and is never integrated over).

        Phi' = A(t) Phi,  Phi(0) = I
        Q'   = A Q + Q A^T + B B^T,  Q(0) = 0

    integrated piece by piece, each sub-interval by RK4 with its own
    constant (A_j, B_j), ``nsteps`` steps in all, spread over the pieces
    (gaussianvi_tpu/factors/priors.py ltv_transition_and_gramian)."""
    a_seg, b_seg = np.asarray(a_seg), np.asarray(b_seg)
    p, s = a_seg.shape[0], a_seg.shape[1]
    pieces = max(p - 1, 1)
    h_piece = delta_t / pieces
    base, extra = divmod(max(nsteps, pieces), pieces)
    phi = np.eye(s)
    q = np.zeros((s, s))
    for j in range(pieces):
        per = base + (1 if j < extra else 0)
        a, b = a_seg[j], b_seg[j]
        bbt = b @ b.T
        phi = _rk4_matrix(lambda t, y, a=a: a @ y, phi, 0.0, h_piece, per)
        q = _rk4_matrix(
            lambda t, y, a=a, bbt=bbt: a @ y + y @ a.T + bbt,
            q, 0.0, h_piece, per)
    return phi, q


def ltv_prior(a_list, b_list, target_means, delta_t: float, num_states: int,
              dtype=torch.float64, nsteps: int = 200,
              device=None) -> LinearFactorBatch:
    """LTV GP prior over every consecutive state pair.  ``a_list`` /
    ``b_list`` hold piecewise-constant (A, B) at index 4 i + j for segment
    i, sub-interval j (5 a segment); ``target_means`` the nominal mean of
    every state.  Lam = [-Phi, I], Psi = [Phi, -I], C = 1/2,
    prec_t = Q^{-1}."""
    s = np.asarray(a_list[0]).shape[0]
    k = num_states - 1
    lam = np.zeros((k, s, 2 * s))
    psi = np.zeros((k, s, 2 * s))
    prec = np.zeros((k, s, s))
    tmu = np.zeros((k, 2 * s))
    for i in range(k):
        a_seg = np.stack([np.asarray(a_list[4 * i + j]) for j in range(5)])
        b_seg = np.stack([np.asarray(b_list[4 * i + j]) for j in range(5)])
        phi, q = ltv_transition_and_gramian(a_seg, b_seg, delta_t, nsteps)
        lam[i, :, :s] = -phi
        lam[i, :, s:] = np.eye(s)
        psi[i, :, :s] = phi
        psi[i, :, s:] = -np.eye(s)
        prec[i] = np.linalg.inv(q)
        tmu[i, :s] = np.asarray(target_means[i])
        tmu[i, s:] = np.asarray(target_means[i + 1])
    return _as_batch(np.arange(k), lam, psi, tmu, prec, np.full(k, 0.5),
                     nb=2, dtype=dtype, device=device)
