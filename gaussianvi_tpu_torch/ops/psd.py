"""Symmetric PSD matrix functions (batched over leading axes).

Counterpart of ``gaussianvi_tpu/ops/psd.py``.  Every matrix involved is
symmetric PSD (a covariance, or similar to one), so a clamped ``eigh`` root
is SPD-safe; ``sqrtm_product`` also has the eigh-free scaled
Denman-Beavers iteration.  ``V f(w) V^T`` does not depend on the sign or
order of the eigenvectors, so the roots agree with the JAX package's where
the eigenvectors themselves need not.
"""

from __future__ import annotations

import torch

from .smallmat import logdet_spd_small, spd_inv_small

# scaled Denman-Beavers sweep count (gaussianvi_tpu/ops/psd._DB_ITERS)
_DB_ITERS = 11

# what ``sqrtm_product(method="auto")`` runs, by the device type of the
# tensor it is given.  CPU: ``eigh``, the bit-stable golden path (as the JAX
# package off the TPU).  CUDA: the faster of the two at the flagship's
# shapes, measured by ``chip_smoke.py`` (PERF.md, Findings).
AUTO_METHOD = {"cpu": "eigh", "cuda": "eigh"}


# cuSOLVER's batched symmetric eigensolver, as PyTorch calls it, refuses a
# batch somewhere above 16,384 matrices (CUSOLVER_STATUS_INVALID_VALUE at
# 32,767 on an H100, PyTorch 2.11 / CUDA 12.8; 16,384 works), and the
# flagship gives it 32,768: larger batches go in chunks of this many
_EIGH_MAX_BATCH = 16384


def _eigh(mat: torch.Tensor):
    """``torch.linalg.eigh`` over any number of leading axes, chunked on the
    card so that no call exceeds the batched solver's limit."""
    lead, d = mat.shape[:-2], mat.shape[-1]
    flat = mat.reshape(-1, d, d)
    if mat.device.type != "cuda" or flat.shape[0] <= _EIGH_MAX_BATCH:
        return torch.linalg.eigh(mat)
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_MAX_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(*lead, d)
    v = torch.cat([p[1] for p in parts]).reshape(*lead, d, d)
    return w, v


def _from_eig(v, vals):
    return torch.einsum("...ij,...j,...kj->...ik", v, vals, v)


def psd_sqrtm(mat: torch.Tensor, clamp: float = 0.0) -> torch.Tensor:
    """Symmetric square root of a symmetric PSD matrix."""
    w, v = _eigh(mat)
    return _from_eig(v, torch.sqrt(torch.clamp_min(w, clamp)))


def psd_inv_sqrtm(mat: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    w, v = _eigh(mat)
    return _from_eig(v, 1.0 / torch.sqrt(torch.clamp_min(w, eps)))


def sqrtm_product(a: torch.Tensor, s, method: str = "auto") -> torch.Tensor:
    """sqrtm(A (A + 4 s I)) for symmetric PSD ``A``: the JKO-step root.

    A and A + 4sI commute, so the root is ``V sqrt(w (w + 4 s)) V^T`` in
    A's eigenbasis (``method="eigh"``).  ``method="newton"`` runs a
    determinant-scaled Denman-Beavers iteration on B = A(A + 4sI) instead:
    X -> sqrt(B), Y -> sqrt(B)^-1, each sweep two unrolled small-matrix
    Cholesky inversions and two log dets (``ops/smallmat``); a trace-scaled
    jitter floors an exactly singular B (the eigh form clamps the same
    eigenvalues at zero).  ``"auto"`` goes by the device ``a`` lies on
    (:data:`AUTO_METHOD`), never by a process-wide backend.
    """
    if method == "auto":
        method = AUTO_METHOD[a.device.type]
    if method == "eigh":
        w, v = _eigh(a)
        return _from_eig(v, torch.sqrt(torch.clamp_min(w * (w + 4.0 * s),
                                                       0.0)))
    if method != "newton":
        raise ValueError(f"unknown sqrtm_product method {method!r}")
    d = a.shape[-1]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    b = a @ a + (4.0 * s) * a
    b = 0.5 * (b + b.transpose(-1, -2))
    tr = torch.diagonal(b, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    fi = torch.finfo(a.dtype)
    x = b + (fi.eps * tr / d + fi.tiny) * eye
    y = eye.expand(x.shape)
    for _ in range(_DB_ITERS):
        # mu = |det X det Y|^(-1/(2d)) rescales both iterates onto the
        # unit-determinant orbit, where the iteration contracts
        # quadratically whatever the initial spread (Higham's scaled DB)
        ld = logdet_spd_small(x) + logdet_spd_small(y)
        mu = torch.exp(-ld / (2.0 * d))[..., None, None]
        xi = spd_inv_small(x)
        yi = spd_inv_small(y)
        x, y = 0.5 * (mu * x + yi / mu), 0.5 * (mu * y + xi / mu)
    return 0.5 * (x + x.transpose(-1, -2))
