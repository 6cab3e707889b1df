"""Unrolled small-matrix SPD algebra on batched tensors.

Counterpart of ``gaussianvi_tpu/ops/smallmat.py``: the Cholesky-Banachiewicz
recurrences are unrolled over the static block size into elementwise ops on
the leading (batch) axes, in the same operation order as the JAX version.
Blocks here are tiny (s <= 8); larger ones go to ``torch.linalg``.
"""

from __future__ import annotations

import torch

_MAX_UNROLL = 8


def _entries(a: torch.Tensor, s: int):
    return [[a[..., i, j] for j in range(s)] for i in range(s)]


def _stack(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _chol_entries(a, s):
    """Lower Cholesky factor entries of SPD entries ``a`` (unrolled)."""
    l = [[None] * s for _ in range(s)]
    for j in range(s):
        acc = a[j][j]
        for k in range(j):
            acc = acc - l[j][k] * l[j][k]
        ljj = torch.sqrt(acc)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, s):
            acc = a[i][j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            l[i][j] = acc * inv
    return l


def _chol_solve_entries(l, b, s):
    """Solve (L L^T) x = b for one entry-vector b (length s)."""
    y = [None] * s
    for i in range(s):
        acc = b[i]
        for k in range(i):
            acc = acc - l[i][k] * y[k]
        y[i] = acc / l[i][i]
    x = [None] * s
    for i in reversed(range(s)):
        acc = y[i]
        for k in range(i + 1, s):
            acc = acc - l[k][i] * x[k]
        x[i] = acc / l[i][i]
    return x


def chol_small(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of batched SPD [..., s, s]; unrolled for s <= 8.
    A non-SPD input yields NaN entries (no exception), as in JAX: above
    the unroll limit its whole lower triangle, as ``jnp.linalg.cholesky``
    gives it (``cholesky_ex`` leaves a partial factor there)."""
    s = a.shape[-1]
    if s > _MAX_UNROLL:
        l, info = torch.linalg.cholesky_ex(a)
        return torch.where((info == 0)[..., None, None], l,
                           torch.full_like(l, float("nan")).tril())
    l = _chol_entries(_entries(a, s), s)
    zero = torch.zeros_like(l[0][0])
    return _stack(
        [[l[i][j] if j <= i else zero for j in range(s)] for i in range(s)]
    )


def chol_solve_small(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the lower factor; b [..., s] or [..., s, m]."""
    s = l.shape[-1]
    if s > _MAX_UNROLL:
        return torch.cholesky_solve(b if b.ndim == l.ndim else b[..., None],
                                    l).reshape(b.shape)
    le = _entries(l, s)
    if b.ndim == l.ndim:  # matrix rhs [..., s, m]
        m = b.shape[-1]
        cols = [
            _chol_solve_entries(le, [b[..., i, col] for i in range(s)], s)
            for col in range(m)
        ]
        return _stack([[cols[col][i] for col in range(m)] for i in range(s)])
    return torch.stack(
        _chol_solve_entries(le, [b[..., i] for i in range(s)], s), dim=-1
    )


def spd_solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^{-1} b for batched SPD A [..., s, s]."""
    return chol_solve_small(chol_small(a), b)


def spd_inv_small(a: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SPD [..., s, s]."""
    s = a.shape[-1]
    eye = torch.eye(s, dtype=a.dtype, device=a.device).expand(a.shape)
    return spd_solve_small(a, eye)


def logdet_spd_small(a: torch.Tensor) -> torch.Tensor:
    """log det of batched SPD [..., s, s] via the unrolled factor."""
    l = chol_small(a)
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)),
                           dim=-1)
