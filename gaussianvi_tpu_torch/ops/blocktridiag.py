"""Block-tridiagonal symmetric matrices: the joint precision representation.

Counterpart of ``gaussianvi_tpu/ops/blocktridiag.py`` with explicit leading
batch axes: ``diag [..., N, s, s]`` and ``off [..., N-1, s, s]`` (block
(i, i+1)).  The chain recurrences are Python loops over the state axis
(``lax.scan`` in JAX); every step is an unrolled s x s op over all leading
axes at once, so B problems (and T line-search trials) march through the
chain together.  Every reduction is per problem: nothing reduces over a
leading axis.

These are also the plain versions of the chain kernels
(``kernels/chain.py``): the CPU path and the on-card reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from .smallmat import (
    chol_small,
    logdet_spd_small,
    spd_inv_small,
    spd_solve_small,
)


def spd_solve(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``mat @ x = rhs`` for SPD ``mat`` (Cholesky)."""
    return spd_solve_small(mat, rhs)


def spd_inv(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD matrix (batched) via Cholesky."""
    return spd_inv_small(mat)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


@dataclass(frozen=True)
class BlockTridiag:
    """Symmetric block-tridiagonal matrix (batched over leading axes).

    diag: [..., N, s, s] diagonal blocks (each symmetric).
    off:  [..., N-1, s, s] super-diagonal blocks; block (i+1, i) is
    ``off[i].T``.
    """

    diag: torch.Tensor
    off: torch.Tensor

    @property
    def num_states(self) -> int:
        return self.diag.shape[-3]

    @property
    def block_dim(self) -> int:
        return self.diag.shape[-1]

    @property
    def dim(self) -> int:
        return self.num_states * self.block_dim

    @staticmethod
    def zeros(batch_shape, num_states: int, block_dim: int, dtype,
              device=None) -> "BlockTridiag":
        s = block_dim
        device = resolve_device(device)
        return BlockTridiag(
            torch.zeros((*batch_shape, num_states, s, s), dtype=dtype,
                        device=device),
            torch.zeros((*batch_shape, max(num_states - 1, 0), s, s),
                        dtype=dtype, device=device),
        )

    @staticmethod
    def identity(batch_shape, num_states: int, block_dim: int, scale=1.0,
                 dtype=torch.float64, device=None) -> "BlockTridiag":
        s = block_dim
        device = resolve_device(device)
        eye = torch.eye(s, dtype=dtype, device=device) * scale
        return BlockTridiag(
            eye.expand((*batch_shape, num_states, s, s)).clone(),
            torch.zeros((*batch_shape, max(num_states - 1, 0), s, s),
                        dtype=dtype, device=device),
        )

    @staticmethod
    def from_dense(mat: torch.Tensor, num_states: int) -> "BlockTridiag":
        """The diagonal and super-diagonal blocks of a dense ``[..., N s,
        N s]`` matrix (its other blocks are dropped)."""
        s = mat.shape[-1] // num_states
        diag = torch.stack([mat[..., i * s:(i + 1) * s, i * s:(i + 1) * s]
                            for i in range(num_states)], dim=-3)
        if num_states > 1:
            off = torch.stack(
                [mat[..., i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s]
                 for i in range(num_states - 1)], dim=-3)
        else:
            off = mat.new_zeros((*mat.shape[:-2], 0, s, s))
        return BlockTridiag(diag, off)

    def to_dense(self) -> torch.Tensor:
        """Dense [..., N s, N s] matrix (tests only)."""
        n, s = self.num_states, self.block_dim
        out = self.diag.new_zeros((*self.diag.shape[:-3], n * s, n * s))
        for i in range(n):
            out[..., i * s:(i + 1) * s, i * s:(i + 1) * s] = self.diag[..., i, :, :]
        for i in range(n - 1):
            o = self.off[..., i, :, :]
            out[..., i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = o
            out[..., (i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = _t(o)
        return out

    def __add__(self, other: "BlockTridiag") -> "BlockTridiag":
        return BlockTridiag(self.diag + other.diag, self.off + other.off)

    def __sub__(self, other: "BlockTridiag") -> "BlockTridiag":
        return BlockTridiag(self.diag - other.diag, self.off - other.off)

    def scale(self, c) -> "BlockTridiag":
        """Multiply by ``c``: a scalar, or a tensor over the leading axes
        (one factor per problem)."""
        if isinstance(c, torch.Tensor) and c.ndim:
            c = c[..., None, None, None]
        return BlockTridiag(self.diag * c, self.off * c)

    def symmetrize(self) -> "BlockTridiag":
        return BlockTridiag(0.5 * (self.diag + _t(self.diag)), self.off)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` for ``x`` flat ``[..., N s]`` or blocked ``[..., N,
        s]`` (the result takes ``x``'s shape)."""
        n, s = self.num_states, self.block_dim
        xb = x.reshape(*x.shape[:-1], n, s) if x.shape[-1] == n * s else x
        y = (self.diag @ xb[..., None])[..., 0]
        if n > 1:
            up = (self.off @ xb[..., 1:, :, None])[..., 0]
            down = (_t(self.off) @ xb[..., :-1, :, None])[..., 0]
            y = y + torch.cat([up, torch.zeros_like(up[..., :1, :])], dim=-2)
            y = y + torch.cat([torch.zeros_like(down[..., :1, :]), down],
                              dim=-2)
        return y.reshape(x.shape)


def _messages(diag, off, forward: bool):
    """GBP messages into every state (the zero message at the chain end
    included): forward ``m_{i+1} = -B_i^T (D_i + m_i)^{-1} B_i``, backward
    ``m_{i-1} = -B_{i-1} (D_i + m_i)^{-1} B_{i-1}^T``."""
    n = diag.shape[-3]
    m = torch.zeros_like(diag[..., 0, :, :])
    msgs = [m]
    order = range(n - 1) if forward else range(n - 1, 0, -1)
    for i in order:
        d = diag[..., i, :, :]
        if forward:
            b = off[..., i, :, :]
            m = -(_t(b) @ spd_solve(d + m, b))
        else:
            b = off[..., i - 1, :, :]
            m = -(b @ spd_solve(d + m, _t(b)))
        msgs.append(m)
    if not forward:
        msgs.reverse()
    return torch.stack(msgs, dim=-3)


def _guarded_logdet(pivots, diag, msgs):
    """Summed pivot logdet per problem, NaN-poisoned when any Cholesky
    pivot has cancelled to rounding noise (trust below 8 eps; see
    ``gaussianvi_tpu/ops/blocktridiag._guarded_logdet``)."""
    l = chol_small(pivots)
    ldiag = torch.diagonal(l, dim1=-2, dim2=-1)
    numer = ldiag * ldiag
    pdiag = torch.diagonal(pivots, dim1=-2, dim2=-1)
    denom = (
        torch.abs(torch.diagonal(diag, dim1=-2, dim2=-1))
        + torch.abs(torch.diagonal(msgs, dim1=-2, dim2=-1))
        + torch.abs(pdiag - numer)
    )
    trust = torch.amin(numer / denom, dim=(-2, -1))
    tol = 8.0 * torch.finfo(pivots.dtype).eps
    ld = 2.0 * torch.sum(torch.log(ldiag), dim=(-2, -1))
    return torch.where(trust >= tol, ld, torch.full_like(ld, float("nan")))


def gbp_edge_covariance(A: BlockTridiag):
    """The GBP sweeps for N >= 2: ``(joint_cov [..., N-1, 2s, 2s],
    logdet [...])``.

    ``joint_cov[..., i, :, :]`` is the covariance of states (i, i+1),
    ``[[Sig_ii, Sig_i,i+1], [., Sig_i+1,i+1]]``: the inverse of the edge's
    joint precision ``[[F_i, B_i], [B_i^T, G_{i+1}]]`` (forward pivot,
    coupling, backward pivot).  The forward pivots ``D_i + f_i`` are the
    block-Cholesky pivots, so log det = sum log det(D_i + f_i),
    NaN-poisoned for noise-level pivots."""
    fwd = _messages(A.diag, A.off, forward=True)
    pivots = A.diag + fwd
    ld = _guarded_logdet(pivots, A.diag, fwd)
    bwd_diag = A.diag + _messages(A.diag, A.off, forward=False)
    joint = torch.cat(
        [torch.cat([pivots[..., :-1, :, :], A.off], dim=-1),
         torch.cat([_t(A.off), bwd_diag[..., 1:, :, :]], dim=-1)],
        dim=-2,
    )
    return spd_inv(joint), ld


def gbp_covariance(A: BlockTridiag):
    """Marginal covariance blocks of ``A^{-1}`` by chain belief propagation:
    ``(cov_diag [..., N, s, s], cov_off [..., N-1, s, s])``."""
    cov_diag, cov_off, _ = gbp_covariance_logdet(A)
    return cov_diag, cov_off


def gbp_covariance_logdet(A: BlockTridiag):
    """GBP covariance blocks AND log det in one pass:
    ``(cov_diag [..., N, s, s], cov_off [..., N-1, s, s], logdet [...])``
    (see :func:`gbp_edge_covariance`)."""
    if A.num_states == 1:
        ld = _guarded_logdet(A.diag, A.diag, torch.zeros_like(A.diag))
        return spd_inv(A.diag), A.off, ld
    s = A.block_dim
    joint_cov, ld = gbp_edge_covariance(A)
    cov_diag = torch.cat(
        [joint_cov[..., :, :s, :s], joint_cov[..., -1:, s:, s:]], dim=-3
    )
    return cov_diag, joint_cov[..., :, :s, s:], ld


def block_cholesky(A: BlockTridiag):
    """Schur pivots ``P_0 = D_0``, ``P_i = D_i - B_{i-1}^T P_{i-1}^{-1}
    B_{i-1}`` and gains ``P_i^{-1} B_i``: ``([..., N, s, s], [..., N-1, s, s])``."""
    pivot = A.diag[..., 0, :, :]
    pivots, gains = [pivot], []
    for i in range(A.num_states - 1):
        b = A.off[..., i, :, :]
        gain = spd_solve(pivot, b)
        pivot = A.diag[..., i + 1, :, :] - _t(b) @ gain
        pivots.append(pivot)
        gains.append(gain)
    gains = (torch.stack(gains, dim=-3) if gains
             else A.off.new_zeros(A.off.shape))
    return torch.stack(pivots, dim=-3), gains


def logdet(A: BlockTridiag) -> torch.Tensor:
    """log det of an SPD block-tridiagonal matrix from its Schur pivots,
    per problem ``[...]`` (no pivot-trust guard, as in the JAX package)."""
    pivots, _ = block_cholesky(A)
    return torch.sum(logdet_spd_small(pivots), dim=-1)


def solve(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (SPD block-tridiagonal), b [..., N, s], by the block
    Thomas algorithm."""
    n = A.num_states
    pivots, gains = block_cholesky(A)
    # forward eliminate: y_i = b_i - B_{i-1}^T P_{i-1}^{-1} y_{i-1}
    ys = [b[..., 0, :]]
    for i in range(1, n):
        sol = spd_solve(pivots[..., i - 1, :, :], ys[-1])
        ys.append(b[..., i, :]
                  - (_t(A.off[..., i - 1, :, :]) @ sol[..., None])[..., 0])
    # back substitute: x_N = P_N^{-1} y_N; x_i = P_i^{-1} y_i - gain_i x_{i+1}
    xs = [spd_solve(pivots[..., n - 1, :, :], ys[n - 1])]
    for i in range(n - 2, -1, -1):
        x = (spd_solve(pivots[..., i, :, :], ys[i])
             - (gains[..., i, :, :] @ xs[-1][..., None])[..., 0])
        xs.append(x)
    xs.reverse()
    return torch.stack(xs, dim=-2)


def marginal_covariance_dense(A: BlockTridiag) -> torch.Tensor:
    """Dense ``A^{-1}`` ``[..., N s, N s]`` (test and reference oracle
    only)."""
    return torch.linalg.inv(A.to_dense())
