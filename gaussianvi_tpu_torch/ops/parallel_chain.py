"""Log-depth (associative-scan) block-tridiagonal chain algebra.

Counterpart of ``gaussianvi_tpu/ops/parallel_chain.py``
(``chain_impl="assoc"``), with explicit leading batch axes as in
:mod:`.blocktridiag`: ``diag [..., N, s, s]``, ``off [..., N-1, s, s]``.
The sequential GBP sweeps and Thomas solves of :mod:`.blocktridiag` have
O(N) sequential depth; here the three chain recurrences are prefix
computations of an associative composition, O(log N) depth:

1.  **Schur/GBP messages.**  The forward message recurrence
    ``m' = -B^T (D + m)^{-1} B`` lives in the family of matrix
    linear-fractional maps ``m -> Q - U^T (R + m)^{-1} U``, closed under
    composition (one Woodbury identity):

        (g o f):  S  = R_g + Q_f
                  Q' = Q_g - U_g^T S^{-1} U_g
                  R' = R_f - U_f S^{-1} U_f^T
                  U' = U_f S^{-1} U_g

    so every forward pivot ``F_i = D_i + m_i`` comes from one scan, the
    backward pivots from the reversed scan.
2.  **Log det** = sum log det F_i (the forward pivots are the
    block-Cholesky pivots).  Unguarded, as in the JAX package: the
    pivot-trust guard is the sequential sweep's.
3.  **Solve.**  Given the pivots, forward elimination and back
    substitution are affine recurrences ``y' = M y + c``, associative under
    ``(M2, c2) o (M1, c1) = (M2 M1, M2 c1 + c2)``.

PyTorch has no ``lax.associative_scan``: :func:`associative_scan` is a
Hillis-Steele doubling over the state axis, ceil(log2 N) levels of batched
s x s ops on every leading axis at once.  Its reduction order differs from
``lax.associative_scan``'s, so results agree with the JAX package and with
the sequential sweeps up to floating-point reassociation.
"""

from __future__ import annotations

import torch

from .blocktridiag import BlockTridiag, spd_inv, spd_solve
from .smallmat import logdet_spd_small


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``m [..., i, j] @ v [..., j]``."""
    return (m @ v[..., None])[..., 0]


def associative_scan(fn, elems, dims):
    """Inclusive prefix compositions of ``elems`` (a tuple of tensors whose
    state axis is ``dims[j]`` for ``elems[j]``) under the associative
    ``fn(earlier, later)``: ``out[i] = fn(out[i-1], elems[i])`` in exact
    arithmetic.  Hillis-Steele doubling: at level k every element i >= k
    takes ``fn(out[i-k], out[i])``, all of them in one batched call."""
    n = elems[0].shape[dims[0]]
    out = tuple(elems)
    k = 1
    while k < n:
        early = tuple(x.narrow(d, 0, n - k) for x, d in zip(out, dims))
        late = tuple(x.narrow(d, k, n - k) for x, d in zip(out, dims))
        comb = fn(early, late)
        out = tuple(torch.cat([x.narrow(d, 0, k), c], dim=d)
                    for x, c, d in zip(out, comb, dims))
        k *= 2
    return out


_LFT_DIMS = (-3, -3, -3)
_AFFINE_DIMS = (-3, -2)


def _compose_lft(a, b):
    """(b o a) for m -> Q - U^T (R + m)^{-1} U maps; a applied first."""
    q_a, r_a, u_a = a
    q_b, r_b, u_b = b
    s = r_b + q_a
    s_inv_ub = spd_solve(s, u_b)             # S^{-1} U_b
    s_inv_uat = spd_solve(s, _t(u_a))        # S^{-1} U_a^T
    q = q_b - _t(u_b) @ s_inv_ub
    r = r_a - u_a @ s_inv_uat
    u = u_a @ s_inv_ub
    return (q, r, u)


def eval_lft(q, r, u, m):
    """Apply the map ``m -> Q - U^T (R + m)^{-1} U`` (batched)."""
    return q - _t(u) @ spd_solve(r + m, u)


def lft_prefixes(q, r, u):
    """Inclusive prefix compositions of LFT elements ``[..., n, s, s]``."""
    return associative_scan(_compose_lft, (q, r, u), _LFT_DIMS)


def forward_pivots(A: BlockTridiag) -> torch.Tensor:
    """All forward Schur pivots F_i = D_i + m_i, ``[..., N, s, s]``:
    F_0 = D_0;  F_i = D_i - B_{i-1}^T F_{i-1}^{-1} B_{i-1}."""
    if A.num_states == 1:
        return A.diag
    diag = A.diag
    q_c, r_c, u_c = lft_prefixes(torch.zeros_like(A.off), diag[..., :-1, :, :],
                                 A.off)
    # the prefix map at m_0 = 0: m_{i+1} = Q_i - U_i^T R_i^{-1} U_i
    msgs = eval_lft(q_c, r_c, u_c, 0.0)
    return torch.cat([diag[..., :1, :, :], diag[..., 1:, :, :] + msgs],
                     dim=-3)


def backward_pivots(A: BlockTridiag) -> torch.Tensor:
    """All backward pivots G_i = D_i + b_i, ``[..., N, s, s]``:
    G_{N-1} = D_{N-1};  G_i = D_i - B_i G_{i+1}^{-1} B_i^T."""
    if A.num_states == 1:
        return A.diag
    diag = A.diag
    rev = (torch.zeros_like(A.off), diag[..., 1:, :, :].flip(-3),
           _t(A.off).flip(-3))
    q_c, r_c, u_c = lft_prefixes(*rev)
    msgs = eval_lft(q_c, r_c, u_c, 0.0).flip(-3)
    return torch.cat([diag[..., :-1, :, :] + msgs, diag[..., -1:, :, :]],
                     dim=-3)


def gbp_covariance_logdet_assoc(A: BlockTridiag):
    """Covariance blocks and log det with O(log N) sequential depth: the
    outputs of ``blocktridiag.gbp_covariance_logdet``, ``(cov_diag [..., N,
    s, s], cov_off [..., N-1, s, s], logdet [...])``."""
    s = A.block_dim
    if A.num_states == 1:
        return spd_inv(A.diag), A.off, logdet_spd_small(A.diag[..., 0, :, :])
    f_piv = forward_pivots(A)
    g_piv = backward_pivots(A)
    ld = logdet_spd_small(f_piv).sum(-1)
    joint = torch.cat(
        [torch.cat([f_piv[..., :-1, :, :], A.off], dim=-1),
         torch.cat([_t(A.off), g_piv[..., 1:, :, :]], dim=-1)],
        dim=-2,
    )
    joint_cov = spd_inv(joint)
    cov_diag = torch.cat([joint_cov[..., :, :s, :s],
                          joint_cov[..., -1:, s:, s:]], dim=-3)
    return cov_diag, joint_cov[..., :, :s, s:], ld


def _compose_affine(a, b):
    """(b o a) for affine maps y -> M y + c; a applied first."""
    m_a, c_a = a
    m_b, c_b = b
    return (m_b @ m_a, _mv(m_b, c_a) + c_b)


def affine_prefixes(m, c):
    """Inclusive prefix compositions of affine elements ``(M [..., n, s,
    s], c [..., n, s])``."""
    return associative_scan(_compose_affine, (m, c), _AFFINE_DIMS)


def solve_assoc(A: BlockTridiag, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b, ``b [..., N, s]``, in O(log N) depth: the pivots from
    the scan, then elimination and back substitution as affine scans."""
    f_piv = forward_pivots(A)
    if A.num_states == 1:
        return spd_solve(f_piv, b)
    off = A.off
    f_inv = spd_inv(f_piv[..., :-1, :, :])
    # forward elimination: y_0 = b_0; y_i = b_i - B_{i-1}^T F_{i-1}^{-1} y_{i-1}
    m_c, c_c = affine_prefixes(-(_t(off) @ f_inv), b[..., 1:, :])
    b0 = b[..., :1, :]
    ys = torch.cat([b0, _mv(m_c, b0) + c_c], dim=-2)
    # back substitution: x_{N-1} = F_{N-1}^{-1} y_{N-1};
    # x_i = F_i^{-1} (y_i - B_i x_{i+1})
    f_inv_y = spd_solve(f_piv, ys)
    m_c2, c_c2 = affine_prefixes((-(f_inv @ off)).flip(-3),
                                 f_inv_y[..., :-1, :].flip(-2))
    x_last = f_inv_y[..., -1:, :]
    xs_rev = _mv(m_c2, x_last) + c_c2
    return torch.cat([xs_rev.flip(-2), x_last], dim=-2)


def logdet_assoc(A: BlockTridiag) -> torch.Tensor:
    """log det per problem ``[...]`` from the scan's forward pivots."""
    return logdet_spd_small(forward_pivots(A)).sum(-1)
