"""Sequence-parallel chain inference: the trajectory axis sharded over the
ranks of an ``sp`` mesh.

Counterpart of ``gaussianvi_tpu/parallel/chain_seqpar.py``; the functions
take the :class:`~.collective.Mesh` where JAX takes ``axis_name`` and carry
any leading axes (line-search trials, a stacked solve pair) before the
state axis.  :mod:`..ops.parallel_chain` runs the GBP recurrences as
associative scans within one device; here the states themselves are
sharded, and the chain runs with O(P) small collectives:

* forward / backward Schur messages: each rank composes its segment's
  linear-fractional maps (one local scan over N / P elements), the ranks
  all-gather the P segment summaries (three s x s matrices a direction,
  both directions in one all-gather), every rank folds the summaries
  before (after) its own into the message entering its segment and
  evaluates its local prefixes at it;
* boundary edge covariances: the right neighbour's first backward pivot
  (a halo exchange);
* log det: the local sum of pivot log dets, then one all-reduce.

Results equal :func:`..ops.blocktridiag.gbp_covariance_logdet` and
:func:`..ops.blocktridiag.solve` up to floating-point reassociation.

Layout: with P ranks and N = P * Nl states, rank p holds states
[p*Nl, (p+1)*Nl): ``diag_l [..., Nl, s, s]`` and ``off_l [..., Nl, s, s]``
where row j is B_{p*Nl+j}, the edge to the NEXT state; the globally last
row is zero padding (:func:`pad_off_for_seqpar`).
"""

from __future__ import annotations

import torch

from ..ops.blocktridiag import spd_inv, spd_solve
from ..ops.parallel_chain import (
    affine_prefixes,
    eval_lft,
    lft_prefixes,
)
from ..ops.smallmat import logdet_spd_small
from .collective import Mesh


def pad_off_for_seqpar(off: torch.Tensor) -> torch.Tensor:
    """``[..., N-1, s, s] -> [..., N, s, s]`` with a zero last row (the
    missing edge)."""
    return torch.cat([off, off.new_zeros((*off.shape[:-3], 1,
                                          *off.shape[-2:]))], dim=-3)


def _t(x):
    return x.transpose(-1, -2)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _last(x, rest: int):
    """Row -1 of the state axis (``rest`` trailing axes after it)."""
    return x.select(x.ndim - 1 - rest, -1)


def _summary(prefixes):
    """The segment's composed map: the last inclusive prefix."""
    return tuple(_last(x, 2) for x in prefixes)


def _fold_lft(summaries, my: int, before: bool):
    """The message entering this rank's segment: the gathered summaries
    ``[P, ..., s, s]`` of the segments before it (``before``, in order) or
    after it (reversed), applied to m = 0."""
    q_all, r_all, u_all = summaries
    p = q_all.shape[0]
    m = torch.zeros_like(q_all[0])
    for j in (range(my) if before else range(p - 1, my, -1)):
        m = eval_lft(q_all[j], r_all[j], u_all[j], m)
    return m


def _fold_affine(gm, gc, my: int, before: bool, v0):
    """The affine summaries of the segments before (after) this rank's
    applied to ``v0``."""
    p = gm.shape[0]
    v = v0
    for j in (range(my) if before else range(p - 1, my, -1)):
        v = _mv(gm[j], v) + gc[j]
    return v


def _forward_prefixes(diag_l, off_l):
    return lft_prefixes(torch.zeros_like(diag_l), diag_l, off_l)


def _forward_pivots(diag_l, prefixes, gathered, my):
    """F for the segment from its local prefixes and the gathered forward
    summaries: the message into local state 0 is the fold, into j > 0
    prefix j - 1 evaluated at it."""
    qc, rc, uc = prefixes
    m_in = _fold_lft(gathered, my, before=True)
    tail = eval_lft(qc[..., :-1, :, :], rc[..., :-1, :, :],
                    uc[..., :-1, :, :], m_in[..., None, :, :])
    return diag_l + torch.cat([m_in[..., None, :, :], tail], dim=-3)


def _eye_like(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device).expand_as(x)


def _backward_prefixes(diag_l, off_l, mesh: Mesh):
    """Reversed local prefixes of the backward elements: local row j
    propagates the message from state j + 1 into j with (D_{j+1}, B_j^T);
    the last row's D comes from the right neighbour (identity past the
    chain's end, where the padded B is zero)."""
    nbr_first = mesh.halo(diag_l[..., 0, :, :], offset=1)
    if mesh.index == mesh.size - 1:
        nbr_first = _eye_like(nbr_first)
    diag_next = torch.cat([diag_l[..., 1:, :, :], nbr_first[..., None, :, :]],
                          dim=-3)
    return lft_prefixes(torch.zeros_like(diag_l), diag_next.flip(-3),
                        _t(off_l).flip(-3))


def _backward_pivots(diag_l, prefixes, gathered, my):
    """G for the segment: the fold is the message into the NEXT segment's
    first state, and the segment's own messages are all the inclusive
    reversed prefixes applied to it (the backward elements emit into
    state j, the forward ones into j + 1)."""
    qc, rc, uc = prefixes
    m_in = _fold_lft(gathered, my, before=False)
    msgs_rev = eval_lft(qc, rc, uc, m_in[..., None, :, :])
    return diag_l + msgs_rev.flip(-3)


def forward_pivots_local(diag_l, off_l, mesh: Mesh):
    """Forward Schur pivots F for this rank's segment."""
    prefixes = _forward_prefixes(diag_l, off_l)
    gathered = mesh.all_gather(*_summary(prefixes))
    return _forward_pivots(diag_l, prefixes, gathered, mesh.index)


def backward_pivots_local(diag_l, off_l, mesh: Mesh):
    """Backward pivots G for this rank's segment."""
    prefixes = _backward_prefixes(diag_l, off_l, mesh)
    gathered = mesh.all_gather(*_summary(prefixes))
    return _backward_pivots(diag_l, prefixes, gathered, mesh.index)


def _both_pivots(diag_l, off_l, mesh: Mesh):
    """F and G with the summaries of both directions in one all-gather."""
    fwd = _forward_prefixes(diag_l, off_l)
    bwd = _backward_prefixes(diag_l, off_l, mesh)
    gathered = mesh.all_gather(*_summary(fwd), *_summary(bwd))
    return (_forward_pivots(diag_l, fwd, gathered[:3], mesh.index),
            _backward_pivots(diag_l, bwd, gathered[3:], mesh.index))


def gbp_covariance_logdet_seqpar(diag_l, off_l, mesh: Mesh):
    """Sequence-parallel GBP covariance blocks and log det.

    Per rank: ``diag_l [..., Nl, s, s]``, ``off_l [..., Nl, s, s]`` (padded
    layout).  Returns ``(cov_diag [..., Nl, s, s], cov_off [..., Nl, s, s]
    padded layout, logdet [...] the same on every rank)``.  Collectives: a
    halo of the first diagonal block, one all-gather of both directions'
    summaries, the log det's all-reduce, a halo of the first backward
    pivot."""
    s = diag_l.shape[-1]
    f_piv, g_piv = _both_pivots(diag_l, off_l, mesh)
    ld = mesh.psum(logdet_spd_small(f_piv).sum(-1))
    # edge j joins local state j to state j + 1; the last edge's right
    # pivot is the right neighbour's first backward pivot
    nbr_g = mesh.halo(g_piv[..., 0, :, :], offset=1)
    if mesh.index == mesh.size - 1:
        nbr_g = _eye_like(nbr_g)
    g_right = torch.cat([g_piv[..., 1:, :, :], nbr_g[..., None, :, :]],
                        dim=-3)
    joint = torch.cat([torch.cat([f_piv, off_l], dim=-1),
                       torch.cat([_t(off_l), g_right], dim=-1)], dim=-2)
    # every local state is the LEFT end of its edge row, so its marginal is
    # the top-left block; the padded edge [[F_{N-1}, 0], [0, I]] gives the
    # last state's marginal F_{N-1}^{-1} with no special case
    joint_cov = spd_inv(joint)
    return joint_cov[..., :s, :s], joint_cov[..., :s, s:], ld


def solve_seqpar(diag_l, off_l, b_l, mesh: Mesh):
    """Sequence-parallel block-Thomas solve A x = b, ``b_l, x [..., Nl,
    s]``.  The affine recurrences have an exact identity, so both sweeps
    are plain segment-summary compositions: local scan, all-gather of the
    (M, c) summaries, fold, local evaluation.  Collectives: three
    all-gathers (the forward pivots' summaries with every segment's first
    rhs row, then each sweep's summaries)."""
    fwd = _forward_prefixes(diag_l, off_l)
    *gathered, b_first = mesh.all_gather(*_summary(fwd), b_l[..., 0, :])
    f_piv = _forward_pivots(diag_l, fwd, gathered, mesh.index)
    f_inv = spd_inv(f_piv)
    # ---- forward elimination: y_i = b_i - B_{i-1}^T F_{i-1}^{-1} y_{i-1};
    # element j maps y at local j to y at local j + 1 (the element into the
    # next segment belongs to this segment's summary); its c is b at local
    # j + 1, the right neighbour's first row for the last element
    nbr_b0 = b_first[(mesh.index + 1) % mesh.size]
    c_elems = torch.cat([b_l[..., 1:, :], nbr_b0[..., None, :]], dim=-2)
    mc, cc = affine_prefixes(-(_t(off_l) @ f_inv), c_elems)
    gm, gc = mesh.all_gather(_last(mc, 2), _last(cc, 1))
    # y entering local state 0: the earlier segments applied to y_0 = b_0
    y_first = _fold_affine(gm, gc, mesh.index, True, b_first[0])
    ys = torch.cat([y_first[..., None, :],
                    _mv(mc[..., :-1, :, :], y_first[..., None, :])
                    + cc[..., :-1, :]], dim=-2)
    # ---- back substitution: x_i = F_i^{-1} y_i - F_i^{-1} B_i x_{i+1};
    # element j maps x_{j+1} to x_j, composed right to left
    f_inv_y = spd_solve(f_piv, ys)
    mc2, cc2 = affine_prefixes((-(f_inv @ off_l)).flip(-3), f_inv_y.flip(-2))
    gm2, gc2 = mesh.all_gather(_last(mc2, 2), _last(cc2, 1))
    # x entering from the right: the later segments' summaries applied to
    # a virtual x_N = 0 (the padded last element has B = 0, hence M = 0
    # and c = F_{N-1}^{-1} y_{N-1}: the true x_{N-1})
    x_right = _fold_affine(gm2, gc2, mesh.index, False,
                           f_inv_y.new_zeros(f_inv_y[..., 0, :].shape))
    return (_mv(mc2, x_right[..., None, :]) + cc2).flip(-2)
