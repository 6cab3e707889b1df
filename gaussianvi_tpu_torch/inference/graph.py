"""Factor graph over a trajectory chain + marginal gather/scatter.

Counterpart of ``gaussianvi_tpu/inference/graph.py``.  Tensors carry any
number of leading axes before the state axis (problems ``[B]``, or line-
search trials x problems ``[T, B]``); factor data broadcasts against them
from the right.  Consecutive supports (``slice_offset``) become slices,
shared starts ``index_select``/``index_add_``, per-problem starts
``gather``/``scatter_add_``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..factors.base import LinearFactorBatch, NonlinearFactorBatch
from ..ops.blocktridiag import BlockTridiag


@dataclass(frozen=True)
class GaussianState:
    """The variational posterior q = N(mu, precision^{-1})."""

    mu: torch.Tensor              # [..., N, s]
    precision: BlockTridiag       # [..., N, s, s] / [..., N-1, s, s]

    @property
    def num_states(self) -> int:
        return self.mu.shape[-2]

    @property
    def state_dim(self) -> int:
        return self.mu.shape[-1]


@dataclass(frozen=True)
class FactorGraph:
    """All factors of a problem (or of a stacked problem batch), by type."""

    num_states: int
    state_dim: int
    nonlinear: tuple[NonlinearFactorBatch, ...] = ()
    linear: tuple[LinearFactorBatch, ...] = ()

    @property
    def dtype(self) -> torch.dtype | None:
        """The dtype of the factors' data (None without factors)."""
        for fb in self.nonlinear:
            return fb.nodes.dtype
        for lb in self.linear:
            return lb.lam.dtype
        return None


def _state_axis(arr: torch.Tensor, rest: int) -> int:
    return arr.ndim - 1 - rest


def _per_problem_index(start, shift, lead, rest_shape):
    """[B, K] per-problem starts broadcast to ``[*lead, K, *rest_shape]``."""
    idx = start + shift
    idx = idx.reshape(idx.shape + (1,) * len(rest_shape))
    return idx.expand(*lead, idx.shape[-1 - len(rest_shape)], *rest_shape)


def take_states(arr, start, slice_offset, rest, shift=0):
    """``arr[..., start + shift, *rest]`` along the state axis (the axis
    before the ``rest`` trailing axes): ``[..., K, *rest]``."""
    dim = _state_axis(arr, rest)
    k = start.shape[-1]
    if slice_offset is not None:
        return arr.narrow(dim, slice_offset + shift, k)
    if start.ndim == 1:
        return arr.index_select(dim, start + shift)
    idx = _per_problem_index(start, shift, arr.shape[:dim],
                             arr.shape[dim + 1:])
    return torch.gather(arr, dim, idx)


def _add_(arr, v, start, slice_offset, rest, shift=0):
    """In-place ``arr[..., start + shift, ...] += v`` (duplicates add)."""
    dim = _state_axis(arr, rest)
    k = start.shape[-1]
    v = v.expand(*arr.shape[:dim], *v.shape[-1 - rest:])
    if slice_offset is not None:
        arr.narrow(dim, slice_offset + shift, k).add_(v)
    elif start.ndim == 1:
        arr.index_add_(dim, start + shift, v)
    else:
        idx = _per_problem_index(start, shift, arr.shape[:dim],
                                 arr.shape[dim + 1:])
        arr.scatter_add_(dim, idx, v)


def gather_marginals(start, nb, mu, cov_diag, cov_off, slice_offset=None):
    """Per-factor marginal ``(mu_k [..., K, d], cov_k [..., K, d, d])``.

    nb == 1: one diagonal block.  nb == 2: the 2x2 block
    [[Sig_ii, Sig_i,i+1], [., Sig_i+1,i+1]]."""
    if nb == 1:
        return (take_states(mu, start, slice_offset, 1),
                take_states(cov_diag, start, slice_offset, 2))
    if nb == 2:
        mu_k = torch.cat([take_states(mu, start, slice_offset, 1),
                          take_states(mu, start, slice_offset, 1, 1)], dim=-1)
        off_k = take_states(cov_off, start, slice_offset, 2)
        top = torch.cat([take_states(cov_diag, start, slice_offset, 2), off_k],
                        dim=-1)
        bot = torch.cat([off_k.transpose(-1, -2),
                         take_states(cov_diag, start, slice_offset, 2, 1)], dim=-1)
        return mu_k, torch.cat([top, bot], dim=-2)
    raise NotImplementedError(f"factor span nb={nb} not supported (use 1 or 2)")


def gather_chain_edges(start, mu, cov_diag, cov_off, slice_offset=None):
    """``(mu_i, mu_ip1, cd_i, cd_ip1, co_i)`` for nb == 2 supports, left
    unassembled for blockwise consumers (``moments.linear_cost_chain``)."""
    return (
        take_states(mu, start, slice_offset, 1),
        take_states(mu, start, slice_offset, 1, 1),
        take_states(cov_diag, start, slice_offset, 2),
        take_states(cov_diag, start, slice_offset, 2, 1),
        take_states(cov_off, start, slice_offset, 2),
    )


def scatter_gradients(start, nb, vdmu, vddmu, grad_mu, grad_prec,
                      slice_offset=None):
    """Add per-factor ``(Vdmu [..., K, d], Vddmu [..., K, d, d])`` into the
    joint ``grad_mu [..., N, s]`` / ``grad_prec`` IN PLACE (the caller owns
    both accumulators) and return them."""
    s = grad_mu.shape[-1]
    if nb == 1:
        _add_(grad_mu, vdmu, start, slice_offset, 1)
        _add_(grad_prec.diag, vddmu, start, slice_offset, 2)
        return grad_mu, grad_prec
    if nb == 2:
        lead = vdmu.shape[:-1]
        vdmu_b = vdmu.reshape(*lead, 2, s)
        _add_(grad_mu, vdmu_b[..., 0, :], start, slice_offset, 1)
        _add_(grad_mu, vdmu_b[..., 1, :], start, slice_offset, 1, 1)
        vddmu_b = vddmu.reshape(*lead, 2, s, 2, s)
        _add_(grad_prec.diag, vddmu_b[..., 0, :, 0, :], start, slice_offset, 2)
        _add_(grad_prec.diag, vddmu_b[..., 1, :, 1, :], start, slice_offset,
              2, 1)
        _add_(grad_prec.off, vddmu_b[..., 0, :, 1, :], start, slice_offset, 2)
        return grad_mu, grad_prec
    raise NotImplementedError(f"factor span nb={nb} not supported (use 1 or 2)")
