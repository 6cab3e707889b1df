"""The (dp, fp) mesh of ranks and its collectives on ``torch.distributed``.

The port's stand-in for ``jax.sharding.Mesh`` and ``lax.psum`` as
``gaussianvi_tpu/parallel/sharding.py`` uses them.  The program is SPMD:
one process per mesh position, every process calls the same functions in
the same order.  Rank ``r`` of the process group sits at ``(dp index, fp
index) = divmod(r, fp)``; the ranks of one dp row form a subgroup, and the
only traffic is within it: sums over ``fp`` (``psum``) and the all-gather
that reassembles a factor axis sharded over ``fp``.  Nothing crosses dp
rows.

Backends: NCCL reduces CUDA tensors between GPUs, one per rank.  gloo
reduces CPU tensors, and CUDA tensors too (ranks sharing one card, where
NCCL refuses duplicate devices): its CUDA path copies through host memory
inside ``torch.distributed``.  Nothing here falls back from one backend to
the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    """A ``dp x fp`` grid over the first ``dp * fp`` ranks of the default
    process group (or the single process, for a 1 x 1 mesh without one).

    ``all_reduces`` counts the reductions run on the fp group."""

    def __init__(self, dp: int, fp: int):
        if dp < 1 or fp < 1:
            raise ValueError(f"mesh {dp}x{fp}: both axes must be >= 1")
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if dp * fp > world:
            raise ValueError(
                f"mesh {dp}x{fp} needs {dp * fp} ranks, have {world}")
        self.dp, self.fp = dp, fp
        self.rank = dist.get_rank() if initialized else 0
        self.backend = dist.get_backend() if initialized else None
        self.member = self.rank < dp * fp
        self.dp_index, self.fp_index = divmod(self.rank, fp)
        self.group = None
        if fp > 1:
            # every rank of the world creates every subgroup, in one order
            for row in range(dp):
                ranks = list(range(row * fp, (row + 1) * fp))
                group = dist.new_group(ranks)
                if self.member and row == self.dp_index:
                    self.group = group
        self.all_reduces = 0

    def _require_member(self):
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside the "
                             f"{self.dp}x{self.fp} mesh")

    def _all_reduce(self, x: torch.Tensor, op) -> None:
        """In-place reduction of contiguous ``x`` over the fp group."""
        self.all_reduces += 1
        dist.all_reduce(x, op=op, group=self.group)

    def psum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum contiguous ``x`` over the fp group, in place; every rank of
        the group ends with the same bits."""
        self._require_member()
        if self.fp > 1:
            if not x.is_contiguous():
                raise ValueError("psum_ needs a contiguous tensor")
            self._all_reduce(x, dist.ReduceOp.SUM)
        return x

    def psum(self, *tensors: torch.Tensor):
        """The sums over the fp group of several tensors, packed into one
        all-reduce; returns new tensors (one, or a tuple)."""
        self._require_member()
        if self.fp == 1:
            out = tensors
        else:
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self._all_reduce(flat, dist.ReduceOp.SUM)
            out = tuple(p.view(t.shape) for p, t in zip(
                flat.split([t.numel() for t in tensors]), tensors))
        return out[0] if len(out) == 1 else out

    def all_gather_fp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every fp rank's ``x`` along ``dim`` in fp order (the
        order a factor axis was sharded in)."""
        self._require_member()
        if self.fp == 1:
            return x
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.fp)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim)

    def differs_over_fp(self, x: torch.Tensor) -> bool:
        """Whether any rank of the fp group holds other bits in ``x`` than
        the rest (NaNs count as equal).  Every rank gets the same answer,
        so all of them can raise together."""
        self._require_member()
        if self.fp == 1:
            return False
        v = torch.nan_to_num(x.detach().double().reshape(-1), nan=0.0,
                             posinf=1e308, neginf=-1e308)
        both = torch.cat([v, -v])
        self._all_reduce(both, dist.ReduceOp.MAX)   # max(v), -min(v)
        hi, neg_lo = both.split(v.numel())
        return bool((hi != -neg_lo).any())


def make_mesh(dp: int, fp: int) -> Mesh:
    """The ``dp x fp`` mesh over the initialised process group; raises
    ``ValueError`` when it needs more ranks than the group has.  Collective:
    every rank of the group calls it with the same arguments."""
    return Mesh(dp, fp)
