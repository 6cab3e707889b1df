"""The mesh of ranks and its collectives on ``torch.distributed``.

The port's stand-in for ``jax.sharding.Mesh`` and the collectives
(``lax.psum``, ``lax.all_gather``, ``lax.ppermute``) that
``gaussianvi_tpu/parallel/{sharding,chain_seqpar,time_sharding}.py`` use.
The program is SPMD: one process per mesh position, every process calls the
same functions in the same order.  A mesh is ``dp`` rows of one inner axis,
either ``fp`` (the nonlinear factors sharded) or ``sp`` (the chain's states
sharded): rank ``r`` sits at ``(dp index, inner index) = divmod(r, fp *
sp)``; the ranks of one row form a subgroup, and the only traffic is within
it.  Nothing crosses rows.

Backends: NCCL reduces CUDA tensors between GPUs, one per rank.  gloo
reduces CPU tensors, and CUDA tensors too (ranks sharing one card, where
NCCL refuses duplicate devices): its CUDA path copies through host memory
inside ``torch.distributed``.  Nothing here falls back from one backend to
the other.  The neighbour exchange of the ``sp`` axis (JAX ``ppermute``)
is an all-gather of the boundary rows, from which each rank takes its
neighbour's: gloo's point-to-point calls take CPU tensors only, and with P
ranks the rows are P small blocks.

Every collective a rank runs is recorded in ``Mesh.inventory``, a Counter
of ``(op, shapes, axis)``: ``op`` is ``"all_reduce"``, ``"all_gather"`` or
``"halo"``, ``shapes`` the shapes of the tensors packed into it, ``axis``
``"fp"`` or ``"sp"``.  ``parallel/comm_model.py`` predicts it.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist


class Mesh:
    """``dp`` rows of an ``fp`` or ``sp`` axis over the first ``dp * fp *
    sp`` ranks of the default process group (or the single process, for a
    1 x 1 mesh without one).

    ``all_reduces`` counts the reductions run on the row's group,
    ``inventory`` every collective (see the module)."""

    def __init__(self, dp: int, fp: int, sp: int = 1):
        if dp < 1 or fp < 1 or sp < 1:
            raise ValueError(f"mesh {dp}x{fp}x{sp}: every axis must be >= 1")
        if fp > 1 and sp > 1:
            raise ValueError(f"mesh {dp}x{fp}x{sp}: a mesh shards the "
                             "factors (fp) or the states (sp), not both")
        inner = fp * sp
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        self.shape = f"{dp}x{fp}" if sp == 1 else f"{dp}x1x{sp}"
        if dp * inner > world:
            raise ValueError(
                f"mesh {self.shape} needs {dp * inner} ranks, have {world}")
        self.dp, self.fp, self.sp = dp, fp, sp
        self.size = inner
        self.axis = "sp" if sp > 1 else "fp"
        self.rank = dist.get_rank() if initialized else 0
        self.backend = dist.get_backend() if initialized else None
        self.member = self.rank < dp * inner
        self.dp_index, self.index = divmod(self.rank, inner)
        self.fp_index = self.index if sp == 1 else 0
        self.group = None
        if inner > 1:
            # every rank of the world creates every subgroup, in one order
            for row in range(dp):
                ranks = list(range(row * inner, (row + 1) * inner))
                group = dist.new_group(ranks)
                if self.member and row == self.dp_index:
                    self.group = group
        self.all_reduces = 0
        self.inventory = Counter()

    def _require_member(self):
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is outside the {self.shape} mesh")

    def _record(self, op: str, *tensors: torch.Tensor):
        self.inventory[op, tuple(tuple(t.shape) for t in tensors),
                       self.axis] += 1

    def _all_reduce(self, x: torch.Tensor, op, *packed) -> None:
        """In-place reduction of contiguous ``x`` over the row's group;
        ``packed``: the tensors ``x`` packs, for the inventory."""
        self.all_reduces += 1
        self._record("all_reduce", *(packed or (x,)))
        dist.all_reduce(x, op=op, group=self.group)

    def _gather_stacked(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading axis, rank order."""
        out = torch.empty((self.size, *x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x.contiguous(),
                        group=self.group)
        return out

    def psum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum contiguous ``x`` over the row's group, in place; every rank
        of the group ends with the same bits."""
        self._require_member()
        if self.size > 1:
            if not x.is_contiguous():
                raise ValueError("psum_ needs a contiguous tensor")
            self._all_reduce(x, dist.ReduceOp.SUM)
        return x

    def psum(self, *tensors: torch.Tensor):
        """The sums over the row's group of several tensors, packed into
        one all-reduce; returns new tensors (one, or a tuple)."""
        self._require_member()
        if self.size == 1:
            out = tensors
        else:
            flat = torch.cat([t.reshape(-1) for t in tensors])
            self._all_reduce(flat, dist.ReduceOp.SUM, *tensors)
            out = tuple(p.view(t.shape) for p, t in zip(
                flat.split([t.numel() for t in tensors]), tensors))
        return out[0] if len(out) == 1 else out

    def all_gather(self, *tensors: torch.Tensor):
        """Every rank's tensors stacked on a new leading axis of the row's
        size, in rank order (``lax.all_gather``), packed into one
        collective; returns new tensors (one, or a tuple)."""
        self._require_member()
        if self.size == 1:
            out = tuple(t.unsqueeze(0) for t in tensors)
        else:
            self._record("all_gather", *tensors)
            flat = self._gather_stacked(
                torch.cat([t.reshape(-1) for t in tensors]))
            out = tuple(p.reshape(self.size, *t.shape) for p, t in zip(
                flat.split([t.numel() for t in tensors], dim=1), tensors))
        return out[0] if len(out) == 1 else out

    def halo(self, *tensors: torch.Tensor, offset: int):
        """The tensors of the rank ``offset`` places along the row, wrapping
        around (``lax.ppermute``): ``offset = 1`` receives the right
        neighbour's, ``-1`` the left's.  One exchange for all of them (an
        all-gather of the packed rows); returns new tensors (one, or a
        tuple)."""
        self._require_member()
        if self.size == 1:
            out = tuple(t.clone() for t in tensors)
        else:
            self._record("halo", *tensors)
            flat = self._gather_stacked(
                torch.cat([t.reshape(-1) for t in tensors]))
            row = flat[(self.index + offset) % self.size]
            out = tuple(p.view(t.shape) for p, t in zip(
                row.split([t.numel() for t in tensors]), tensors))
        return out[0] if len(out) == 1 else out

    def all_gather_cat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` in rank order (the
        order an axis was sharded in)."""
        self._require_member()
        if self.size == 1:
            return x
        self._record("all_gather", x)
        parts = self._gather_stacked(x)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def differs(self, x: torch.Tensor) -> bool:
        """Whether any rank of the row holds other bits in ``x`` than the
        rest (NaNs count as equal).  Every rank gets the same answer, so
        all of them can raise together."""
        self._require_member()
        if self.size == 1:
            return False
        v = torch.nan_to_num(x.detach().double().reshape(-1), nan=0.0,
                             posinf=1e308, neginf=-1e308)
        both = torch.cat([v, -v])
        self._all_reduce(both, dist.ReduceOp.MAX)   # max(v), -min(v)
        hi, neg_lo = both.split(v.numel())
        return bool((hi != -neg_lo).any())


def make_mesh(dp: int, fp: int, sp: int = 1) -> Mesh:
    """The ``dp x fp`` (factor-parallel) or ``dp x 1 x sp``
    (sequence-parallel) mesh over the initialised process group; raises
    ``ValueError`` when it needs more ranks than the group has.
    Collective: every rank of the group calls it with the same
    arguments."""
    return Mesh(dp, fp, sp)
