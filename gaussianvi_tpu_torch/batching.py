"""Stack same-structure problems along a leading problem axis.

Counterpart of ``gaussianvi_tpu/parallel/sharding.py:58-101``
(``stack_problems`` and ``_align_slice_offsets``).  JAX stacks every pytree
leaf and runs the batch under ``jax.vmap``; the port stacks the per-problem
data and runs its batched functions directly.  The quadrature rule is one
shared tensor, and start indices stay shared (``[K]``) when every problem
has the same ones, else they stack to ``[B, K]`` with ``shared_start`` and
``slice_offset`` cleared, as in JAX.  A cost's field (``kernel_field``)
is shared like the rule: the problems must hold equal ones, and the
stacked batch keeps the first.
"""

from __future__ import annotations

from dataclasses import fields, replace

import torch

from .factors.base import LinearFactorBatch, NonlinearFactorBatch
from .inference.graph import FactorGraph, GaussianState
from .ops.blocktridiag import BlockTridiag

_NL_DATA = ("kernel_params",)
_LIN_DATA = ("lam", "psi", "target_mu", "target_prec", "constant")
_SHARED = ("nodes", "weights", "kernel_field")
_ALIGNED = ("start", "slice_offset", "shared_start", "uniform", "params")


def _stack_batches(batches):
    first = batches[0]
    updates = {}
    for f in fields(first):
        name = f.name
        values = [getattr(b, name) for b in batches]
        if name in _ALIGNED:
            continue
        if name in _SHARED:
            if any((v is None) != (values[0] is None)
                   or (v is not None and not torch.equal(values[0], v))
                   for v in values[1:]):
                raise ValueError(f"stack_problems: {name} differ between "
                                 "problems (the rule and a cost's field "
                                 "must be shared)")
        elif name in _NL_DATA or name in _LIN_DATA:
            updates[name] = None if values[0] is None else torch.stack(values)
        elif any(v != values[0] for v in values[1:]):
            raise ValueError(f"stack_problems: static field {name} differs "
                             "between problems")
    if isinstance(first, NonlinearFactorBatch) and first.params is not None:
        updates["params"] = {
            k: torch.stack([b.params[k] for b in batches]) for k in first.params
        }
    starts = [b.start for b in batches]
    if all(torch.equal(starts[0], s) for s in starts[1:]):
        offsets = {b.slice_offset for b in batches}
        updates["slice_offset"] = offsets.pop() if len(offsets) == 1 else None
    else:
        updates["start"] = torch.stack(starts)
        updates["slice_offset"] = None
        updates["shared_start"] = False
    if isinstance(first, LinearFactorBatch):
        updates["uniform"] = all(b.uniform for b in batches)
    return replace(first, **updates)


def stack_problems(graphs: list[FactorGraph], states: list[GaussianState]):
    """Stack B same-structure problems: ``(graph_b, state_b)`` with every
    per-problem tensor ``[B, ...]``."""
    g0 = graphs[0]
    for g in graphs[1:]:
        if (g.num_states, g.state_dim, len(g.nonlinear), len(g.linear)) != (
                g0.num_states, g0.state_dim, len(g0.nonlinear),
                len(g0.linear)):
            raise ValueError("stack_problems: problems differ in structure")
    graph_b = FactorGraph(
        num_states=g0.num_states,
        state_dim=g0.state_dim,
        nonlinear=tuple(_stack_batches([g.nonlinear[i] for g in graphs])
                        for i in range(len(g0.nonlinear))),
        linear=tuple(_stack_batches([g.linear[i] for g in graphs])
                     for i in range(len(g0.linear))),
    )
    state_b = GaussianState(
        torch.stack([s.mu for s in states]),
        BlockTridiag(torch.stack([s.precision.diag for s in states]),
                     torch.stack([s.precision.off for s in states])),
    )
    return graph_b, state_b
