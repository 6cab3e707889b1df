"""Factor-graph input validation.

Counterpart of ``gaussianvi_tpu/inference/validate.py``: checks the
wiring of a graph up front, with errors that say what is wrong, before a
malformed batch reads or writes the wrong state blocks.  Host-side.
"""

from __future__ import annotations

import numpy as np

from ..factors.base import param_leaves
from .graph import FactorGraph, GaussianState


def validate_graph(graph: FactorGraph, state: GaussianState | None = None):
    """Raise ``ValueError`` on inconsistent factor wiring.  Per-problem
    starts ``[B, K]`` are checked row by row; param leaves must carry the
    factor axis after the problem axes, which ``state`` gives (none without
    it)."""
    n, s = graph.num_states, graph.state_dim
    lead = 0 if state is None else state.mu.ndim - 2
    for kind, batches in (("nonlinear", graph.nonlinear),
                          ("linear", graph.linear)):
        for idx, fb in enumerate(batches):
            name = f"{kind}[{idx}]"
            starts = fb.start.detach().cpu().numpy()
            if starts.ndim not in (1, 2):
                raise ValueError(f"{name}: start must be [K] or [B, K], got "
                                 f"{starts.shape}")
            if starts.size and (starts.min() < 0 or starts.max() > n - fb.nb):
                raise ValueError(
                    f"{name}: start indices must lie in [0, {n - fb.nb}] "
                    f"for nb={fb.nb}, got range "
                    f"[{starts.min()}, {starts.max()}]")
            k = starts.shape[-1]
            if fb.slice_offset is not None:
                # gathers and scatters read a slice and ignore `start` when
                # slice_offset is set: a hand-built batch whose starts
                # disagree would touch the wrong state blocks
                expect = fb.slice_offset + np.arange(k)
                if not (starts == expect).all():
                    raise ValueError(
                        f"{name}: slice_offset={fb.slice_offset} requires "
                        f"start == slice_offset + arange(K); got {starts}")
                if k and (fb.slice_offset < 0
                          or fb.slice_offset + k - 1 > n - fb.nb):
                    raise ValueError(
                        f"{name}: slice_offset range [{fb.slice_offset}, "
                        f"{fb.slice_offset + k - 1}] exceeds "
                        f"[0, {n - fb.nb}] for nb={fb.nb}")
            d = fb.nb * s
            if kind == "nonlinear":
                if fb.nodes.shape[-1] != d:
                    raise ValueError(
                        f"{name}: quadrature dim {fb.nodes.shape[-1]} != "
                        f"nb*state_dim = {d}")
                if fb.nodes.shape[0] != fb.weights.shape[0]:
                    raise ValueError(
                        f"{name}: nodes/weights length mismatch "
                        f"{fb.nodes.shape[0]} vs {fb.weights.shape[0]}")
                for leaf in param_leaves(fb.params):
                    if tuple(leaf.shape[lead:lead + 1]) != (k,):
                        raise ValueError(
                            f"{name}: param leaf leading axis "
                            f"{tuple(leaf.shape[lead:lead + 1])} != num "
                            f"factors ({k},)")
            elif fb.lam.shape[-1] != d:
                raise ValueError(
                    f"{name}: Lam trailing dim {fb.lam.shape[-1]} != "
                    f"nb*state_dim = {d}")
    if state is not None:
        if tuple(state.mu.shape[-2:]) != (n, s):
            raise ValueError(
                f"state.mu shape {tuple(state.mu.shape)} does not end in "
                f"(num_states, state_dim) = ({n}, {s})")
        if tuple(state.precision.diag.shape[-3:]) != (n, s, s):
            raise ValueError(
                f"precision.diag shape {tuple(state.precision.diag.shape)} "
                f"does not end in ({n}, {s}, {s})")
        if tuple(state.precision.off.shape[-3:]) != (max(n - 1, 0), s, s):
            raise ValueError(
                f"precision.off shape {tuple(state.precision.off.shape)} "
                f"does not end in ({max(n - 1, 0)}, {s}, {s})")
