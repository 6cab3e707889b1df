"""Carry a problem over from plain arrays: the JAX package's factor graph
and variational state, described without JAX objects.

The description of one problem is a dict::

    {"num_states": N, "state_dim": s,
     "nonlinear": [{"start", "nodes", "weights", "params": {name: array},
                    "nb", "slice_offset", "nonneg_cost", "quad_rdim",
                    "shared_start", "cost": <name in COSTS>}, ...],
     "linear": [{"start", "lam", "psi", "target_mu", "target_prec",
                 "constant", "nb", "slice_offset", "uniform",
                 "shared_start"}, ...]}

and its state ``{"mu", "prec_diag", "prec_off"}``, all numpy arrays (or
anything ``np.asarray`` takes).  Stack several problems with
:func:`..batching.stack_problems`.
"""

from __future__ import annotations

import numpy as np
import torch

from .examples.chain_estimation import range_cost
from .factors.base import LinearFactorBatch, NonlinearFactorBatch, pack_params
from .inference.graph import FactorGraph, GaussianState
from .ops.blocktridiag import BlockTridiag

# cost name -> (PyTorch cost_fn, CUDA functor name for the kernel path)
COSTS = {"range": (range_cost, "range")}


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _start(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def graph_from_arrays(desc: dict, dtype=torch.float64,
                      device=None) -> FactorGraph:
    """The port's :class:`FactorGraph` for one problem's description."""
    nonlinear = []
    for fb in desc["nonlinear"]:
        cost_fn, kernel_cost = COSTS[fb["cost"]]
        params = {k: _t(v, dtype, device) for k, v in fb["params"].items()}
        nonlinear.append(NonlinearFactorBatch(
            start=_start(fb["start"], device),
            nodes=_t(fb["nodes"], dtype, device),
            weights=_t(fb["weights"], dtype, device),
            params=params,
            cost_fn=cost_fn,
            nb=int(fb["nb"]),
            kernel_cost=kernel_cost,
            kernel_params=pack_params(params),
            slice_offset=fb["slice_offset"],
            shared_start=bool(fb["shared_start"]),
            nonneg_cost=bool(fb["nonneg_cost"]),
            quad_rdim=fb["quad_rdim"],
        ))
    linear = [
        LinearFactorBatch(
            start=_start(lb["start"], device),
            **{k: _t(lb[k], dtype, device) for k in
               ("lam", "psi", "target_mu", "target_prec", "constant")},
            nb=int(lb["nb"]),
            slice_offset=lb["slice_offset"],
            uniform=bool(lb["uniform"]),
            shared_start=bool(lb["shared_start"]),
        )
        for lb in desc["linear"]
    ]
    return FactorGraph(num_states=int(desc["num_states"]),
                       state_dim=int(desc["state_dim"]),
                       nonlinear=tuple(nonlinear), linear=tuple(linear))


def state_from_arrays(desc: dict, dtype=torch.float64,
                      device=None) -> GaussianState:
    """The port's :class:`GaussianState` from ``{"mu", "prec_diag",
    "prec_off"}``."""
    return GaussianState(
        _t(desc["mu"], dtype, device),
        BlockTridiag(_t(desc["prec_diag"], dtype, device),
                     _t(desc["prec_off"], dtype, device)),
    )
