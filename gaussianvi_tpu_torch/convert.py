"""Carry a problem over from plain arrays: the JAX package's factor graph
and variational state, described without JAX objects.

The description of one problem is a dict::

    {"num_states": N, "state_dim": s,
     "nonlinear": [{"start", "nodes", "weights", "params": {name: array},
                    "nb", "slice_offset", "nonneg_cost", "quad_rdim",
                    "shared_start", "cost": <name in COSTS>,
                    "block_cost": bool (optional)}, ...],
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

from .device import resolve_device
from .examples.chain_estimation import range_cost, range_cost_block
from .factors.base import LinearFactorBatch, NonlinearFactorBatch, pack_params
from .inference.graph import FactorGraph, GaussianState
from .ops.blocktridiag import BlockTridiag

# cost name -> (PyTorch cost_fn, CUDA functor name for the kernel path,
# PyTorch block form); a description's "block_cost" flag says whether the
# JAX batch carried a block form (``block_cost is not None``)
COSTS = {"range": (range_cost, "range", range_cost_block)}


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _start(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def graph_from_arrays(desc: dict, dtype=torch.float64,
                      device=None) -> FactorGraph:
    """The port's :class:`FactorGraph` for one problem's description
    (``device=None``: the card, ``device.default_device``)."""
    device = resolve_device(device)
    nonlinear = []
    for fb in desc["nonlinear"]:
        cost_fn, kernel_cost, block_cost = COSTS[fb["cost"]]
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
            block_cost=block_cost if fb.get("block_cost") else None,
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
    "prec_off"}`` (``device=None``: the card)."""
    device = resolve_device(device)
    return GaussianState(
        _t(desc["mu"], dtype, device),
        BlockTridiag(_t(desc["prec_diag"], dtype, device),
                     _t(desc["prec_off"], dtype, device)),
    )
