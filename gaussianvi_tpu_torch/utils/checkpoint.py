"""Checkpoint / resume of an optimization run (the ``npz`` route).

Counterpart of ``gaussianvi_tpu/utils/checkpoint.py``.  A checkpoint holds
the whole loop state: (mu, precision blocks, iteration, temperature,
is_lowtemp, converged).  The covariance, log det and factor costs are
functions of (mu, Lambda), recomputed on resume by
``inference.optimize.make_gvi_init``, so a run resumed through
``optimize_from`` follows the uninterrupted one exactly.  A batch of
problems writes its loop values per problem (``[B]``); a file the JAX
package wrote (scalar loop values, one problem) loads here too, and the
port's loads there.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blocktridiag import BlockTridiag

if TYPE_CHECKING:
    from ..inference.graph import GaussianState


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def save_checkpoint(path: str, state: GaussianState, iteration: int = 0,
                    temperature=1.0, is_lowtemp=True,
                    converged=False) -> str:
    """Write ``path`` (``.npz`` appended where missing); the loop values
    are scalars or one per problem.  Returns the file's path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        mu=_numpy(state.mu),
        prec_diag=_numpy(state.precision.diag),
        prec_off=_numpy(state.precision.off),
        iteration=np.asarray(iteration),
        temperature=_numpy(temperature),
        is_lowtemp=_numpy(is_lowtemp),
        converged=_numpy(converged),
    )
    return path if path.endswith(".npz") else path + ".npz"


def load_checkpoint(path: str, dtype=None, device=None):
    """``(state, iteration, temperature, is_lowtemp)``, the JAX package's
    4-tuple (scalar loop values: one problem); :func:`load_loop_state`
    gives the whole resume payload."""
    state, it, loop = load_loop_state(path, dtype, device)
    return state, it, float(loop.temperature), bool(loop.is_lowtemp)


def load_loop_state(path: str, dtype=None, device=None):
    """``(state, iteration, LoopState)``; pass the last two to
    ``optimize_from(..., start_iteration=it, loop_state=loop)``.
    ``dtype=None`` keeps the file's; ``device=None`` is the card."""
    # the loop imports the package's span helper from utils, so utils
    # reaches the loop's types at call time
    from ..inference.graph import GaussianState
    from ..inference.optimize import LoopState

    device = resolve_device(device)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(
                dt or torch.as_tensor(np.asarray(a)).dtype)

        mu = t(data["mu"])
        state = GaussianState(mu, BlockTridiag(t(data["prec_diag"]),
                                               t(data["prec_off"])))
        # checkpoints from before the full-state format lack `converged`
        conv = data["converged"] if "converged" in data else False
        loop = LoopState(t(data["temperature"], mu.dtype),
                         t(data["is_lowtemp"], torch.bool),
                         t(np.asarray(conv), torch.bool))
        return state, int(data["iteration"]), loop
