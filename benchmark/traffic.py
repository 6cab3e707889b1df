"""The general generator: a cell's traffic file (``workloads/<cell>.json``)
turned into the pool of calls its window cycles through.

Traffic parameters:

* ``requests_per_call``, ``per_request``: a call serves that many
  requests of that many problems each (restarts of one plan, or one
  trajectory), all in one ``optimize`` call;
* ``pool_calls``: distinct calls drawn in set-up and cycled in the window;
* ``kept_per_call``: problems of each timed call whose outputs are kept,
  drawn from the seed; ``checked``: how many of those the reference
  judges after the window;
* ``traced_calls``: calls from the middle of the window that a traced run
  profiles.

Call p of the pool draws its inputs from the seed's stream (0, p) through
the configuration's family, so every seed gives every call the same sizes
and the same work, other data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def seed_seq(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's draws (any whole seed)."""
    return np.random.default_rng([seed & (2**64 - 1), *stream])


@dataclass
class Call:
    graph: object
    state: object
    inputs: dict
    problems: int


def make_pool(cell, seed: int, dtype, device) -> list[Call]:
    from gaussianvi_tpu_torch.convert import state_from_arrays

    cfg, tr = cell.cfg, cell.traffic
    cell.shared = cell.family.make_shared(cfg)
    pool = []
    for p in range(tr["pool_calls"]):
        inputs = cell.family.make_inputs(cfg, seed_seq(seed, 0, p),
                                         tr["requests_per_call"],
                                         tr["per_request"])
        graph = cell.family.build_program(cfg, inputs, dtype, device,
                                          cell.shared)
        mu = inputs["init_mu"]
        count, n, s = mu.shape
        eye = np.eye(s) * cfg["init_prec_scale"]
        state = state_from_arrays(
            {"mu": mu, "prec_diag": np.broadcast_to(eye, (count, n, s, s)),
             "prec_off": np.zeros((count, n - 1, s, s))}, dtype, device)
        pool.append(Call(graph, state, inputs, count))
    return pool


def rows(pool: list[Call], picks) -> dict:
    """The raw inputs of the problems ``picks`` ([(call, row)]), stacked."""
    keys = pool[0].inputs
    return {k: np.stack([pool[c].inputs[k][r] for c, r in picks])
            for k in keys}
