"""Per-iteration communication accounting for the sharded engines.

Counterpart of ``gaussianvi_tpu/parallel/comm_model.py``: an analytic model
of every collective a sharded iteration issues (what crosses between
ranks, how many bytes, against how many on-device FLOPs).  JAX checks its
model against the traced program (``collective_inventory`` walks the
jaxpr); here the check is against what actually ran: every
:class:`~.collective.Mesh` records each collective it issues in
``Mesh.inventory`` as ``(op, shapes, axis)``, and a run of ``niters``
iterations records ``niters * per_iteration + setup`` (:func:`expected`).

The factor-parallel step's communication (the all-reduce replacing the
reference's OpenMP critical section, ngd/NGD-GH-impl.h:33-51) is small and
N-proportional while its compute is N*K*M-proportional.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CommReport:
    bytes_per_iter: int        # collective payload bytes over the fp axis
    flops_per_iter: int        # approximate on-device FLOPs per problem-iter
    collectives: tuple         # ((op, shapes, axis), count) entries

    @property
    def flops_per_byte(self) -> float:
        return self.flops_per_iter / max(self.bytes_per_iter, 1)


def expected(per_iteration: Counter, niters: int, setup: Counter) -> Counter:
    """The inventory of a whole run: ``niters`` iterations and the run's
    own collectives."""
    out = Counter(setup)
    for key, count in per_iteration.items():
        out[key] += niters * count
    return out


def factor_shard_model(n: int, s: int, n_trials: int, m_nodes: int,
                       k_nl: int, local_batch: int = 1, itemsize: int = 8,
                       fused: bool = False) -> tuple[Counter, CommReport]:
    """Predicted collectives of ONE ``optimize_sharded`` NGD iteration on a
    rank of an fp >= 2 row (``FactorShardEngine``, batched line search),
    per local batch of ``b = local_batch`` problems:

      * top-of-iteration cost: one ``[b]`` all-reduce;
      * gradient assembly: Vdmu ``[b, N, s]``, Vddmu diag ``[b, N, s, s]``
        and off ``[b, N-1, s, s]`` packed into one all-reduce (``fused``:
        the K6 ``accum`` buffer, the same values flat);
      * line search: one ``[T, b]`` all-reduce of the trial costs.

    The payload is the JAX package's: the same sums, packed."""
    b = local_batch
    grad = ((b, n, s), (b, n, s, s), (b, n - 1, s, s))
    if fused:
        grad = ((int(sum(np.prod(g) for g in grad)),),)
    per_iter = Counter({
        ("all_reduce", ((b,),), "fp"): 1,
        ("all_reduce", grad, "fp"): 1,
        ("all_reduce", ((n_trials, b),), "fp"): 1,
    })
    payload = b * (1 + n * s + n * s * s + n_trials) + b * (n - 1) * s * s
    # per-problem FLOP model (order of magnitude; the quadrature dominates):
    #   quadrature: (1 + n_trials) cost passes + 1 moment pass over K
    #   factors x M nodes x ~(s^2 sigma placement + ~20 cost flops)
    #   chain: (1 + n_trials) sweeps x N x ~14 s^3 (chol + solves + edge inv)
    quad = (2 + n_trials) * k_nl * m_nodes * (s * s + 20)
    chain = (1 + n_trials) * n * 14 * s ** 3
    report = CommReport(
        bytes_per_iter=payload * itemsize,
        flops_per_iter=int(b * (quad + chain)),
        collectives=tuple(sorted(per_iter.items())),
    )
    return per_iter, report


def factor_shard_setup(n: int, s: int, niters: int, k_local: tuple,
                       local_batch: int = 1) -> Counter:
    """The collectives of an ``optimize_sharded`` run outside its
    iterations, fp >= 2: the gather of each nonlinear batch's per-factor
    costs (``k_local``: each batch's factors on one rank) and the three
    lockstep checks (accepted steps, final mean, final precision; each a
    max-reduction of the values and their negatives)."""
    b = local_batch
    out = Counter()
    for k in k_local:
        out["all_gather", ((b, niters, k),), "fp"] += 1
    for numel in (b * niters, b * n * s, b * n * s * s):
        out["all_reduce", ((2 * numel,),), "fp"] += 1
    return out


def _chain_cov(lead: tuple, s: int) -> Counter:
    """``chain_seqpar.gbp_covariance_logdet_seqpar`` over leading axes
    ``lead``: two halos (the first diagonal block, the first backward
    pivot), one all-gather of both directions' summaries, the log det's
    all-reduce."""
    mat = lead + (s, s)
    return Counter({("halo", (mat,), "sp"): 2,
                    ("all_gather", (mat,) * 6, "sp"): 1,
                    ("all_reduce", (lead,), "sp"): 1})


def _chain_solve(lead: tuple, s: int) -> Counter:
    """``chain_seqpar.solve_seqpar``: the forward pivots' summaries with
    the first rhs rows, then each sweep's (M, c) summaries."""
    mat, vec = lead + (s, s), lead + (s,)
    return Counter({("all_gather", (mat, mat, mat, vec), "sp"): 1,
                    ("all_gather", (mat, vec), "sp"): 2})


def _edge_halo(lead: tuple, s: int) -> Counter:
    """One exchange of a boundary mean row and covariance block (the edge
    marginals, or the edge gradients' reverse halo)."""
    return Counter({("halo", (lead + (s,), lead + (s, s)), "sp"): 1})


# chain estimation in chain layout (the configuration both models count):
# one nonlinear batch, the anchor and the GP prior, the last one nb == 2
_BATCHES = 3


def time_shard_model(n: int, s: int, n_trials: int, mesh,
                     method: str = "ngd") -> Counter:
    """Predicted collectives of ONE ``optimize_time_sharded`` iteration of
    one chain-estimation problem (``TimeShardEngine``, batched line
    search), as every rank of the ``sp`` row runs them:

      * the cost at the top of the iteration: one scalar all-reduce;
      * the gradients: the edge marginals' halo and the nb == 2 batch's
        reverse halo (``_scatter_edge``); NGD adds one sequence-parallel
        solve of the stacked pair (main and fallback metric) and the
        ``all_finite`` all-reduce;
      * the ``T`` trials at once: a chain covariance over ``[T]``, the edge
        halo, the ``[T]`` trial-cost all-reduce.

    ``n`` does not change the shapes (only boundary rows and segment
    summaries travel); a mesh of one rank runs no collective."""
    del n
    if mesh.size == 1:
        return Counter()
    per_iter = Counter({("all_reduce", ((),), "sp"): 1})
    per_iter += _edge_halo((), s) + _edge_halo((), s)
    if method == "ngd":
        per_iter += _chain_solve((2,), s)
        per_iter["all_reduce", ((),), "sp"] += 1
    per_iter += _chain_cov((n_trials,), s) + _edge_halo((n_trials,), s)
    per_iter["all_reduce", ((n_trials,),), "sp"] += 1
    return per_iter


def time_shard_setup(n: int, s: int, niters: int, mesh) -> Counter:
    """The collectives of an ``optimize_time_sharded`` run of chain
    estimation outside its iterations: the initial covariance and edge
    halo, the two lockstep checks (accepted steps and costs), and the one
    all-gather of the segments' final state and history."""
    if mesh.size == 1:
        return Counter()
    nl = n // mesh.size
    out = _chain_cov((), s) + _edge_halo((), s)
    out["all_reduce", ((2 * niters,),), "sp"] += 2
    vec, mat = (nl, s), (nl, s, s)
    hist = tuple((niters, *x) for x in (vec, mat, mat, mat, mat))
    out["all_gather", (vec, mat, mat, *hist) + ((niters, nl),) * _BATCHES,
        "sp"] += 1
    return out


def print_report(tag: str, rep: CommReport):
    print(f"[{tag}] collective bytes/iter = {rep.bytes_per_iter}  "
          f"~flops/iter = {rep.flops_per_iter:.3g}  "
          f"flops-per-collective-byte = {rep.flops_per_byte:.0f}")
    for (name, shapes, ax), ct in rep.collectives:
        print(f"    {ct}x {name} {shapes} over {ax}")
