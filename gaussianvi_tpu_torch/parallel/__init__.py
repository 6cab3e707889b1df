"""Multi-rank execution of the GVI loop (counterpart of
``gaussianvi_tpu/parallel``): the (dp, fp) factor-parallel path and parallel
restarts.  The sequence-parallel chain of the JAX package
(``time_sharding``, ``chain_seqpar``, ``comm_model``, ``scaling_bench``) is
not ported: its entry points raise ``NotImplementedError``."""

from ..batching import stack_problems
from .collective import Mesh, make_mesh
from .restarts import best_of_restarts, optimize_restarts, perturb_inits
from .sharding import (
    optimize_sharded,
    shard_graph,
    shard_state,
    sharded_ngd_step,
)

_SEQPAR = ("the sequence-parallel chain ({name}) is not ported yet "
           "(ROADMAP.md, Queue A 11: time_sharding, chain_seqpar, "
           "comm_model, scaling_bench)")


def _not_ported(name):
    def entry(*args, **kwargs):
        raise NotImplementedError(_SEQPAR.format(name=name))

    entry.__name__ = name
    entry.__doc__ = "Not ported: raises ``NotImplementedError``."
    return entry


gbp_covariance_logdet_seqpar = _not_ported("gbp_covariance_logdet_seqpar")
solve_seqpar = _not_ported("solve_seqpar")
pad_off_for_seqpar = _not_ported("pad_off_for_seqpar")
sharded_time_ngd_step = _not_ported("sharded_time_ngd_step")
optimize_time_sharded = _not_ported("optimize_time_sharded")
to_chain_layout = _not_ported("to_chain_layout")

__all__ = [
    "Mesh", "make_mesh", "sharded_ngd_step", "optimize_sharded",
    "shard_graph", "shard_state", "stack_problems",
    "optimize_restarts", "best_of_restarts", "perturb_inits",
    "gbp_covariance_logdet_seqpar", "solve_seqpar", "pad_off_for_seqpar",
    "sharded_time_ngd_step", "optimize_time_sharded", "to_chain_layout",
]
