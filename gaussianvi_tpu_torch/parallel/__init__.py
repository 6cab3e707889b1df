"""Multi-rank execution of the GVI loop (counterpart of
``gaussianvi_tpu/parallel``): the (dp, fp) factor-parallel path, the
sequence-parallel path (the chain's states sharded over ``sp``) and
parallel restarts."""

from ..batching import stack_problems
from .chain_seqpar import (
    gbp_covariance_logdet_seqpar,
    pad_off_for_seqpar,
    solve_seqpar,
)
from .collective import Mesh, make_mesh
from .restarts import best_of_restarts, optimize_restarts, perturb_inits
from .sharding import (
    optimize_sharded,
    shard_graph,
    shard_state,
    sharded_ngd_step,
)
from .time_sharding import (
    optimize_time_sharded,
    sharded_time_ngd_step,
    to_chain_layout,
)

__all__ = [
    "Mesh", "make_mesh", "sharded_ngd_step", "optimize_sharded",
    "shard_graph", "shard_state", "stack_problems",
    "optimize_restarts", "best_of_restarts", "perturb_inits",
    "gbp_covariance_logdet_seqpar", "solve_seqpar", "pad_off_for_seqpar",
    "sharded_time_ngd_step", "optimize_time_sharded", "to_chain_layout",
]
