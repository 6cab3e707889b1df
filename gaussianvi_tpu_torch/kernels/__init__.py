"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and,
while a profiler records, marks each launch with its host-side prep as the
span ``gvi.kernel.<key>``, ``<key>`` its name in :data:`WRAPPERS`
(``utils.profiling.span``).  A call whose loop replays as a CUDA graph
(``inference/loop_graph.py``) counts the launches its captured run made;
:func:`loop_graph_counts` counts the calls by how their loop ran, and
:func:`quad_route_counts` the nonlinear batches by the quadrature route
the engine resolved them to.
"""

from .chain import gbp_covariance_logdet_lanes, gbp_trials_lanes, solve_lanes
from .fused_gradient import (
    gradient_accum_lanes,
    gradient_lanes,
    gradient_solve_lanes,
)
from . import fused_moments as _fused_moments  # the name stays the module
from .fused_trials import trial_costs_lanes
from .quad import (
    quad_arm_moments,
    quad_arm_phi,
    quad_lanes_moments,
    quad_lanes_phi,
)

WRAPPERS = {
    "gbp_covariance_logdet": gbp_covariance_logdet_lanes,
    "solve": solve_lanes,
    "gbp_trials": gbp_trials_lanes,
    "quad_phi": quad_lanes_phi,
    "quad_moments": quad_lanes_moments,
    "quad_arm_phi": quad_arm_phi,
    "quad_arm_moments": quad_arm_moments,
    "fused_moments": _fused_moments.fused_moments,
    "fused_trials": trial_costs_lanes,
    "fused_gradient": gradient_lanes,
    "fused_gradient_accum": gradient_accum_lanes,
    "fused_gradient_solve": gradient_solve_lanes,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ``optimize`` / ``optimize_from`` calls by how their loop ran, counted by
# ``inference/loop_graph.py`` and reset with the launch counts
LOOP_GRAPH_COUNTS = {"eager": 0, "captured": 0, "replayed": 0}


def loop_graph_counts() -> dict[str, int]:
    """``optimize`` / ``optimize_from`` calls since the last reset by how
    their loop ran: ``eager``, ``captured`` into a CUDA graph (and that
    graph run once), ``replayed``."""
    return dict(LOOP_GRAPH_COUNTS)


# nonlinear batches by the quadrature route ``inference.engine.LocalEngine``
# resolved them to, one count a batch an engine: ``kernel`` (K3) or
# ``plain``, reset with the launch counts
QUAD_ROUTE_COUNTS = {"kernel": 0, "plain": 0}


def quad_route_counts() -> dict[str, int]:
    """Nonlinear batches since the last reset by the quadrature route the
    engine resolved them to: ``kernel`` or ``plain`` (a batch the kernels
    do not cover falls back to the plain quadrature here)."""
    return dict(QUAD_ROUTE_COUNTS)


def reset_launch_counts() -> None:
    """Zero the launch counts, the loop graph counts and the quadrature
    route counts."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for counts in (LOOP_GRAPH_COUNTS, QUAD_ROUTE_COUNTS):
        for key in counts:
            counts[key] = 0
