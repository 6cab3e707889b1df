"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from .chain import gbp_covariance_logdet_lanes, solve_lanes
from .quad import quad_lanes_moments, quad_lanes_phi

WRAPPERS = {
    "gbp_covariance_logdet": gbp_covariance_logdet_lanes,
    "solve": solve_lanes,
    "quad_phi": quad_lanes_phi,
    "quad_moments": quad_lanes_moments,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
