"""Factor batches, GP priors, signed-distance fields and sigma-point
moments."""

from .base import LinearFactorBatch, NonlinearFactorBatch, make_nonlinear_batch
from .moments import (
    bw_local_gradients,
    expectation_phi,
    gh_moments,
    linear_cost,
    linear_local_gradients,
    ngd_local_gradients,
    sigma_points,
)
from .sdf import SDF3D, PlanarSDF, hinge_obstacle_cost
from .sdf_io import load_sdf, save_sdf, sdf_from_occupancy

__all__ = [
    "LinearFactorBatch", "NonlinearFactorBatch", "make_nonlinear_batch",
    "gh_moments", "expectation_phi", "sigma_points",
    "ngd_local_gradients", "bw_local_gradients",
    "linear_local_gradients", "linear_cost",
    "PlanarSDF", "SDF3D", "hinge_obstacle_cost",
    "save_sdf", "load_sdf", "sdf_from_occupancy",
]
