"""Example problems: chain estimation (the flagship), the Barfoot 1-D
example, LTV estimation, and the planar, 3-D point, quadrotor and 7-DOF
arm planners."""

from .arm_planning import build_arm_planning, run_arm_planning
from .barfoot_1d import barfoot_cost, build_barfoot_1d, run_barfoot_1d
from .chain_estimation import build_chain_estimation, run_chain_estimation
from .ltv_estimation import build_ltv_estimation, run_ltv_estimation
from .planar_planning import build_planar_planning, run_planar_planning
from .point3d_planning import build_point3d_planning, run_point3d_planning
from .quadrotor_planning import build_quadrotor_planning, run_quadrotor_planning

__all__ = [
    "barfoot_cost", "build_barfoot_1d", "run_barfoot_1d",
    "build_chain_estimation", "run_chain_estimation",
    "build_ltv_estimation", "run_ltv_estimation",
    "build_planar_planning", "run_planar_planning",
    "build_arm_planning", "run_arm_planning",
    "build_quadrotor_planning", "run_quadrotor_planning",
    "build_point3d_planning", "run_point3d_planning",
]
