"""Example problems: chain estimation (the flagship), the Barfoot 1-D
example, and the planar, 3-D point, quadrotor and 7-DOF arm planners."""

from .arm_planning import build_arm_planning, run_arm_planning
from .barfoot_1d import barfoot_cost, build_barfoot_1d, run_barfoot_1d
from .chain_estimation import build_chain_estimation, run_chain_estimation

__all__ = [
    "barfoot_cost", "build_barfoot_1d", "run_barfoot_1d",
    "build_chain_estimation", "run_chain_estimation",
    "build_arm_planning", "run_arm_planning",
]
