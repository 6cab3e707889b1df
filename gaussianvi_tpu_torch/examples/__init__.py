"""Example problems: chain estimation (the flagship) and the planar,
3-D point and quadrotor planners."""
