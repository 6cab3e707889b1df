"""Checkpoints, run records and timing (``gaussianvi_tpu/utils``; the
orbax checkpoint pair is not carried over)."""

from .checkpoint import load_checkpoint, load_loop_state, save_checkpoint
from .profiling import Timer, span, time_fn, trace
from .recorder import (
    cost_map_1d,
    history_to_arrays,
    save_costmap,
    save_factor_expectations,
    save_history_csv,
)

__all__ = [
    "save_checkpoint", "load_checkpoint", "load_loop_state",
    "Timer", "time_fn", "trace", "span",
    "history_to_arrays", "save_history_csv", "cost_map_1d", "save_costmap",
    "save_factor_expectations",
]
