"""Quadrature rules: Gauss-Hermite and Smolyak generators, the committed
table and its I/O, the native generator and the command-line tools
(counterpart of ``gaussianvi_tpu/quadrature``; NumPy, no JAX)."""

from .gauss_hermite import gh_1d, gh_1d_half, gh_tensor_grid
from .smolyak import MAX_DEGREE_SCHEDULE, sparse_gh
from .table import build_table, get_rule, load_table, save_table, verify_table

__all__ = [
    "gh_1d", "gh_1d_half", "gh_tensor_grid",
    "sparse_gh", "MAX_DEGREE_SCHEDULE",
    "get_rule", "build_table", "save_table", "load_table", "verify_table",
]
