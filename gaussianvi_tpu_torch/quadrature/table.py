"""Sparse Gauss-Hermite rules from the committed table.

Counterpart of ``gaussianvi_tpu/quadrature/table.py:32-68``.  The port reads
the same committed artifact, ``gaussianvi_tpu/quadrature/data/
sparse_gh_table.npz``, by file path with NumPy (importing the JAX package
would import JAX).  Rules that are not in the table raise: generating
Smolyak rules is not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import functools
import os

import numpy as np

TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gaussianvi_tpu", "quadrature", "data", "sparse_gh_table.npz",
)


@functools.cache
def _table():
    return np.load(TABLE_PATH)


def get_rule(dim: int, degree: int, kind: str = "sparse"):
    """``(nodes [M, dim], weights [M])`` for N(0, I_dim), float64 numpy."""
    if kind != "sparse":
        raise NotImplementedError(
            f"quadrature kind {kind!r} is not ported (ROADMAP.md, Queue A)"
        )
    table = _table()
    key = f"nodes_{dim}_{degree}"
    if key not in table.files:
        raise NotImplementedError(
            f"no committed sparse-GH rule for dim={dim}, degree={degree}; "
            "generating rules is not ported (ROADMAP.md, Queue A)"
        )
    return table[key], table[f"weights_{dim}_{degree}"]
