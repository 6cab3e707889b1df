"""Quadrature rules: lookup in the committed table, generation, table I/O.

Counterpart of ``gaussianvi_tpu/quadrature/table.py``.  Lookups read the
committed artifact the JAX package wrote, ``gaussianvi_tpu/quadrature/data/
sparse_gh_table.npz``, by file path with NumPy (importing the JAX package
would import JAX), and never write it.  Rules the table lacks, and full
tensor grids, are generated (:mod:`.smolyak`, :mod:`.gauss_hermite`).
:func:`save_table` writes under the port's git-ignored build directory
unless given a path; :func:`verify_table` holds the generator to the
committed table.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .gauss_hermite import gh_tensor_grid
from .smolyak import MAX_DEGREE_SCHEDULE, sparse_gh

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TABLE_PATH = os.path.join(_ROOT, "gaussianvi_tpu", "quadrature", "data",
                          "sparse_gh_table.npz")
BUILD_TABLE = os.path.join(_ROOT, "gaussianvi_tpu_torch", "_build",
                           "sparse_gh_table.npz")
# trees the port reads and never writes: the JAX package and its csrc/
_READ_ONLY = (os.path.join(_ROOT, "gaussianvi_tpu"), os.path.join(_ROOT, "csrc"))


@functools.cache
def _table():
    """The committed artifact, kept open (entries decompress per key on
    demand); None if the file is absent."""
    try:
        return np.load(TABLE_PATH)
    except OSError:
        return None


def _table_lookup(dim: int, degree: int):
    table = _table()
    key = f"nodes_{dim}_{degree}"
    if table is None or key not in table.files:
        return None
    return table[key], table[f"weights_{dim}_{degree}"]


def get_rule(dim: int, degree: int, kind: str = "sparse"):
    """``(nodes [M, dim], weights [M])`` for N(0, I_dim), float64 numpy.

    ``kind='sparse'`` gives the Smolyak rule (exact to total order
    2*degree-1), read from the committed table where it holds the rule and
    generated otherwise; ``kind='full'`` the degree**dim tensor grid."""
    if kind == "sparse":
        hit = _table_lookup(dim, degree)
        return hit if hit is not None else sparse_gh(dim, degree)
    if kind == "full":
        return gh_tensor_grid(degree, dim)
    raise ValueError(f"unknown quadrature kind {kind!r}")


def build_table(schedule: dict[int, int] | None = None) -> dict[str, np.ndarray]:
    """Generate the (dim, degree) table per the reference schedule."""
    schedule = schedule or MAX_DEGREE_SCHEDULE
    table: dict[str, np.ndarray] = {}
    for dim, max_deg in schedule.items():
        for deg in range(1, max_deg + 1):
            nodes, weights = sparse_gh(dim, deg)
            table[f"nodes_{dim}_{deg}"] = nodes
            table[f"weights_{dim}_{deg}"] = weights
    return table


def _check_writable(path: str) -> str:
    """``path`` made absolute; raises if it lies in a tree the port only
    reads (the JAX package, ``csrc/``)."""
    path = os.path.abspath(path)
    for tree in _READ_ONLY:
        if os.path.commonpath([path, tree]) == tree:
            raise ValueError(f"{path} lies in {tree}, which the port never "
                             "writes")
    return path


def save_table(path: str = BUILD_TABLE,
               schedule: dict[int, int] | None = None) -> str:
    """Build the table and write it as a compressed npz (default: the
    port's build directory, not the committed artifact)."""
    path = _check_writable(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **build_table(schedule))
    return path


def verify_table(
    path: str = TABLE_PATH,
    sample: list[tuple[int, int]] | None = None,
    atol: float = 1e-12,
) -> None:
    """Staleness check: regenerate a sample of entries and compare them
    with the saved table (default: the committed artifact); raises
    AssertionError on drift."""
    sample = sample or [(1, 10), (2, 6), (5, 2), (6, 3), (10, 3), (20, 2)]
    with np.load(path) as data:
        for dim, deg in sample:
            nodes, weights = sparse_gh(dim, deg)
            saved_n = data[f"nodes_{dim}_{deg}"]
            saved_w = data[f"weights_{dim}_{deg}"]
            if saved_n.shape != nodes.shape or not (
                np.allclose(saved_n, nodes, atol=atol)
                and np.allclose(saved_w, weights, atol=atol)
            ):
                raise AssertionError(
                    f"table entry (dim={dim}, deg={deg}) is stale — "
                    f"rebuild with save_table()"
                )


def load_table(path: str = TABLE_PATH) -> dict[tuple[int, int], tuple[np.ndarray, np.ndarray]]:
    """Load a saved table as a {(dim, degree): (nodes, weights)} dict."""
    with np.load(path) as data:
        out: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
        for key in data.files:
            if not key.startswith("nodes_"):
                continue
            _, dim, deg = key.split("_")
            out[(int(dim), int(deg))] = (
                data[key], data[f"weights_{dim}_{deg}"]
            )
    return out
