"""Smolyak sparse-grid Gauss-Hermite rules (nwspgr 'GQN' equivalent).

A copy of ``gaussianvi_tpu/quadrature/smolyak.py`` (the same rules bit for
bit); the committed table the JAX package wrote is what
:func:`.table.verify_table` holds this generator to.

Re-implements the sparse-grid combination algorithm of Heiss & Winschel's
``nwspgr`` (reference quadrature/GH/SparseGH/nwspgr.m:66-134, which the
upstream library only ships as a MATLAB-Compiler binary ``libSpGH.so``) in
pure NumPy:

    rule(dim, k) = sum_{q=max(0,k-dim)}^{k-1} (-1)^{k-1-q} C(dim-1, dim+q-k)
                   * sum_{|i| = dim+q, i_j >= 1}  prod_j rule1d(i_j)

using the *non-negative half* of each symmetric 1-D rule, deduplicating equal
nodes by exact comparison after lexicographic sort, then mirroring to the
other orthants and normalizing weights to sum 1.  The resulting rule is exact
for polynomials of total order <= 2k-1 and has far fewer nodes than the full
tensor grid; weights may be negative.

Validated against the ground-truth (dim=5, k=2) table in reference
tests/test_spgh_table_IO.cpp:64-78.
"""

from __future__ import annotations

import functools
from math import comb

import numpy as np

from .gauss_hermite import gh_1d_half


def _sequences(dim: int, total: int) -> np.ndarray:
    """All vectors in N^dim with entries >= 1 summing to ``total``.

    Row order matches nwspgr.m's SpGrGetSeq (reverse-lexicographic in the
    excess a = total - dim distributed left to right); order is irrelevant to
    the final rule because of the dedup/sort step, but we keep it simple.
    """
    if dim == 1:
        return np.array([[total]], dtype=np.int64)
    rows = []
    for first in range(total - dim + 1, 0, -1):
        rest = _sequences(dim - 1, total - first)
        block = np.concatenate(
            [np.full((rest.shape[0], 1), first, dtype=np.int64), rest], axis=1
        )
        rows.append(block)
    return np.concatenate(rows, axis=0)


def _kron_product(levels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Tensor product of the half 1-D rules at the given levels."""
    nodes, weights = gh_1d_half(int(levels[0]))
    nodes = nodes[:, None]
    for lev in levels[1:]:
        n_new, w_new = gh_1d_half(int(lev))
        m, r = nodes.shape[0], n_new.shape[0]
        nodes = np.concatenate(
            [np.repeat(nodes, r, axis=0), np.tile(n_new[:, None], (m, 1))], axis=1
        )
        weights = np.kron(weights, w_new)
    return nodes, weights


def _sort_dedup(nodes: np.ndarray, weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lexicographically sort rows; merge exactly-equal rows, summing weights."""
    order = np.lexsort(nodes.T[::-1])
    nodes = nodes[order]
    weights = weights[order]
    if nodes.shape[0] <= 1:
        return nodes, weights
    new_row = np.any(nodes[1:] != nodes[:-1], axis=1)
    group = np.concatenate([[0], np.cumsum(new_row)])
    n_groups = group[-1] + 1
    first = np.concatenate([[True], new_row])
    merged_w = np.zeros(n_groups, dtype=weights.dtype)
    np.add.at(merged_w, group, weights)
    return nodes[first], merged_w


@functools.lru_cache(maxsize=None)
def sparse_gh(dim: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Sparse Gauss-Hermite rule for N(0, I_dim), accuracy level ``k``.

    Returns ``(nodes [M, dim], weights [M])``; exact for total polynomial
    order <= 2k-1.  Weights sum to 1 and may be negative.
    """
    if dim < 1 or k < 1:
        raise ValueError(f"need dim >= 1 and k >= 1, got ({dim}, {k})")
    nodes = np.zeros((0, dim))
    weights = np.zeros((0,))
    for q in range(max(0, k - dim), k):
        bq = (-1) ** (k - 1 - q) * comb(dim - 1, dim + q - k)
        for levels in _sequences(dim, dim + q):
            n_new, w_new = _kron_product(levels)
            nodes = np.concatenate([nodes, n_new], axis=0)
            weights = np.concatenate([weights, bq * w_new], axis=0)
        nodes, weights = _sort_dedup(nodes, weights)

    # Mirror the positive-orthant rule to all orthants, one axis at a time
    # (each half 1-D rule's smallest node is the center of symmetry, which for
    # GQN is always 0).
    for j in range(dim):
        flip = nodes[:, j] != 0.0
        if np.any(flip):
            mirrored = nodes[flip].copy()
            mirrored[:, j] = -mirrored[:, j]
            nodes = np.concatenate([nodes, mirrored], axis=0)
            weights = np.concatenate([weights, weights[flip]], axis=0)
    order = np.lexsort(nodes.T[::-1])
    nodes = nodes[order]
    weights = weights[order]
    weights = weights / weights.sum()
    return nodes, weights


# Maximum tabulated accuracy level per dimension, matching the reference
# table schedule (quadrature/saveSparseGHWeightMap.h:17-24).
MAX_DEGREE_SCHEDULE: dict[int, int] = {
    1: 25, 2: 25, 3: 19, 4: 13, 5: 11, 6: 9, 7: 8, 8: 7, 9: 7, 10: 7,
    11: 6, 12: 6, 13: 6, **{d: 5 for d in range(14, 21)},
}
