"""Gauss-Hermite quadrature rules for Gaussian-weighted integrals.

A copy of ``gaussianvi_tpu/quadrature/gauss_hermite.py`` (NumPy float64,
the same arrays bit for bit): the port imports nothing of the JAX package.

Probabilists' convention throughout: a degree-``p`` 1-D rule ``(x_i, w_i)``
satisfies ``sum_i w_i f(x_i) ~= E_{x~N(0,1)}[f(x)]`` and is exact for
polynomials up to order ``2p-1``.

Reference parity: the upstream library computes 1-D nodes as eigenvalues of a
Jacobi companion matrix and weights via the Hermite recurrence
(quadrature/GaussHermite-impl.h:44-84 in hzyu17/GaussianVI).  Here we use the
Golub-Welsch rule from ``numpy.polynomial.hermite_e`` which yields identical
nodes/weights to machine precision, then normalize the weights so they sum
to one (the sqrt(2*pi) Gaussian normalizer).
"""

from __future__ import annotations

import functools

import numpy as np
from numpy.polynomial import hermite_e


@functools.lru_cache(maxsize=None)
def gh_1d(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Degree-``degree`` 1-D probabilists' Gauss-Hermite rule.

    Returns ``(nodes, weights)``, nodes ascending, ``sum(weights) == 1``.
    """
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    nodes, weights = hermite_e.hermegauss(degree)
    weights = weights / weights.sum()
    return nodes, weights


@functools.lru_cache(maxsize=None)
def gh_1d_half(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Non-negative half of the symmetric 1-D rule.

    Each entry carries the *full-rule* weight of its |node|; mirroring the
    negative orthant back in (as the Smolyak builder does) reproduces the full
    rule.  Matches the builtin ``GQN`` table of nwspgr (Heiss & Winschel),
    reference quadrature/GH/SparseGH/nwspgr.m (GQN switch).
    """
    nodes, weights = gh_1d(degree)
    half = degree // 2
    return nodes[half:], weights[half:]


def gh_tensor_grid(degree: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Full tensor-product GH grid: ``degree**dim`` nodes in ``dim`` dims.

    Returns ``(nodes [M, dim], weights [M])`` for the standard normal
    ``N(0, I_dim)``.  Mirrors the permutation enumeration of reference
    quadrature/GaussHermite-impl.h:22-41 (but vectorized).
    """
    x, w = gh_1d(degree)
    grids = np.meshgrid(*([x] * dim), indexing="ij")
    nodes = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wgrids = np.meshgrid(*([w] * dim), indexing="ij")
    weights = np.ones(degree**dim)
    for g in wgrids:
        weights = weights * g.reshape(-1)
    return nodes, weights
