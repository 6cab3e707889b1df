"""The algorithmic work of a call, from the problem's shapes alone, and
the least time the card could take for it.

Operations are the leading terms of one stated algorithm for each block
size s, whatever kernels implement it (a Cholesky s^3/3, a pair of
triangular solves against s columns 2 s^3, a product 2 s^3):

* a covariance sweep, per state: the forward and the backward message (a
  Cholesky, a solve pair and a product each) and the edge's blocks by
  Schur complements (two Choleskys, three solve pairs, three products):
  ``chain_flops``;
* a block-Thomas solve, per state: ``solve_flops``;
* the quadrature of one factor on an m-node rule over the leading dx of
  d coordinates, E[psi] only or with the moments: ``quad_flops``, with
  the cost's operations per node.

A configuration's family states the shapes (``families/<family>.py``
``shapes``): N, s, m, dx, the cost's operations, the parameter values
each problem holds (``own``) and those all share (``shared``), and the
factors a problem has.

The line search's trial costs, per trial and problem: a sweep, E[psi] at
every state and the trial iterate with the linear costs (16 s^2 a
state).  The NGD gradient step, per problem: a sweep, the moments at
every state, their assembly (12 s^3 a state) and two solves (the metric
and the fallback).

Bytes: every input read once and every output written once: the
iterate (mean, precision blocks) and, for the trials, the step and the
step lengths; the factors' parameters (each problem's own, the shared
ones and the field once); the trial log dets and costs, or the
gradient's covariance blocks, log det, precision step, mean step and
fallback.
"""

from __future__ import annotations

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): float32
# outside the tensor cores, and HBM3
PEAKS = {"H100": {"flops": 67e12, "bytes_per_s": 3.35e12}}


def peak(device_name: str):
    """The peaks of the card ``device_name``, or None for another."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def chain_flops(s):
    return 2 * (s**3 / 3 + 4 * s**3) + (2 / 3 + 12) * s**3


def solve_flops(s):
    return s**3 / 3 + 4 * s**3 + 6 * s**2


def quad_flops(d, m, dx, moments, cost):
    if not moments:
        return dx**3 / 3 + m * (dx * (dx + 1) + cost + 4)
    place = 2 * sum(min(i + 1, dx) for i in range(d))
    return d**3 / 3 + m * (place + cost + 2 + 2 * d + d * (d + 1))


def trials(z: dict, gvi: dict, problems: int, elt: int):
    """``(operations, bytes)`` of one iteration's trial costs for the
    shapes ``z`` (a family's ``shapes``) and the loop ``gvi``."""
    n, s, t = z["n"], z["s"], gvi["niters_backtrack"] + 1
    ops = t * problems * n * (chain_flops(s)
                              + quad_flops(s, z["m"], z["dx"], False,
                                           z["cost"]) + 16 * s * s)
    iterate = n * s + n * s * s + (n - 1) * s * s
    values = (problems * (2 * iterate + z["own"]) + z["shared"] + t
              + t * problems * (1 + z["factors"]))
    return ops, values * elt


def gradient(z: dict, problems: int, elt: int):
    """``(operations, bytes)`` of one iteration's gradient step."""
    n, s = z["n"], z["s"]
    ops = problems * n * (chain_flops(s)
                          + quad_flops(s, z["m"], z["dx"], True, z["cost"])
                          + 12 * s**3 + 2 * solve_flops(s))
    blocks = n * s * s + (n - 1) * s * s
    values = (problems * (n * s + blocks + 1 + z["own"]) + z["shared"]
              + problems * (2 * blocks + 1 + 3 * n * s))
    return ops, values * elt


def least_seconds(ops: float, nbytes: float, device_name: str):
    """``(seconds, "operations" | "bytes")``: the larger of the two
    bounds on the card, or None for a card without peaks here."""
    pk = peak(device_name)
    if pk is None:
        return None
    t_ops, t_bytes = ops / pk["flops"], nbytes / pk["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
