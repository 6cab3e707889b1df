"""GPU smoke run of the PyTorch port (``gaussianvi_tpu_torch``) on one card.

Builds the CUDA kernels from ``gaussianvi_tpu_torch/csrc``, holds each of
the nine kernel entry points against its plain PyTorch version at the
flagship's shapes (float64 and float32, plus the pivot-trust, nonneg-band
and negative-linear-cost guard cases; the block-form moments kernel K4 also
against the quadrature kernel K3; the split fused gradient pair also
against the single fused gradient kernel; the fused kernels and the chain
kernels K1 and K2 also at chain lengths around a warp's width, s = 2,
ragged warps and blocks, leading shapes, dynamic starts and a chain long
enough for the global-scratch route; the quadrature kernels K3 and K4 also
at factor counts that leave a warp ragged, leading shapes, broadcast
params, rules of 7 to 137 nodes at d = 2 and 4 and strided views; every
kernel launched twice for identical bits; K2 also timed beside
``torch.linalg.solve_ex`` on its densified systems), then drives the
flagship
(``examples.chain_estimation`` -> ``optimize``) at N=32 states, dim_x=2,
the 29-node degree-4 marginal rule, 10 iterations, along five paths:

* the default configuration, which on the card runs the fused kernels
  (trials K5, gradient K6), at B=1024 problems;
* the separate-kernel path (K1-K3) at B=256;
* the block-form moments path (``use_pallas=True``, fused gradient off:
  K4 once per iteration, K2 solves, K5 trials) at B=1024;
* the proximal optimizer (``method="prox"``: K3 moments, K5 trials, K1)
  at B=1024;
* the factor-parallel path (``parallel.optimize_sharded``, dp=1, fp=2: two
  rank processes on this one card joined by gloo, each running K6 "accum"
  on its half of the range factors, one all-reduce, K6 "solve", and K5 on
  its shard) at B=1024, plus a small dp=2 x fp=2 mesh of four ranks.

Then the planar planner (its kernels at its shapes, its fused, separate
and plain paths), and the s = 6 models: every kernel at the shapes of
chain estimation at dim_x=3 and of the 3-D point planner (K1, K2, K3 both
variants, K4, K5, K6 "full"), the point planner fused and separate at
B=1024 restarts (plain at 64), the planar quadrotor on K1 / K2 at B=1024
(plain at 64), chain estimation at dim_x=3 fused and block-form at
B=1024, each counted and held to the plain path.  Then K1 and K2 at
s = 14 (a warp per chain or pair, ``csrc/chain_wide.cu``) and s = 1 at the
7-DOF arm planner's and Barfoot's shapes and at the arm's real iterate
(the layouts and guard cases ride in ``CHAIN_LAYOUTS`` and
``guard_cases``), the arm planner at B=1024 restarts on K1 / K2 and its
K3 instance (float32 and float64, the kernel path against the plain path
over all 15
iterations), and the Barfoot 1-D example in float64 on K1 / K2 at s = 1
against the reference's golden trajectories.  Then the loop's further
options: K3 (both variants), K5 and K6 (``full``, ``accum``, ``solve``)
with the sigma offsets rounded through bfloat16, at the flagship's and
the 3-D point planner's shapes, against their plain versions (float64 and
float32, twice for the same bits, timed beside the unquantized instances);
the flagship with ``moments_eval_dtype`` (bfloat16 on the fused and the
separate kernels, float16 on the plain quadrature), counted and held to
the plain path; resume from a checkpoint on the fused path against the
uninterrupted run; ``linesearch="seq"`` on the separate kernels and
``ema_alpha=0.5`` on the fused ones, each held to the plain path; and LTV
estimation (``examples.ltv_estimation``) at B=1024 restarts on K1 / K2.
Then K6 ``accum`` and ``solve`` at s = 6 at both s = 6 models'
shapes (beside K6 ``full`` in the s = 6 checks, the pair also against
``full``); in the factor-parallel phase the 3-D point planner at dp=1 x
fp=2 (B=1024 float32, counted: accum, solve and K5 30 each a rank; 8
restarts in float64 against the single-process fused path) and the
flagship at fp=2 with each of ``moments_eval_dtype="bfloat16"``,
``linesearch="seq"`` and ``ema_alpha=0.5`` against the single-process run
with the same option; the sequence-parallel path
(``parallel.optimize_time_sharded``, chain estimation at N=4096 on two
ranks of this card: float64 against the single-process run, with K3
against the plain quadrature, float32), each run's collectives against
``parallel.comm_model``; and the log-depth chain (``chain_impl="assoc"``)
against K1 / K2 at the flagship's shape and on one chain of 4096 states,
and its loop against the default path.  Then the planners' patch mode
(``patch_size``: 16 for the planar planner, 8 for the point planner):
K3 (both variants) and K6 (``full``, and ``accum`` on each half of the
factors) with the window functors against their plain versions at the
planners' shapes, with sigma points outside their windows, on a window's
upper edge and windows flush with both ends of the field; both planners
at B=1024 restarts under the defaults, counted (K5 never runs: the
windows follow the trials' means), float32 against float64, 8 restarts
in float64 against the same routes' plain versions on the CPU, their
rates and busy shares beside the default path; and, in the
factor-parallel phase, the point planner's patch mode at fp=2 against
one process.  Then the samplers at the
flagship's width (N = 32, s = 4, D = 128; no CUDA kernel of their own):
GVI and ``validate_posterior`` on a linear-Gaussian chain, ``run_chains``
(512 chains) and ``nuts_chains`` (128) held to its exact posterior,
``nuts_chains`` and ``smc_adaptive`` (1024 particles) on the flagship,
their rates and the device's busy share, and the card against the CPU on
the same draws (float64).

Each path's launch counters are zeroed just before it and read just after.
Checks the results: NGD costs finite, non-increasing and positive, prox
costs finite, float32 close to float64 (see ``main``), and the kernel
paths equal to the plain paths on a small batch; the ranks of the
factor-parallel path end bit-identical and agree with the single-process
fused path.  Prints the timings with
the card's name and power limit (both ``sqrtm_product`` methods included),
one JSON line of per-kernel results with each kernel's roofline bound,
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import statistics
from collections import Counter
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, N, DIM_X, DEGREE, NITERS = 1024, 32, 2, 4, 10
B_SEPARATE = 256                # the separate-kernel path's batch
TRIALS = 11                     # niters_backtrack + 1 line-search trials
SEED = 0
# one H100 SXM, published peaks: device memory rate and float32 rate
# outside the tensor cores (the kernels' arithmetic is plain float32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


_CLOCK = [time.perf_counter()]


def took(phase):
    """Print the seconds since the previous phase ended (where the
    script's time goes, against its 1200-second limit)."""
    now = time.perf_counter()
    print(f"[time] {phase} {now - _CLOCK[0]:.1f} s", flush=True)
    _CLOCK[0] = now


_HOLD = {}


def hold_device():
    """Keep the card busy for some milliseconds (one large float32 matrix
    product) so that the host can queue the calls to be timed behind it:
    the events then bracket device work that runs back to back, not the
    host's pace of launching it.  The redesigned kernels take less time
    than their wrappers take to launch them."""
    if "a" not in _HOLD:
        _HOLD["a"] = torch.ones(6144, 6144, device="cuda")
        _HOLD["out"] = torch.empty_like(_HOLD["a"])
    torch.mm(_HOLD["a"], _HOLD["a"], out=_HOLD["out"])


def cuda_ms(fn, reps=10):
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up, CUDA events around the whole run, queued behind
    :func:`hold_device`.  The operands stay warm in L2."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    hold_device()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


_FLUSH = {}


def cuda_ms_flushed(fn, reps=10):
    """Mean device milliseconds per call with the L2 cache flushed before
    every call (a 256 MB buffer, five times the 50 MB L2, is overwritten):
    what a caller pays whose operands are not already in L2.  Each call is
    timed by its own pair of events, queued behind :func:`hold_device`; the
    flush is outside them."""
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(256 << 20, dtype=torch.uint8,
                                    device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        hold_device()
        _FLUSH["buf"].zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaNs in the same places."""
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(), b.nan_to_num()))


def check_repeatable(name, fn):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed summation order); returns the first result."""
    first, second = fn(), fn()
    flat = lambda out: [t for x in out for t in (  # noqa: E731
        x if isinstance(x, (tuple, list)) else (x,))]
    check(all(same_bits(a, b) for a, b in zip(flat(first), flat(second))),
          f"{name}: two launches on the same inputs differ")
    return first


def tensor_bytes(obj) -> int:
    """Bytes of every floating-point tensor in a (nested) tuple."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size() if obj.is_floating_point() else 0
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def bound(inputs, outputs, flops):
    """The least time the card could take for a call: its inputs read once
    and its outputs written once at the memory rate, or ``flops`` at the
    float32 rate, whichever is larger: ``(ms, "bytes" | "operations")``."""
    t_bytes = (tensor_bytes(inputs) + tensor_bytes(outputs)) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# Operation counts, leading terms, per unit of work (s = block size, d =
# factor dim, m = rule nodes, dx = the rule's marginal dim, the position
# the cost reads): a Cholesky is s^3/3, a pair of triangular solves
# against s columns 2 s^3, a product 2 s^3.
def chain_flops(s):
    """Per state of a covariance sweep: forward and backward message (a
    Cholesky, a solve pair, a product each) and the edge's blocks as
    fused.cuh edge_covariance_r takes them: the 2s x 2s joint's inverse
    up to s = 4, above it s x s Schur complements (two Choleskys, three
    solve pairs against s columns, three products)."""
    edge = ((2 * s) ** 3 / 3 + 2 * (2 * s) ** 3 if s <= 4
            else (2 / 3 + 12) * s**3)
    return 2 * (s**3 / 3 + 4 * s**3) + edge


def solve_flops(s):
    """Per state of a block-Thomas solve: a Cholesky, a solve pair, a
    product and the vector updates."""
    return s**3 / 3 + 4 * s**3 + 6 * s**2


def quad_flops(d, m, dx, moments, cost=None):
    """Per factor of a marginal rule over the leading ``dx`` of ``d``
    dims: the Cholesky, then per node the placement, the cost (``cost``
    operations; the range cost's ~3 dx + 8 by default) and the weighted
    sums.  E[phi] needs the leading dx x dx factor and dx rows of the
    placement; the moments need every row of the offset (from the dx
    nonzero node coordinates) and the whole factor, whose trailing
    columns the marginal-rule lift reads."""
    cost = 3 * dx + 8 if cost is None else cost
    if not moments:
        return dx**3 / 3 + m * (dx * (dx + 1) + cost + 4)
    place = 2 * sum(min(i + 1, dx) for i in range(d))
    return d**3 / 3 + m * (place + cost + 2 + 2 * d + d * (d + 1))


def compare(name, got, want, rtol, atol):
    """Max abs error over finite entries; NaN patterns must be identical."""
    got, want = got.double(), want.double()
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{name}: NaN pattern differs")
    fin = torch.isfinite(want)
    check(bool(torch.isfinite(got[fin]).all()), f"{name}: non-finite output")
    err = (got[fin] - want[fin]).abs()
    bound = atol + rtol * want[fin].abs()
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= bound).all()),
          f"{name}: max abs err {worst:.3e} over tolerance "
          f"(rtol {rtol}, atol {atol})")
    return worst


def spd_chains(nb, n, s, rng, dtype, dev):
    """nb SPD block-tridiagonal precisions A = J J^T and right-hand sides.
    J is block lower bidiagonal with diagonal blocks L_i (unit-to-two
    diagonal) and small sub-diagonal blocks C_i, so ||L^-1 C|| < 1 and the
    covariance stays O(1) along the chain."""
    lo = (np.eye(s) * rng.uniform(1.0, 2.0, (nb, n, 1, s))
          + 0.2 * np.tril(rng.standard_normal((nb, n, s, s)), -1))
    c = 0.1 * rng.standard_normal((nb, max(n - 1, 0), s, s))
    diag = lo @ np.swapaxes(lo, -1, -2)
    diag[:, 1:] += c @ np.swapaxes(c, -1, -2)
    off = lo[:, :-1] @ np.swapaxes(c, -1, -2)
    rhs = rng.standard_normal((nb, n, s))
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return t(diag), t(off), t(rhs)


def kernel_checks(graph_b, state_b, dev):
    """Every kernel against its plain version at the slice's shapes."""
    from gaussianvi_tpu_torch.kernels import chain, quad

    rng = np.random.default_rng(SEED)
    results = {}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        fb = graph_b[dtype].nonlinear[0]
        tol_chain = (1e-10, 1e-10) if f64 else (1e-4, 1e-6)
        tol_ld = (0.0, 1e-10) if f64 else (1e-5, 0.0)
        tol_quad = (0.0, 1e-10) if f64 else (1e-4, 1e-6)
        # K1 on the trial batch: 11 x 1024 chains
        diag, off, _ = spd_chains(TRIALS * B, N, 4, rng, dtype, dev)
        diag = diag.reshape(TRIALS, B, N, 4, 4)
        off = off.reshape(TRIALS, B, N - 1, 4, 4)
        k1 = chain.gbp_covariance_logdet_lanes(diag, off)
        p1 = chain.gbp_covariance_logdet_plain(diag, off)
        err1 = max(compare(f"K1 cov_diag {dtype}", k1[0], p1[0], *tol_chain),
                   compare(f"K1 cov_off {dtype}", k1[1], p1[1], *tol_chain),
                   compare(f"K1 logdet {dtype}", k1[2], p1[2], *tol_ld))
        # K2 on the solve pair: B main systems and B fallbacks against one
        # right-hand side, as the NGD step hands them over
        d2, o2, rhs = spd_chains(2 * B, N, 4, rng, dtype, dev)
        pair = (d2[:B], o2[:B], d2[B:], o2[B:], rhs[:B])
        k2 = chain.solve_pair_lanes(*pair)
        err2 = max(compare(f"K2 x{i} {dtype}", a, b_, *tol_chain)
                   for i, (a, b_) in enumerate(
                       zip(k2, chain.solve_pair_plain(*pair))))
        # K3 on real marginal means and params, covariances from K1
        mu = state_b[dtype].mu + 0.05 * torch.tensor(
            rng.standard_normal((TRIALS, B, N, 4)), dtype=dtype, device=dev)
        cov = k1[0]
        args3 = (mu, cov, fb.nodes, fb.weights, "range", fb.kernel_params)
        err3 = compare(f"K3 phi {dtype}", check_repeatable(
            f"K3 phi {dtype}", lambda: (quad.quad_lanes_phi(*args3,
                                                            nonneg=True),))[0],
            quad.quad_phi_plain(*args3, nonneg=True), *tol_quad)
        args4 = (mu[0], cov[0], fb.nodes, fb.weights, "range",
                 fb.kernel_params)
        km = check_repeatable(f"K3 moments {dtype}", lambda:
                              quad.quad_lanes_moments(*args4,
                                                      rdim=fb.quad_rdim))
        pm = quad.quad_moments_plain(*args4, rdim=fb.quad_rdim)
        # float32 moments: absolute floor scaled to each output's range
        # (E[(x-mu) phi] entries pass through zero)
        err4 = max(compare(f"K3 moments[{i}] {dtype}", a, b_, tol_quad[0],
                           tol_quad[1] if f64 else 1e-6 * float(b_.abs().max()))
                   for i, (a, b_) in enumerate(zip(km, pm)))
        guard_cases(dtype, dev)
        print(f"[kernels {str(dtype)[6:]}] max abs err vs plain: "
              f"K1 {err1:.3e}  K2 {err2:.3e}  K3 phi {err3:.3e}  "
              f"K3 moments {err4:.3e}", flush=True)
        if f64:
            continue
        times = {
            "gbp_covariance_logdet": (
                cuda_ms(lambda: chain.gbp_covariance_logdet_lanes(diag, off)),
                cuda_ms(lambda: chain.gbp_covariance_logdet_plain(diag, off),
                        reps=1)),
            "solve": (cuda_ms(lambda: chain.solve_pair_lanes(*pair)),
                      cuda_ms(lambda: chain.solve_pair_plain(*pair), reps=1)),
            "quad_phi": (
                cuda_ms(lambda: quad.quad_lanes_phi(*args3, nonneg=True)),
                cuda_ms(lambda: quad.quad_phi_plain(*args3, nonneg=True))),
            "quad_moments": (
                cuda_ms(lambda: quad.quad_lanes_moments(*args4, rdim=2)),
                cuda_ms(lambda: quad.quad_moments_plain(*args4, rdim=2))),
        }
        errs = {"gbp_covariance_logdet": err1, "solve": err2,
                "quad_phi": err3, "quad_moments": err4}
        m = fb.nodes.shape[0]
        bounds = {
            "gbp_covariance_logdet": bound(
                (diag, off), k1, TRIALS * B * N * chain_flops(4)),
            "solve": bound(pair, k2, 2 * B * N * solve_flops(4)),
            "quad_phi": bound(args3[:4] + args3[5:], mu[..., 0],
                              TRIALS * B * N * quad_flops(4, m, DIM_X, False)),
            "quad_moments": bound(args4[:4] + args4[5:], km,
                                  B * N * quad_flops(4, m, DIM_X, True)),
        }
        for name, (ms, plain_ms) in times.items():
            results[name] = dict(max_abs_err=errs[name],
                                 err_dtype="float32", ms=ms,
                                 plain_ms=plain_ms, **bounds[name])
        results["gbp_covariance_logdet"]["ms_flushed_l2"] = cuda_ms_flushed(
            lambda: chain.gbp_covariance_logdet_lanes(diag, off))
        results["solve"]["ms_flushed_l2"] = cuda_ms_flushed(
            lambda: chain.solve_pair_lanes(*pair))
        results["quad_phi"]["ms_flushed_l2"] = cuda_ms_flushed(
            lambda: quad.quad_lanes_phi(*args3, nonneg=True))
        results["quad_moments"]["ms_flushed_l2"] = cuda_ms_flushed(
            lambda: quad.quad_lanes_moments(*args4, rdim=2))
        results["solve"]["library_ms"] = dense_solve_ms(pair)
    return results


def dense_solve_ms(pair):
    """K2's yardstick: ``torch.linalg.solve_ex`` on the pair's systems as
    one batch of dense SPD matrices [2B, N s, N s] (built outside the timed
    call) against the right-hand side, one PyTorch call; its result is held
    to K2's plain version first, outside the timing.  ``solve_ex`` with
    ``check_errors=False``, not ``solve``: ``solve`` reads its error info
    back to the host after every call, so the host would wait for the card
    between calls and the time would count those round trips."""
    from gaussianvi_tpu_torch.kernels import chain

    d0, o0, d1, o1, rhs = pair
    nb, n, s = rhs.shape
    dense = torch.zeros(2 * nb, n * s, n * s, dtype=rhs.dtype,
                        device=rhs.device)
    for i, (d, o) in enumerate(((d0, o0), (d1, o1))):
        rows = dense[i * nb:(i + 1) * nb]
        for k in range(n):
            rows[:, k * s:(k + 1) * s, k * s:(k + 1) * s] = d[:, k]
            if k < n - 1:
                rows[:, k * s:(k + 1) * s, (k + 1) * s:(k + 2) * s] = o[:, k]
                rows[:, (k + 1) * s:(k + 2) * s, k * s:(k + 1) * s] = (
                    o[:, k].transpose(-1, -2))
    b = rhs.reshape(nb, n * s).repeat(2, 1)

    def library():
        return torch.linalg.solve_ex(dense, b, check_errors=False)[0]

    x = library().reshape(2, nb, n, s)
    want = chain.solve_pair_plain(*pair)
    for got, w in zip(x, want):
        err = float((got - w).abs().max())
        check(err <= 1e-3 * max(1.0, float(w.abs().max())),
              f"dense solve off K2's plain version by {err:.3e}")
    return cuda_ms(library)


def guard_cases(dtype, dev):
    """Pivot-trust and nonneg-band poisoning agree between kernel and plain
    (the chain cases at s = 2, 1 and 14, with an indefinite pivot too)."""
    from gaussianvi_tpu_torch.kernels import chain, quad

    eps = torch.finfo(dtype).eps
    for s in (2, 1, 14):
        eye = torch.eye(s, dtype=dtype, device=dev)
        # chain 0: Schur pivot D1 - B^T D0^-1 B cancels to ~1 ulp; chain 1
        # healthy
        diag = torch.stack([torch.stack([eye, (1 + 2 * eps) * eye]),
                            torch.stack([eye, 2 * eye])])
        off = torch.stack([eye[None], eye[None]])
        ld_k = chain.gbp_covariance_logdet_lanes(diag, off)[2]
        ld_p = chain.gbp_covariance_logdet_plain(diag, off)[2]
        check(bool(torch.isnan(ld_k[0])) and bool(torch.isnan(ld_p[0])),
              f"pivot-trust case not poisoned ({dtype}, s={s})")
        check(bool(torch.isfinite(ld_k[1])),
              f"healthy chain poisoned ({dtype}, s={s})")
        # a pivot that is not positive definite: NaN everywhere, as plain
        diag, off = torch.stack([eye, 0.5 * eye])[None], eye[None, None]
        for i, (a, b_) in enumerate(zip(
                chain.gbp_covariance_logdet_lanes(diag, off),
                chain.gbp_covariance_logdet_plain(diag, off))):
            check(bool(torch.isnan(a).all()) and bool(torch.isnan(b_).all()),
                  f"indefinite pivot, output {i}: not NaN ({dtype}, s={s})")
    # every sigma point at the mean: phi constant, the weights alone decide.
    # The weighted sum lands inside the nonneg band but above the 64-ulp
    # cancellation threshold: NaN only under the nonneg contract.
    delta = 1e-4 if dtype == torch.float32 else 1e-13
    nodes = torch.zeros(4, 4, dtype=dtype, device=dev)
    weights = torch.tensor([1.0, -1.0 - delta, 0.0, 0.0], dtype=dtype,
                           device=dev)
    mu = torch.zeros(1, 1, 4, dtype=dtype, device=dev)
    cov = torch.eye(4, dtype=dtype, device=dev).expand(1, 1, 4, 4)
    params = torch.tensor([[[-1.0, -1.0, 1.0, 0.01]]], dtype=dtype, device=dev)
    for nonneg in (True, False):
        args = (mu, cov, nodes, weights, "range", params)
        k = quad.quad_lanes_phi(*args, nonneg=nonneg)
        p = quad.quad_phi_plain(*args, nonneg=nonneg)
        check(bool(torch.isnan(k).all()) == nonneg
              and bool(torch.isnan(p).all()) == nonneg,
              f"nonneg band case wrong (nonneg={nonneg}, {dtype})")


def build_batch(dtype, dev, num_problems=None, dim_x=DIM_X):
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    graphs, states = [], []
    for seed in range(num_problems or B):
        g, s, _ = build_chain_estimation(num_states=N, dim_x=dim_x,
                                         gh_degree=DEGREE, seed=seed,
                                         dtype=dtype, device=dev)
        graphs.append(g)
        states.append(s)
    return stack_problems(graphs, states)


def compare_conditioned(name, k64, p64, p32, reps=4.0):
    """A float64 kernel output against its float64 plain version where the
    output is ill-conditioned.  NaN patterns must be identical.  The bound
    is 1e-10 plus ``reps`` times the float32 plain version's max error
    against float64 scaled down to float64's epsilon: the float32 run
    measures how far rounding moves this output.  Returns the max abs
    error."""
    check(torch.equal(torch.isnan(k64), torch.isnan(p64)),
          f"{name}: NaN pattern differs")
    fin = torch.isfinite(p64)
    check(bool(torch.isfinite(k64[fin]).all()), f"{name}: non-finite output")
    both = fin & torch.isfinite(p32)
    sens = float((p32.double() - p64)[both].abs().max()) if both.any() else 0.0
    atol = 1e-10 + reps * sens * (torch.finfo(torch.float64).eps
                                  / torch.finfo(torch.float32).eps)
    err = float((k64 - p64)[fin].abs().max()) if fin.any() else 0.0
    check(err <= atol, f"{name}: max abs err {err:.3e} over {atol:.3e}")
    return err


def compare_vs_f64(name, k32, p32, p64, reps=4.0):
    """A float32 kernel output held to the float64 plain version as well
    as the float32 plain version is: it takes no more guard (NaN)
    decisions that differ from float64's, and its max error against
    float64 is at most ``reps`` times the plain version's (plus 1e-6 of
    the output's range).  Returns its max abs difference from the float32
    plain version."""
    nan_r = torch.isnan(p64)
    mis_k = int((torch.isnan(k32) != nan_r).sum())
    mis_p = int((torch.isnan(p32) != nan_r).sum())
    check(mis_k <= mis_p, f"{name}: {mis_k} NaN decisions differ from "
          f"float64, the plain version's {mis_p}")
    fin = torch.isfinite(k32) & torch.isfinite(p32) & torch.isfinite(p64)
    if not fin.any():
        return 0.0
    k, p, r = k32.double()[fin], p32.double()[fin], p64[fin]
    err_k = float((k - r).abs().max())
    err_p = float((p - r).abs().max())
    atol = 1e-6 * float(r.abs().max())
    check(err_k <= reps * err_p + atol,
          f"{name}: error against float64 {err_k:.3e}, the plain "
          f"version's {err_p:.3e}")
    return float((k - p).abs().max())


def flagship_iterate(graph_b, state_b):
    """The float64 iterate five plain NGD iterations reach at B=1024:
    ``(mu, prec_diag, prec_off)``."""
    from gaussianvi_tpu_torch import GVIConfig, optimize

    state, _ = optimize(graph_b[torch.float64], state_b[torch.float64],
                        GVIConfig(niters=5, niters_lowtemp=5,
                                  step_size_base=0.9, chain_impl="seq",
                                  quad_impl="xla"))
    return state.mu, state.precision.diag, state.precision.off


def moments_checks(graph_b, iterate, dev):
    """K4 at the flagship's iterate (32,768 factors, d = 4) against its
    plain version and against K3 moments, the other hand-written kernel of
    the same function: float64 and float32, on the full rule (137 nodes)
    and on the marginal rule (29 nodes, lift on).  float64: 1e-10 of each
    output's range.  float32: at this iterate E[(x-mu) phi] cancels from
    terms ~1e3 times its size, so, as for K5/K6, the kernel is held to the
    float64 plain version as well as the float32 plain version (and K3) is
    (:func:`compare_vs_f64`); the fixed float32 tolerance holds in
    ``tests/test_torch_cuda.py`` on well-conditioned inputs.  Times K4,
    its plain version and K3 moments on the marginal rule, float32."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.kernels import fused_moments as fm
    from gaussianvi_tpu_torch.kernels import quad
    from gaussianvi_tpu_torch.kernels.chain import (
        gbp_covariance_logdet_lanes,
    )

    mu64, pd64, po64 = iterate
    cov64 = gbp_covariance_logdet_lanes(pd64, po64)[0]
    out, ref = {}, {}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        fb = graph_b[dtype].nonlinear[0]
        full = build_chain_estimation(
            num_states=N, dim_x=DIM_X, gh_degree=DEGREE, marginal_quad=False,
            dtype=dtype, device=dev)[0].nonlinear[0]
        mu, cov = mu64.to(dtype), cov64.to(dtype)
        flat = (mu.reshape(-1, 4), cov.reshape(-1, 4, 4),
                fb.kernel_params.reshape(-1, fb.kernel_params.shape[-1]))
        errs = []
        for rule, rdim in ((fb, fb.quad_rdim), (full, None)):
            args = (rule.nodes, rule.weights, mu, cov, "range",
                    fb.kernel_params)
            k4 = check_repeatable(f"K4 {dtype}", lambda: fm.fused_moments(
                *args, rdim=rdim))
            p4 = fm.fused_moments_plain(
                rule.nodes, rule.weights, flat[0], flat[1],
                quad.KERNEL_COSTS["range"][1], (flat[2],), rdim)
            k3 = quad.quad_lanes_moments(mu, cov, rule.nodes, rule.weights,
                                         "range", fb.kernel_params, rdim=rdim)
            m = rule.nodes.shape[0]
            p4 = tuple(b_.reshape(a.shape) for a, b_ in zip(k4, p4))
            if f64:
                ref[m] = p4
            for i, (a, b_, c) in enumerate(zip(k4, p4, k3)):
                names = (f"K4[{i}] vs plain, {m} nodes, {dtype}",
                         f"K4[{i}] vs K3 moments, {m} nodes, {dtype}")
                if f64:
                    tol = (0.0, 1e-10 * float(b_.abs().max()))
                    errs.append((compare(names[0], a, b_, *tol),
                                 compare(names[1], a, c, *tol)))
                else:
                    errs.append((compare_vs_f64(names[0], a, b_, ref[m][i]),
                                 compare_vs_f64(names[1], a, c, ref[m][i])))
        err_plain, err_k3 = (max(e[i] for e in errs) for i in (0, 1))
        print(f"[K4 {str(dtype)[6:]}] max abs err: vs plain {err_plain:.3e}, "
              f"vs K3 moments {err_k3:.3e} (both rules)", flush=True)
        if f64:
            continue
        args = (fb.nodes, fb.weights, mu, cov, "range", fb.kernel_params)
        k3_ms = cuda_ms(lambda: quad.quad_lanes_moments(
            mu, cov, fb.nodes, fb.weights, "range", fb.kernel_params, rdim=2))
        out["fused_moments"] = dict(
            max_abs_err=err_plain, err_dtype="float32",
            ms=cuda_ms(lambda: fm.fused_moments(*args, rdim=2)),
            ms_flushed_l2=cuda_ms_flushed(
                lambda: fm.fused_moments(*args, rdim=2)),
            plain_ms=cuda_ms(lambda: fm.fused_moments_plain(
                fb.nodes, fb.weights, *flat[:2],
                quad.KERNEL_COSTS["range"][1], (flat[2],), 2)),
            k3_moments_ms=k3_ms,
            **bound(args[:4] + args[5:], fm.fused_moments(*args, rdim=2),
                    B * N * quad_flops(4, fb.nodes.shape[0], DIM_X, True)))
    return out


def sqrtm_times(iterate, dev):
    """Milliseconds of ``sqrtm_product`` by each method at the shapes the
    proximal step gives it on the flagship, float32: the 32 x 1024 state
    marginals (4 x 4) and the 31 x 1024 edge marginals (8 x 8) of the
    iterate."""
    from gaussianvi_tpu_torch.inference.graph import gather_marginals
    from gaussianvi_tpu_torch.kernels.chain import (
        gbp_covariance_logdet_lanes,
    )
    from gaussianvi_tpu_torch.ops.psd import sqrtm_product

    mu64, pd64, po64 = iterate
    cd, co, _ = gbp_covariance_logdet_lanes(pd64, po64)
    start = torch.arange(N - 1, device=dev)
    edges = gather_marginals(start, 2, mu64, cd, co, 0)[1]
    times = {}
    for name, a in (("4x4", cd.float()), ("8x8", edges.float())):
        for method in ("eigh", "newton"):
            times[name, method] = cuda_ms(
                lambda: sqrtm_product(a, 0.1, method=method), reps=1)
        rel = ((sqrtm_product(a, 0.1, "newton")
                - sqrtm_product(a, 0.1, "eigh")).abs().amax((-2, -1))
               / sqrtm_product(a, 0.1, "eigh").abs().amax((-2, -1)))
        print(f"[sqrtm_product {name}] eigh {times[name, 'eigh']:.3f} ms, "
              f"newton {times[name, 'newton']:.3f} ms on "
              f"{a.shape[0] * a.shape[1]} blocks (f32); newton vs eigh max "
              f"relative difference {float(rel.max()):.3e}", flush=True)
    return times


def fused_checks(graph_b, state_b, dev, iterate):
    """K5 and K6 against their plain versions at the flagship's shapes,
    at the iterate five plain NGD iterations reach (Vddmu is still
    indefinite on some problems there, so the main solve is NaN on those)
    and in the direction the next iteration takes (dmu with its SPD
    fallback, dprec, from K6's float64 plain version; both dtypes get the
    same inputs).

    The flagship's posterior is ill-conditioned here: the float32 plain
    version is up to ~1% of an output's range off float64 for covariance
    and solves, and the largest trial steps reach nearly singular
    precisions whose E[phi] is off by more than its own size.  So float32
    is held to float64 (:func:`compare_vs_f64`) and float64 to a bound
    scaled by that measured sensitivity (:func:`compare_conditioned`);
    the fixed tolerances hold in ``tests/test_torch_cuda.py`` on
    well-conditioned inputs."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    f32, f64 = torch.float32, torch.float64
    ops = {dt: fused_operands(graph_b[dt]) for dt in (f32, f64)}
    x6, x5 = {}, {}
    for dt in (f64, f32):
        mu, pd, po = (x.to(dt) for x in iterate)
        x6[dt] = (mu, pd, po, torch.ones(B, dtype=dt, device=dev))
    p6 = {f64: fg.gradient_plain(*x6[f64], *ops[f64])}
    finite = torch.isfinite(p6[f64][5]).flatten(1).all(1)
    check(bool(finite.any()) and not bool(finite.all()),
          f"K6: no mix of indefinite and definite Vddmu "
          f"({int((~finite).sum())}/{B} indefinite)")
    direction = (torch.where(finite[:, None, None], p6[f64][5], p6[f64][6]),
                 p6[f64][3], p6[f64][4])
    for dt in (f64, f32):
        mu, pd, po, _ = x6[dt]
        dmu, dpd, dpo = (x.to(dt) for x in direction)
        trials = 0.9 * 0.75 ** torch.arange(1, TRIALS + 1, dtype=dt,
                                            device=dev)
        x5[dt] = (mu, dmu, pd, po, dpd, dpo, trials)
    p6[f32] = fg.gradient_plain(*x6[f32], *ops[f32])
    p5 = {dt: ft.trial_costs_plain(*x5[dt], *ops[dt]) for dt in (f32, f64)}
    k6 = {dt: check_repeatable(
        f"K6 full {dt}", lambda dt=dt: fg.gradient_lanes(*x6[dt], *ops[dt]))
        for dt in (f32, f64)}
    k5 = {dt: check_repeatable(
        f"K5 {dt}", lambda dt=dt: ft.trial_costs_lanes(*x5[dt], *ops[dt]))
        for dt in (f32, f64)}

    def flat5(out):
        return (out[0], *out[1])

    names6 = ("cov_diag", "cov_off", "logdet", "dprec_diag", "dprec_off",
              "dmu", "dmu_fallback")
    names5 = ("logdet",) + tuple(f"costs[{i}]" for i in range(
        len(p5[f64][1])))
    errs = {}
    for tag, names, k, p in (("K6", names6, k6, p6),
                             ("K5", names5, {dt: flat5(k5[dt]) for dt in k5},
                              {dt: flat5(p5[dt]) for dt in p5})):
        errs[tag, f64] = max(
            compare_conditioned(f"{tag} {nm} float64", a, b, c)
            for nm, a, b, c in zip(names, k[f64], p[f64], p[f32]))
        errs[tag, f32] = max(
            compare_vs_f64(f"{tag} {nm} float32", a, b, c)
            for nm, a, b, c in zip(names, k[f32], p[f32], p[f64]))
    for dt in (f64, f32):
        fused_guard_cases(dt, dev)
        print(f"[fused kernels {str(dt)[6:]}] max abs err vs plain: "
              f"K5 {errs['K5', dt]:.3e}  K6 {errs['K6', dt]:.3e}; "
              f"indefinite Vddmu on {int((~finite).sum())}/{B} problems, "
              f"{int(torch.isnan(p5[dt][0]).sum())}/{TRIALS * B} trial log "
              f"dets poisoned", flush=True)
    m = graph_b[f32].nonlinear[0].nodes.shape[0]
    arrays = ops[f32][2:]
    # K5: per (trial, problem) a covariance sweep, E[phi] per state and the
    # linear costs; K6: per problem a sweep, the moments, the assembly
    # (six products per state) and both solves
    flops5 = TRIALS * B * N * (chain_flops(4) + quad_flops(4, m, DIM_X, False)
                               + 16 * 4**2)
    flops6 = B * N * (chain_flops(4) + quad_flops(4, m, DIM_X, True)
                      + 12 * 4**3 + 2 * solve_flops(4))
    return {
        "fused_trials": dict(
            **bound((x5[f32], arrays), k5[f32], flops5),
            max_abs_err=errs["K5", f64], err_dtype="float64",
            ms=cuda_ms(lambda: ft.trial_costs_lanes(*x5[f32], *ops[f32])),
            ms_flushed_l2=cuda_ms_flushed(
                lambda: ft.trial_costs_lanes(*x5[f32], *ops[f32])),
            plain_ms=cuda_ms(lambda: ft.trial_costs_plain(*x5[f32],
                                                          *ops[f32]),
                             reps=1)),
        "fused_gradient": dict(
            **bound((x6[f32], arrays), k6[f32], flops6),
            max_abs_err=errs["K6", f64], err_dtype="float64",
            ms=cuda_ms(lambda: fg.gradient_lanes(*x6[f32], *ops[f32])),
            ms_flushed_l2=cuda_ms_flushed(
                lambda: fg.gradient_lanes(*x6[f32], *ops[f32])),
            plain_ms=cuda_ms(lambda: fg.gradient_plain(*x6[f32], *ops[f32]),
                             reps=1)),
    }


def half_operands(graph, i):
    """The nonlinear fused operands of rank ``i`` of a dp=1 x fp=2 mesh,
    as ``shard_graph`` hands them to the rank's engine (half of the range
    factors, dynamic starts)."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.parallel import shard_graph

    position = SimpleNamespace(dp=1, fp=2, dp_index=0, fp_index=i)
    nl_specs, _, nl_arrays, _ = fused_operands(shard_graph(graph, position))
    return nl_specs, nl_arrays


def split_checks(graph_b, dev, iterate):
    """K6 "accum" and "solve" against their plain versions at the
    flagship's iterate (as :func:`fused_checks` holds K6 "full": float64 by
    :func:`compare_conditioned`, float32 by :func:`compare_vs_f64`), and
    the pair (accum on each half of the 32 range factors, summed, then
    solve) against the single "full" kernel on the same inputs: equal up to
    the reassociation of one sum.  Times each mode at the shapes the
    factor-parallel path gives it (float32)."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg

    f32, f64 = torch.float32, torch.float64
    ops = {dt: fused_operands(graph_b[dt]) for dt in (f32, f64)}
    x, halves, lin = {}, {}, {}
    for dt in (f64, f32):
        mu, pd, po = (t.to(dt) for t in iterate)
        x[dt] = (mu, pd, po, torch.ones(B, dtype=dt, device=dev))
        halves[dt] = [half_operands(graph_b[dt], i) for i in (0, 1)]
        lin[dt] = (ops[dt][1], ops[dt][3])

    def accum_plain(dt, i):
        specs, arrays = halves[dt][i]
        return fg.gradient_plain(*x[dt], specs, (), arrays, (), mode="accum")

    def solve_plain(dt, seeds):
        return fg.gradient_plain(*x[dt], (), lin[dt][0], (), lin[dt][1],
                                 mode="solve", seeds=seeds)

    # accum on half 0 and half 1, kernel against plain
    pa = {dt: [accum_plain(dt, i) for i in (0, 1)] for dt in (f64, f32)}
    ka = {dt: [check_repeatable(
        f"K6 accum[{i}] {dt}",
        lambda dt=dt, i=i: fg.gradient_accum_lanes(*x[dt], *halves[dt][i]))
        for i in (0, 1)] for dt in (f64, f32)}
    names_a = ("vdmu", "vdd", "vdo")
    err_a = {
        f64: max(compare_conditioned(f"K6 accum[{i}] {nm} float64", a, b, c)
                 for i in (0, 1)
                 for nm, a, b, c in zip(names_a, ka[f64][i], pa[f64][i],
                                        pa[f32][i])),
        f32: max(compare_vs_f64(f"K6 accum[{i}] {nm} float32", a, b, c)
                 for i in (0, 1)
                 for nm, a, b, c in zip(names_a, ka[f32][i], pa[f32][i],
                                        pa[f64][i])),
    }
    # solve on the float64 plain sum of the halves (both dtypes get the
    # same seeds), kernel against plain
    seeds = {f64: tuple(a + b for a, b in zip(*pa[f64]))}
    seeds[f32] = tuple(t.to(f32) for t in seeds[f64])
    ps = {dt: solve_plain(dt, seeds[dt]) for dt in (f64, f32)}
    ks = {dt: check_repeatable(
        f"K6 solve {dt}",
        lambda dt=dt: fg.gradient_solve_lanes(*x[dt], seeds[dt], *lin[dt]))
        for dt in (f64, f32)}
    names_s = ("cov_diag", "cov_off", "logdet", "dprec_diag", "dprec_off",
               "dmu", "dmu_fallback")
    err_s = {
        f64: max(compare_conditioned(f"K6 solve {nm} float64", a, b, c)
                 for nm, a, b, c in zip(names_s, ks[f64], ps[f64], ps[f32])),
        f32: max(compare_vs_f64(f"K6 solve {nm} float32", a, b, c)
                 for nm, a, b, c in zip(names_s, ks[f32], ps[f32], ps[f64])),
    }
    # the pair on the kernels against the single kernel
    pair, full, off_bits = {}, {}, {}
    for dt in (f64, f32):
        total = fg.gradient_accum_lanes(*x[dt], *halves[dt][0])
        total.buffer.add_(ka[dt][1].buffer)
        kept = total.buffer.clone()
        pair[dt] = fg.gradient_solve_lanes(*x[dt], total, *lin[dt])
        check(torch.equal(total.buffer, kept),
              f"K6 solve wrote to its seeds ({dt})")
        full[dt] = fg.gradient_lanes(*x[dt], *ops[dt])
        # every state has one range factor, so the halves' sum adds a zero
        # to what one rank holding every factor computes; shard and whole
        # batch run the same code of the same kernel: the same bits
        whole = fg.gradient_accum_lanes(*x[dt], ops[dt][0], ops[dt][2])
        check(same_bits(total.buffer, whole.buffer),
              f"K6 accum on the two halves does not sum to accum on the "
              f"whole batch bit for bit ({dt})")
        # "solve" and "full" are two instances of the template, and the
        # compiler contracts the linear factors' sums in each its own way:
        # the pair is held to the full kernel by the tolerances below, and
        # the entries that differ are counted
        off_bits[dt] = sum(int((a.nan_to_num() != b.nan_to_num()).sum())
                           for a, b in zip(pair[dt], full[dt]))
    err_pair = {
        f64: max(compare_conditioned(f"K6 pair vs full {nm} float64", a, b, c)
                 for nm, a, b, c in zip(names_s, pair[f64], full[f64],
                                        ps[f32])),
        f32: max(compare_vs_f64(f"K6 pair vs full {nm} float32", a, b, c)
                 for nm, a, b, c in zip(names_s, pair[f32], full[f32],
                                        ps[f64])),
    }
    for dt in (f64, f32):
        print(f"[split gradient {str(dt)[6:]}] max abs err: accum vs plain "
              f"{err_a[dt]:.3e}, solve vs plain {err_s[dt]:.3e}, accum + "
              f"accum + solve vs the full kernel {err_pair[dt]:.3e} "
              f"({off_bits[dt]} entries differ; the halves sum to accum on "
              f"the whole batch bit for bit)",
              flush=True)
    m = graph_b[f32].nonlinear[0].nodes.shape[0]
    specs0, arrays0 = halves[f32][0]
    # accum: per problem both sweeps with the edge inverse, the moments and
    # the assembly (six products) of the shard's factors; solve: the sweeps
    # again and both solves
    flops_a = B * (N * chain_flops(4) + specs0[0].k * (
        quad_flops(4, m, DIM_X, True) + 12 * 4**3))
    flops_s = B * N * (chain_flops(4) + 2 * solve_flops(4))
    return {
        "fused_gradient_accum": dict(
            **bound((x[f32], arrays0), ka[f32][0], flops_a),
            max_abs_err=err_a[f64], err_dtype="float64",
            ms=cuda_ms(lambda: fg.gradient_accum_lanes(*x[f32], specs0,
                                                       arrays0)),
            ms_flushed_l2=cuda_ms_flushed(
                lambda: fg.gradient_accum_lanes(*x[f32], specs0, arrays0)),
            plain_ms=cuda_ms(lambda: accum_plain(f32, 0), reps=1)),
        "fused_gradient_solve": dict(
            **bound((x[f32], seeds[f32], lin[f32][1]), ks[f32], flops_s),
            max_abs_err=err_s[f64], err_dtype="float64",
            ms=cuda_ms(lambda: fg.gradient_solve_lanes(*x[f32], seeds[f32],
                                                       *lin[f32])),
            ms_flushed_l2=cuda_ms_flushed(
                lambda: fg.gradient_solve_lanes(*x[f32], seeds[f32],
                                                *lin[f32])),
            plain_ms=cuda_ms(lambda: solve_plain(f32, seeds[f32]), reps=1)),
    }


# name -> (N, dim_x, problems); no batch is a multiple of K6's four problems
# per block; s = 6 (dim_x = 3), whose edges sit on lane groups of eight:
# one edge, more edges than a warp's four groups take at once (K6) and a
# ragged last turn of the block's sixteen (K5), dynamic starts, two
# nonlinear batches, a ragged block, the global-scratch route
LAYOUTS = {"N=2": (2, 2, 3), "N=5, s=2": (5, 1, 5), "N=33": (33, 2, 3),
           "N=70, s=2": (70, 1, 2), "dynamic starts": (9, 2, 3),
           "two nonlinear batches": (8, 2, 5), "long chain": (520, 2, 2),
           "N=5, s=6": (5, 3, 3), "long chain, s=6": (160, 3, 2),
           "N=2, s=6": (2, 3, 3), "N=33, s=6": (33, 3, 3),
           "dynamic starts, s=6": (9, 3, 3),
           "two nonlinear batches, s=6": (8, 3, 5),
           "ragged, s=6": (12, 3, 6)}


def layout_checks(dev):
    """K5 and the three modes of K6 against their plain versions (float64,
    atol 1e-10 of each output's range, identical NaN patterns) at shapes
    the warp-per-chain layout can get wrong: chains shorter and longer than
    a warp, s = 2, a nonlinear batch with dynamic starts in another order
    than its states, two nonlinear batches, a ragged last block, and a
    chain too long for shared memory (the global-scratch route); at s = 6,
    where an edge sits on a lane group, the same cases for its turns.  Each
    kernel is launched twice for identical bits, and ``accum`` + ``solve``
    must give the ``full`` kernel's bits."""
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    dt = torch.float64
    worst = {}
    for name, (n, dim_x, count) in LAYOUTS.items():
        graph, state = stack_problems(*map(list, zip(*(
            build_chain_estimation(num_states=n, dim_x=dim_x, gh_degree=4,
                                   seed=i, dtype=dt, device=dev)[:2]
            for i in range(count)))))
        nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
        sp, (start, nodes, weights, params) = nl_specs[0], nl_arrays[0]
        if name.startswith("dynamic starts"):
            keep = torch.tensor([7, 2, 5, 0, 3], device=dev)
            nl_specs = (sp._replace(k=len(keep), slice_offset=None),)
            nl_arrays = ((start[keep], nodes, weights, params[:, keep]),)
        elif name.startswith("two nonlinear batches"):
            halves = [torch.arange(h, n, 2, device=dev) for h in (0, 1)]
            nl_specs = tuple(sp._replace(k=len(h), slice_offset=None)
                             for h in halves)
            nl_arrays = tuple((start[h], nodes, weights, params[:, h])
                              for h in halves)
        ops = (nl_specs, lin_specs, nl_arrays, lin_arrays)
        s = 2 * dim_x
        if name.startswith("long chain"):
            check(fg.grad_plan(name, n, s, 8, 0).scratch
                  and ft.trial_plan(name, n, s, TRIALS, 8, 0).scratch,
                  f"N={n} does not take the global-scratch route")
        rng = np.random.default_rng(n)
        t = lambda a: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
        mu = state.mu + t(0.05 * rng.standard_normal((count, n, s)))
        pd, po = state.precision.diag, state.precision.off
        x6 = (mu, pd, po, torch.linspace(1.0, 3.0, count, dtype=dt,
                                         device=dev))
        dq = rng.standard_normal((count, n, s, s))
        x5 = (mu, t(0.5 * rng.standard_normal((count, n, s))), pd, po,
              t(0.5 * (dq + np.swapaxes(dq, -1, -2))),
              t(0.5 * rng.standard_normal((count, n - 1, s, s))),
              t(0.9 * 0.75 ** np.arange(1, TRIALS + 1)))

        def held(tag, got, want):
            def scale(b):
                fin = b[torch.isfinite(b)]
                return max(1.0, float(fin.abs().max())) if fin.numel() else 1.0
            return max(compare(f"{tag}[{i}] {name}", a, b, 0.0,
                               1e-10 * scale(b))
                       for i, (a, b) in enumerate(zip(got, want)))

        full = check_repeatable(f"K6 full {name}",
                                lambda: fg.gradient_lanes(*x6, *ops))
        err = held("K6 full", full, fg.gradient_plain(*x6, *ops))
        part = check_repeatable(
            f"K6 accum {name}",
            lambda: fg.gradient_accum_lanes(*x6, nl_specs, nl_arrays))
        err = max(err, held("K6 accum", part, fg.gradient_plain(
            *x6, nl_specs, (), nl_arrays, (), mode="accum")))
        pair = check_repeatable(
            f"K6 solve {name}",
            lambda: fg.gradient_solve_lanes(*x6, part, lin_specs, lin_arrays))
        check(all(same_bits(a, b) for a, b in zip(pair, full)),
              f"{name}: accum + solve is not the full kernel bit for bit")
        k5 = check_repeatable(f"K5 {name}",
                              lambda: ft.trial_costs_lanes(*x5, *ops))
        p5 = ft.trial_costs_plain(*x5, *ops)
        err5 = held("K5", (k5[0], *k5[1]), (p5[0], *p5[1]))
        worst[name] = (err, err5)
    print("[layouts f64] max abs err vs plain (K6 three modes; K5), two "
          "launches bit-identical, accum + solve == "
          "full: " + "; ".join(
              f"{k}: {a:.1e}, {b:.1e}" for k, (a, b) in worst.items()),
          flush=True)


# name -> (leading shape, N, s) of K1 / K2 layouts: chains shorter and
# longer than a warp's lanes, s = 2, a ragged last warp and lane group
# (counts not a multiple of the 4 or 8 chains a warp carries), the trial
# batch's and the solve pair's leading shapes, and a chain too long for
# shared memory (the global-scratch route); s = 6 (two chains a warp, its
# last 8 lanes repeating its first) at N = 1, an odd count, the trial
# batch's leading shape and on the global-scratch route
CHAIN_LAYOUTS = {"N=1": ((7,), 1, 4), "N=2": ((6,), 2, 4),
                 "N=33": ((5,), 33, 4), "N=70, s=2": ((9,), 70, 2),
                 "ragged": ((13,), 6, 4), "(11, B)": ((11, 37), 5, 4),
                 "(2, B)": ((2, 37), 8, 4), "long chain": ((3,), 1100, 4),
                 "N=1, s=6": ((5,), 1, 6), "N=9, s=6": ((7,), 9, 6),
                 "(11, B), s=6": ((11, 7), 5, 6),
                 "long chain, s=6": ((3,), 240, 6),
                 "N=1, s=1": ((37,), 1, 1), "N=5, s=1": ((21,), 5, 1),
                 "(11, B), s=1": ((11, 37), 3, 1),
                 "long chain, s=1": ((3,), 500, 1),
                 "N=1, s=14": ((5,), 1, 14), "N=9, s=14": ((7,), 9, 14),
                 "(11, B), s=14": ((11, 3), 4, 14),
                 "long chain, s=14": ((3,), 70, 14)}


def chain_layout_checks(dev):
    """K1, K2 and K2's pair entry (an expanded right-hand side) against
    their plain versions in float64 (atol 1e-10 of each output's range,
    identical NaN patterns) at the layouts of ``CHAIN_LAYOUTS``, each
    launched twice for identical bits."""
    from gaussianvi_tpu_torch.kernels import chain

    rng = np.random.default_rng(SEED)
    dt = torch.float64
    worst = {}
    for name, (lead, n, s) in CHAIN_LAYOUTS.items():
        count = int(np.prod(lead))
        diag, off, rhs = (x.reshape(*lead, *x.shape[1:])
                          for x in spd_chains(count, n, s, rng, dt, dev))
        if name.startswith("long chain"):
            check(chain.gbp_plan(n, s, 8).scratch
                  and chain.solve_plan(n, s, 8).scratch,
                  f"N={n} does not take the global-scratch route")
        one = rhs.reshape(-1, n, s)[0].expand(*lead, n, s)
        shifted = diag + torch.eye(s, dtype=dt, device=dev)
        got = (*check_repeatable(
            f"K1 {name}", lambda: chain.gbp_covariance_logdet_lanes(diag, off)),
            check_repeatable(f"K2 {name}",
                             lambda: (chain.solve_lanes(diag, off, rhs),))[0],
            *check_repeatable(f"K2 pair {name}", lambda: chain.solve_pair_lanes(
                diag, off, shifted, off, one)))
        want = (*chain.gbp_covariance_logdet_plain(diag, off),
                chain.solve_plain(diag, off, rhs),
                *chain.solve_pair_plain(diag, off, shifted, off, one))
        worst[name] = max(
            compare(f"chain output {i} {name}", a, b, 0.0,
                    1e-10 * max(1.0, float(b.abs().max())) if b.numel()
                    else 1e-10)
            for i, (a, b) in enumerate(zip(got, want)))
    print("[chain layouts f64] max abs err vs plain (K1, K2, K2 pair), two "
          "launches bit-identical: " + "; ".join(
              f"{k}: {v:.1e}" for k, v in worst.items()), flush=True)


# name -> (leading shape, K, dim_x, degree, marginal rule, params' leading
# shape, view) of K3 / K4 layouts: factor counts that are not a multiple
# of a warp's factors (1, 3, 33, 1025), leading shapes (), (B,) and (T, B),
# params [K, P], [1, K, P] and [B, K, P] broadcast, rules of 7, 29 and 137
# nodes at d = 2 and 4 and of 69 at d = 6, and mu / cov views: a slice of
# the state axis (a batch stride) and a transposed (T, B) pair of axes
# (copied)
QUAD_LAYOUTS = {
    "1 factor, ()": ((), 1, 2, 4, True, (), None),
    "3, (B,)": ((3,), 1, 2, 4, True, (3,), None),
    "33, (T, B)": ((3, 11), 1, 2, 4, True, (11,), None),
    "1025, [1, K, P]": ((25,), 41, 2, 4, True, (1,), None),
    "M=137": ((2,), 17, 2, 4, False, (2,), None),
    "d=2, M=7": ((5,), 7, 1, 7, True, (), None),
    "d=2, M=137": ((3,), 6, 1, 7, False, (3,), None),
    "state slice": ((9,), 5, 2, 4, True, (9,), "slice"),
    "(T, B) transposed": ((4, 3), 6, 2, 4, True, (3,), "transposed"),
    "d=6, M=69, (T, B)": ((3, 11), 5, 3, 4, True, (11,), None),
    "d=6, state slice": ((9,), 5, 3, 4, True, (9,), "slice"),
}


def quad_layout(name, dtype, dev):
    """The operands of a ``QUAD_LAYOUTS`` entry, numpy-seeded: ``(mu, cov,
    nodes, weights, params, rdim)`` with well-conditioned covariances and
    range params."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    lead, k, dim_x, degree, marginal, plead, view = QUAD_LAYOUTS[name]
    fb = build_chain_estimation(num_states=2, dim_x=dim_x, gh_degree=degree,
                                marginal_quad=marginal, dtype=dtype,
                                device=dev)[0].nonlinear[0]
    d = 2 * dim_x
    rng = np.random.default_rng(len(name))
    shape = {"slice": (*lead, k + 3), "transposed": (*lead[::-1], k)}.get(
        view, (*lead, k))
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    mu = t(rng.standard_normal((*shape, d)))
    a = 0.3 * rng.standard_normal((*shape, d, d))
    cov = t(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d))
    if view == "slice":
        mu, cov = mu.narrow(-2, 2, k), cov.narrow(-3, 2, k)
    elif view == "transposed":
        mu, cov = mu.transpose(0, 1), cov.transpose(0, 1)
    par = rng.standard_normal((*plead, k, fb.kernel_params.shape[-1]))
    par[..., -2] = 1.0 + np.abs(par[..., -2])       # range
    par[..., -1] = 0.1 + np.abs(par[..., -1])       # its variance
    return mu, cov, fb.nodes, fb.weights, t(par), fb.quad_rdim


def quad_layout_checks(dev):
    """K3 (both variants) and K4 against their plain versions at the
    layouts of ``QUAD_LAYOUTS``, each launched twice for identical bits,
    K4 also against K3 moments (the same kernel body: identical bits).
    float64: atol 1e-10 of each output's range; float32: the flagship's
    tolerances (rtol 1e-4, atol 1e-6, of the range for the moments).  NaN
    patterns identical."""
    from gaussianvi_tpu_torch.kernels import fused_moments as fm
    from gaussianvi_tpu_torch.kernels import quad

    def scale(b):
        fin = b[torch.isfinite(b)]
        return max(1.0, float(fin.abs().max())) if fin.numel() else 1.0

    for dt in (torch.float64, torch.float32):
        f64 = dt == torch.float64
        worst = {}
        for name in QUAD_LAYOUTS:
            mu, cov, nodes, weights, par, rdim = quad_layout(name, dt, dev)
            args = (mu, cov, nodes, weights, "range", par)
            phi = check_repeatable(f"K3 phi {name} {dt}", lambda: (
                quad.quad_lanes_phi(*args, nonneg=True),))
            mom = check_repeatable(f"K3 moments {name} {dt}", lambda:
                                   quad.quad_lanes_moments(*args, rdim=rdim))
            k4 = check_repeatable(f"K4 {name} {dt}", lambda: fm.fused_moments(
                nodes, weights, mu, cov, "range", par, rdim=rdim))
            check(all(same_bits(a, b) for a, b in zip(k4, mom)),
                  f"K4 {name} {dt}: not K3 moments' bits")
            want = (quad.quad_phi_plain(*args, nonneg=True),
                    *quad.quad_moments_plain(*args, rdim=rdim))
            worst[name] = max(
                compare(f"K3 output {i} {name} {dt}", a, b,
                        0.0 if f64 else 1e-4,
                        (1e-10 if f64 else 1e-6) * (scale(b) if i or f64
                                                    else 1.0))
                for i, (a, b) in enumerate(zip((*phi, *mom), want)))
        print(f"[quad layouts {str(dt)[6:]}] max abs err vs plain (K3 phi, "
              f"K3 moments; K4 = K3 moments bit for bit), two launches "
              f"bit-identical: " + "; ".join(
                  f"{k}: {v:.1e}" for k, v in worst.items()), flush=True)


def fused_guard_cases(dtype, dev):
    """K5's guards agree between kernel and plain: the pivot-trust log
    det, the nonneg band on E[phi] and a negative linear cost are each
    poisoned in both."""
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    eps = torch.finfo(dtype).eps
    graph, state = stack_problems(*map(list, zip(*(
        build_chain_estimation(num_states=2, dim_x=1, gh_degree=4, seed=i,
                               dtype=dtype, device=dev)[:2]
        for i in range(2)))))
    nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(graph)
    # nonneg band: every node at the mean, weights 1 and -1 - delta (inside
    # the 4096-ulp band, above the 64-ulp cancellation threshold)
    delta = 1e-4 if dtype == torch.float32 else 1e-13
    start, nodes, weights, params = nl_arrays[0]
    w = torch.zeros_like(weights)
    w[0], w[1] = 1.0, -1.0 - delta
    nl_arrays = ((start, torch.zeros_like(nodes), w, params),)
    # negative linear cost: the anchor with its constant negated
    st, a, lam, pm, pc = lin_arrays[0]
    lin_arrays = ((st, -a, lam, pm, -pc),) + lin_arrays[1:]
    # pivot trust: problem 0's Schur pivot D1 - B^T D0^-1 B cancels to ~1
    # ulp; problem 1 is healthy
    eye = torch.eye(2, dtype=dtype, device=dev)
    pd = torch.stack([torch.stack([eye, (1 + 2 * eps) * eye]),
                      torch.stack([eye, 2 * eye])])
    po = torch.stack([eye[None], eye[None]])
    trials = torch.tensor([0.5, 0.25], dtype=dtype, device=dev)
    x = (state.mu, torch.zeros_like(state.mu), pd, po, torch.zeros_like(pd),
         torch.zeros_like(po), trials)
    k = ft.trial_costs_lanes(*x, nl_specs, lin_specs, nl_arrays, lin_arrays)
    p = ft.trial_costs_plain(*x, nl_specs, lin_specs, nl_arrays, lin_arrays)
    for ld in (k[0], p[0]):
        check(bool(torch.isnan(ld[:, 0]).all())
              and bool(torch.isfinite(ld[:, 1]).all()),
              f"K5 pivot-trust case wrong ({dtype}): {ld}")
    for fc in (k[1], p[1]):
        check(bool(torch.isnan(fc[0]).all()),
              f"K5 nonneg band case not poisoned ({dtype})")
        check(bool(torch.isnan(fc[1]).all()),
              f"K5 negative linear cost not poisoned ({dtype})")
    check(torch.equal(torch.isnan(k[1][2]), torch.isnan(p[1][2]))
          and bool(torch.isfinite(p[1][2][:, 1]).all()),
          f"K5 edge costs of the guard case differ ({dtype})")


def held_to_plain(name, got, want, dev, rtol=1e-9, tag="end to end"):
    """A kernel path's float64 run against another path's (the plain
    path's, as a rule): every relative cost within ``rtol`` and the same
    accepted steps."""
    want_cost = want.cost.to(dev)
    rel = ((got.cost - want_cost).abs() / want_cost.abs()).max().item()
    count = got.cost.shape[0] if got.cost.ndim > 1 else 1
    print(f"[{tag}] {name} (f64, {count} problems, "
          f"{got.cost.shape[-1]} iters): max relative cost difference "
          f"{rel:.3e}", flush=True)
    check(rel < rtol, f"{name} differ: {rel:.3e}")
    check(torch.equal(got.accepted_step, want.accepted_step.to(dev)),
          f"{name}: different accepted steps")


def check_costs(name, hist, batch, iters=NITERS, nonneg=False):
    """Every recorded cost finite and non-increasing; the final one > 0,
    or (``nonneg``, a planner's hinge costs) every one >= 0."""
    cost = hist.cost.double()
    check(cost.shape == (batch, iters), f"{name}: history {cost.shape}")
    check(bool(torch.isfinite(cost).all()), f"{name}: non-finite cost")
    rises = int((cost[:, 1:] > cost[:, :-1]).sum())
    check(rises == 0, f"{name}: {rises} recorded cost increases")
    low = cost >= 0 if nonneg else cost[:, -1] > 0
    check(bool(low.all()),
          f"{name}: {int((~low).sum())} costs below the bound (min "
          f"{float(cost.min()):.3e})")


def counted(optimize_fn, *args):
    """Run one path with every launch counter zeroed just before it and
    read just after: ``(result, launches)``.  The loop graphs kept from
    earlier calls are dropped first, so the path's loop runs eager and
    the counts are its launches."""
    from gaussianvi_tpu_torch.inference import loop_graph
    from gaussianvi_tpu_torch.kernels import (
        launch_counts,
        loop_graph_counts,
        reset_launch_counts,
    )

    torch.cuda.synchronize()
    loop_graph.clear()
    reset_launch_counts()
    out = optimize_fn(*args)
    torch.cuda.synchronize()
    kinds = loop_graph_counts()
    check(kinds["captured"] == kinds["replayed"] == 0,
          f"a counted path took a loop graph: {kinds}")
    return out, launch_counts()


def rate(run, work, runs=3):
    """``work`` prob-iters over the median wall time of ``runs`` calls of
    ``run`` (host clock around ``synchronize``).  Taken late in this long
    process, it reads up to 2x below a fresh process and shows that a path
    runs, no more: the rates to quote are scripts/torch_profile.py's
    interleaved medians (PERF.md section 5)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return work / statistics.median(times)


B_MIXED = 64                    # the dp=2 x fp=2 mesh's batch
RANKS = 4                       # rank processes of the factor-parallel phase


def sharded_rank(rank, world, device, cfg):
    """One rank process of the factor-parallel phase (all on one card,
    gloo).  Every rank builds the same global batches.  Returns numpy
    results for the parent to check:

    * ``mixed``: dp=2 x fp=2 over all four ranks, B=64, float64;
    * ``small`` (ranks 0, 1): dp=1 x fp=2, 8 problems, float64;
    * ``main`` (ranks 0, 1): dp=1 x fp=2 at B=1024, float32: one warm-up
      run, one run with the launch counters zeroed just before it and read
      just after (with the collectives it ran), then three timed runs;
    * (ranks 0, 1) :func:`point3d_fp_rank`, :func:`options_fp_rank`
      on the same mesh and :func:`sp_rank` on an sp = 2 mesh."""
    from gaussianvi_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy
    from gaussianvi_tpu_torch.parallel import make_mesh, optimize_sharded

    set_precision_policy()

    def result(state, hist):
        return dict(cost=hist.cost.cpu().numpy(),
                    accepted_step=hist.accepted_step.cpu().numpy(),
                    factor_costs=hist.factor_costs.cpu().numpy(),
                    mu=state.mu.cpu().numpy(),
                    prec_diag=state.precision.diag.cpu().numpy(),
                    prec_off=state.precision.off.cpu().numpy())

    out = {}
    mesh = make_mesh(2, 2)
    out["mixed"] = result(*optimize_sharded(
        *build_batch(torch.float64, device, B_MIXED), cfg, mesh))
    mesh = make_mesh(1, 2)
    # every rank of the world creates every group, in one order
    sp_mesh = make_mesh(1, 1, sp=2)
    if not mesh.member:
        return out
    out["small"] = result(*optimize_sharded(
        *build_batch(torch.float64, device, 8), cfg, mesh))
    graph, state0 = build_batch(torch.float32, device)
    optimize_sharded(graph, state0, cfg, mesh)
    torch.cuda.synchronize()
    reset_launch_counts()
    reduces, inv0 = mesh.all_reduces, Counter(mesh.inventory)
    state, hist = optimize_sharded(graph, state0, cfg, mesh)
    torch.cuda.synchronize()
    out["main"] = dict(result(state, hist), launches=launch_counts(),
                       all_reduces=mesh.all_reduces - reduces,
                       inventory=dict(mesh.inventory - inv0),
                       backend=mesh.backend, device=str(device))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        optimize_sharded(graph, state0, cfg, mesh)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out["main"]["seconds"] = statistics.median(times)
    out.update(point3d_fp_rank(mesh, device, result))
    out.update(patch_fp_rank(mesh, device, result))
    out.update(options_fp_rank(mesh, device, cfg, result))
    out.update(sp_rank(sp_mesh, device))
    return out


# the loop's options on the factor-parallel path, each held to the
# single-process run with the same option
FP_OPTIONS = {"bf16": dict(moments_eval_dtype="bfloat16"),
              "seq": dict(linesearch="seq"), "ema": dict(ema_alpha=0.5)}
# the sequence-parallel phase: chain estimation at N = 4096 on sp = 2 ranks
SP_N, SP_RANKS = 4096, 2


def _counted_run(fn, mesh):
    """``fn()`` with the launch counters zeroed just before it and read
    just after: ``(result, launches, the collectives it ran, seconds)``."""
    from gaussianvi_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    torch.cuda.synchronize()
    reset_launch_counts()
    inv0 = Counter(mesh.inventory)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, launch_counts(), dict(mesh.inventory - inv0),
            time.perf_counter() - t)


def point3d_fp_rank(mesh, device, result):
    """The 3-D point planner at dp = 1 x fp = 2 (K6 accum / solve at
    s = 6): its 1024 restarts in float32, counted, and 8 restarts in
    float64."""
    from gaussianvi_tpu_torch.parallel import optimize_sharded
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    # optimize_sharded takes the problem-batched graph (one per restart,
    # views of the one problem's)
    graph, inits, cfg, _ = point3d_problem(torch.float32, device)
    graph = _batch_graph(graph, S6_B)
    (state, hist), n, inv, sec = _counted_run(
        lambda: optimize_sharded(graph, inits, cfg, mesh), mesh)
    g8, s8, _, _ = point3d_problem(torch.float64, device, 8)
    return {"p3 main": dict(result(state, hist), launches=n, inventory=inv,
                            seconds=sec),
            "p3 small": result(*optimize_sharded(_batch_graph(g8, 8), s8,
                                                 cfg, mesh))}


def options_fp_rank(mesh, device, cfg, result):
    """The flagship at dp = 1 x fp = 2, 8 problems in float64, once for
    each of :data:`FP_OPTIONS`, counted."""
    from gaussianvi_tpu_torch.parallel import optimize_sharded

    g8, s8 = build_batch(torch.float64, device, 8)
    out = {}
    for name, fields in FP_OPTIONS.items():
        res, n, _, _ = _counted_run(lambda fields=fields: optimize_sharded(
            g8, s8, replace(cfg, **fields), mesh), mesh)
        out[f"option {name}"] = dict(result(*res), launches=n)
    return out


def sp_rank(mesh, device):
    """Chain estimation at N = 4096, dim_x = 2, 10 iterations, on this
    rank's half of the states (``parallel.optimize_time_sharded``): NGD in
    float64, again with ``quad_impl="lanes"`` (K3), and in float32, each
    counted with the collectives it ran; then the time of one halo
    exchange and of one all-reduce at the trial batch's shapes."""
    from gaussianvi_tpu_torch import GVIConfig
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.parallel import (
        optimize_time_sharded,
        to_chain_layout,
    )

    if not mesh.member:
        return {}
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    problems = {}
    for dt in (torch.float64, torch.float32):
        graph, init, _ = build_chain_estimation(
            num_states=SP_N, dim_x=DIM_X, gh_degree=DEGREE, seed=SEED,
            dtype=dt, device=device)
        problems[dt] = (to_chain_layout(graph), init)
    out = {}
    for name, dt, c in (("sp f64", torch.float64, cfg),
                        ("sp f64 lanes", torch.float64,
                         replace(cfg, quad_impl="lanes")),
                        ("sp f32", torch.float32, cfg)):
        (final, hist), n, inv, sec = _counted_run(
            lambda dt=dt, c=c: optimize_time_sharded(*problems[dt], c, mesh),
            mesh)
        out[name] = dict(cost=hist.cost.cpu().numpy(),
                         accepted_step=hist.accepted_step.cpu().numpy(),
                         mu=final.mu.cpu().numpy(), launches=n,
                         inventory=inv, seconds=sec)
    mat = torch.ones(TRIALS, 4, 4, dtype=torch.float64, device=device)
    vec = torch.ones(TRIALS, dtype=torch.float64, device=device)
    ms = {}
    for what, fn in (("halo", lambda: mesh.halo(mat, offset=1)),
                     ("all_reduce", lambda: mesh.psum(vec))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        ms[what] = 1e3 * (time.perf_counter() - t) / 50
    out["sp collective ms"] = ms
    return out


def sharded_path(cfg, dev, optimize):
    """The factor-parallel path on this card: four rank processes (spawned
    after the kernel library is built, so none of them compiles), checked
    against the single-process fused path.  Returns rank 0's launch counts
    of its counted B=1024 run and the path's rate."""
    from gaussianvi_tpu_torch.parallel.multiprocess import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(sharded_rank, RANKS, (cfg,), backend="gloo",
                        device=str(dev), timeout_s=600.0)
    print(f"[factor-parallel path] {RANKS} ranks on {dev} done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def same(a, b, what):
        for k in ("cost", "accepted_step", "factor_costs", "mu", "prec_diag",
                  "prec_off"):
            check(np.array_equal(a[k], b[k], equal_nan=True),
                  f"{what}: the ranks of one fp row differ in {k}")

    def against_local(name, got, batch):
        _, ref = optimize(*build_batch(torch.float64, dev, batch), cfg)
        want = ref.cost.cpu().numpy()
        rel = float(np.max(np.abs(got["cost"] - want) / np.abs(want)))
        print(f"[end to end] {name} vs the single-process fused path (f64, "
              f"{batch} problems): max relative cost difference {rel:.3e}",
              flush=True)
        check(rel <= 1e-9, f"{name} differs: {rel:.3e}")
        check(np.array_equal(got["accepted_step"],
                             ref.accepted_step.cpu().numpy()),
              f"{name}: different accepted steps")
        check(got["factor_costs"].shape == tuple(ref.factor_costs.shape),
              f"{name}: factor costs {got['factor_costs'].shape}")
        rel_fc = float(np.max(
            np.abs(got["factor_costs"] - ref.factor_costs.cpu().numpy())
            / np.abs(want)[..., None]))
        check(rel_fc <= 1e-9, f"{name}: factor costs out of order or off: "
              f"{rel_fc:.3e} of the cost")

    # dp=2 x fp=2: ranks (0, 1) hold problems 0..31, ranks (2, 3) the rest
    same(ranks[0]["mixed"], ranks[1]["mixed"], "mixed mesh row 0")
    same(ranks[2]["mixed"], ranks[3]["mixed"], "mixed mesh row 1")
    mixed = {k: np.concatenate([ranks[0]["mixed"][k], ranks[2]["mixed"][k]])
             for k in ranks[0]["mixed"]}
    against_local("dp=2 x fp=2 mesh", mixed, B_MIXED)
    check("small" not in ranks[2] and "main" not in ranks[3],
          "ranks outside the 1 x 2 mesh ran on it")
    same(ranks[0]["small"], ranks[1]["small"], "fp=2, 8 problems")
    against_local("dp=1 x fp=2 mesh", ranks[0]["small"], 8)

    main0, main1 = ranks[0]["main"], ranks[1]["main"]
    same(main0, main1, "fp=2, B=1024")
    for r, m in enumerate((main0, main1)):
        n = m["launches"]
        print(f"[factor-parallel path] rank {r} ({m['backend']}, "
              f"{m['device']}): launches {n}, {m['all_reduces']} "
              f"all-reduces", flush=True)
        check(n["fused_gradient_accum"] == n["fused_gradient_solve"]
              == n["fused_trials"] == NITERS and n["fused_gradient"] == 0,
              f"rank {r} did not run accum, solve and trials once per "
              f"iteration: {n}")
        check(n["gbp_covariance_logdet"] > 0 and n["quad_phi"] > 0,
              f"rank {r}: the initial covariance / costs skipped their "
              f"kernels: {n}")
        # per iteration the cost, the accumulators and the trial costs;
        # then three lockstep checks
        check(m["all_reduces"] == 3 * NITERS + 3,
              f"rank {r}: {m['all_reduces']} all-reduces")
    cost = torch.as_tensor(main0["cost"]).double()
    check(cost.shape == (B, NITERS) and bool(torch.isfinite(cost).all()),
          "factor-parallel path: non-finite cost")
    rises = int((cost[:, 1:] > cost[:, :-1]).sum())
    check(rises == 0, f"factor-parallel path: {rises} cost increases")
    check(np.isfinite(main0["mu"]).all()
          and np.isfinite(main0["prec_diag"]).all(),
          "factor-parallel path: non-finite final state")
    # what the counted run's all-reduces carried, as comm_model predicts it
    from gaussianvi_tpu_torch.parallel import comm_model

    per_iter, report = comm_model.factor_shard_model(
        N, 4, TRIALS, 29, N, local_batch=B, itemsize=4, fused=True)
    want = comm_model.expected(per_iter, NITERS, comm_model.factor_shard_setup(
        N, 4, NITERS, (N // 2,), local_batch=B))
    check(main0["inventory"] == dict(want),
          f"factor-parallel path: collectives {main0['inventory']} against "
          f"comm_model's {dict(want)}")
    print(f"[factor-parallel path] collectives as comm_model predicts: "
          f"{report.bytes_per_iter} B an iteration in "
          f"{sum(per_iter.values())} all-reduces", flush=True)
    rate = B * NITERS / max(main0["seconds"], main1["seconds"])
    extra = {"p3": point3d_fp_checks(ranks, dev, same),
             "patch": patch_fp_checks(ranks, dev, same),
             "options": options_fp_checks(ranks, dev, cfg, same),
             "sp": sp_checks(ranks, dev)}
    return main0["launches"], rate, extra


def point3d_fp_checks(ranks, dev, same):
    """The point planner at fp = 2: K6 accum, solve and K5 30 times a rank
    and full never, the ranks' bits equal, costs finite and non-increasing,
    the collectives comm_model's; 8 restarts in float64 held to the
    single-process fused path over all 30 iterations (PERF.md section 2's
    point-planner gate).  Returns rank 0's launches."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.parallel import comm_model

    main0, main1 = ranks[0]["p3 main"], ranks[1]["p3 main"]
    same(main0, main1, "point3d fp=2, B=1024")
    for r, m in enumerate((main0, main1)):
        n = m["launches"]
        print(f"[point3d fp=2] rank {r}: launches {n} ({m['seconds']:.2f} s, "
              f"B={S6_B}, f32)", flush=True)
        check(n["fused_gradient_accum"] == n["fused_gradient_solve"]
              == n["fused_trials"] == P3_ITERS and n["fused_gradient"] == 0,
              f"point3d fp=2 rank {r}: not the split pair and K5 once an "
              f"iteration: {n}")
    check_costs("point3d fp=2", SimpleNamespace(cost=torch.as_tensor(
        main0["cost"])), S6_B, P3_ITERS, nonneg=True)
    m = point3d_problem(torch.float64, dev, 1)[0].nonlinear[0]
    k = m.num_factors
    per_iter, _ = comm_model.factor_shard_model(
        P3_N, 6, TRIALS, m.nodes.shape[0], k, local_batch=S6_B, itemsize=4,
        fused=True)
    want = comm_model.expected(per_iter, P3_ITERS, comm_model.factor_shard_setup(
        P3_N, 6, P3_ITERS, (k // 2,), local_batch=S6_B))
    check(main0["inventory"] == dict(want),
          f"point3d fp=2: collectives {main0['inventory']} against "
          f"comm_model's {dict(want)}")
    same(ranks[0]["p3 small"], ranks[1]["p3 small"], "point3d fp=2, f64")
    g8, s8, cfg, _ = point3d_problem(torch.float64, dev, 8)
    _, ref = optimize(g8, s8, cfg)
    held_to_plain("point3d fp=2 vs the single-process fused path",
                  SimpleNamespace(**{k_: torch.as_tensor(v, device=dev)
                                     for k_, v in ranks[0]["p3 small"].items()
                                     if k_ in ("cost", "accepted_step")}),
                  ref, dev, tag="factor-parallel end to end")
    return main0["launches"]


def options_fp_checks(ranks, dev, cfg, same):
    """Each option at fp = 2 (8 problems, float64) against the
    single-process run with the same option: 1e-9 and the same steps;
    bfloat16 by PERF.md section 2's bf16 gate (1e-4, the same steps: a
    bfloat16 rounding is a step function).  K6 accum / solve ran once an
    iteration, K5 only under the batched line search.  Returns rank 0's
    launches per option."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch import optimize

    g8, s8 = build_batch(torch.float64, dev, 8)
    out = {}
    for name, fields in FP_OPTIONS.items():
        got = ranks[0][f"option {name}"]
        same(got, ranks[1][f"option {name}"], f"fp=2 with {name}")
        n = got["launches"]
        trials = 0 if name == "seq" else NITERS
        check(n["fused_gradient_accum"] == n["fused_gradient_solve"] == NITERS
              and n["fused_trials"] == trials and n["fused_gradient"] == 0,
              f"fp=2 with {name}: launches {n}")
        _, ref = optimize(g8, s8, replace(cfg, **fields))
        held_to_plain(f"fp=2 with {name} vs the single-process run with it",
                      SimpleNamespace(**{k: torch.as_tensor(got[k], device=dev)
                                         for k in ("cost", "accepted_step")}),
                      ref, dev, rtol=1e-4 if name == "bf16" else 1e-9,
                      tag="factor-parallel end to end")
        out[f"fp {name}"] = n
    return out


def sp_checks(ranks, dev):
    """The sequence-parallel phase: both ranks the same run; float64 held
    to the single-process ``optimize`` on the whole chain (1e-9, the same
    steps), the K3 run to the plain-quadrature one (K3 launched), float32
    finite and non-increasing; each run's collectives as comm_model
    predicts them, printed per iteration beside the prediction.  Returns
    the K3 run's launches (rank 0)."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )
    from gaussianvi_tpu_torch.parallel import comm_model

    check(all(not r.get("sp f64") for r in ranks[SP_RANKS:]),
          "ranks outside the sp mesh ran on it")
    runs = {name: ranks[0][name] for name in ("sp f64", "sp f64 lanes",
                                              "sp f32")}
    for name, run in runs.items():
        other = ranks[1][name]
        check(all(np.array_equal(run[k], other[k], equal_nan=True)
                  for k in ("cost", "accepted_step", "mu")),
              f"{name}: the two sp ranks return other results")
        print(f"[sequence-parallel] {name}: {run['seconds']:.2f} s on rank 0 "
              f"(N={SP_N}, {NITERS} iters), launches {run['launches']}",
              flush=True)
    mesh = SimpleNamespace(size=SP_RANKS)
    per_iter = comm_model.time_shard_model(SP_N, 4, TRIALS, mesh)
    setup = comm_model.time_shard_setup(SP_N, 4, NITERS, mesh)
    want = comm_model.expected(per_iter, NITERS, setup)
    for name, run in runs.items():
        check(run["inventory"] == dict(want),
              f"{name}: collectives {run['inventory']} against comm_model's "
              f"{dict(want)}")
    measured = Counter(runs["sp f64"]["inventory"])
    measured.subtract(setup)
    by_op = {op: (sum(c for (o, _, _), c in measured.items() if o == op)
                  / NITERS,
                  sum(c for (o, _, _), c in per_iter.items() if o == op))
             for op in ("all_reduce", "halo", "all_gather")}
    ms = ranks[0]["sp collective ms"]
    print("[sequence-parallel] per iteration, measured / comm_model: " +
          ", ".join(f"{op} {a:g} / {b}" for op, (a, b) in by_op.items())
          + f"; one halo {ms['halo']:.3f} ms, one all-reduce "
          f"{ms['all_reduce']:.3f} ms (gloo, both ranks on this card: no "
          f"scaling figure)", flush=True)
    check(all(a == b for a, b in by_op.values()),
          f"sp collectives per iteration differ from comm_model: {by_op}")
    graph, init, _ = build_chain_estimation(
        num_states=SP_N, dim_x=DIM_X, gh_degree=DEGREE, seed=SEED,
        dtype=torch.float64, device=dev)
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    t = time.perf_counter()
    _, ref = optimize(graph, init, cfg)
    torch.cuda.synchronize()
    print(f"[sequence-parallel] the single-process run: "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    def hist(run):
        return SimpleNamespace(cost=torch.as_tensor(run["cost"], device=dev),
                               accepted_step=torch.as_tensor(
                                   run["accepted_step"], device=dev))

    held_to_plain("sp=2 vs the single-process run", hist(runs["sp f64"]),
                  ref, dev, tag="sequence-parallel end to end")
    held_to_plain("sp=2 with K3 vs sp=2 plain quadrature",
                  hist(runs["sp f64 lanes"]), hist(runs["sp f64"]), dev,
                  tag="sequence-parallel end to end")
    n = runs["sp f64 lanes"]["launches"]
    check(n["quad_phi"] > 0 and n["quad_moments"] > 0,
          f"sp with quad_impl='lanes' launched no K3: {n}")
    check(sum(runs["sp f64"]["launches"].values()) == 0,
          f"sp plain run launched kernels: {runs['sp f64']['launches']}")
    c32 = runs["sp f32"]["cost"]
    check(np.isfinite(c32).all() and (np.diff(c32) <= 0).all(),
          f"sp f32: costs not finite and non-increasing: {c32}")
    return n


def assoc_checks(dev, cfg):
    """The log-depth chain (``chain_impl="assoc"``, torch ops): at the
    flagship's shape (B = 1024 chains of N = 32, s = 4, float64)
    ``gbp_covariance_logdet_assoc`` and ``solve_assoc`` against K1 and K2
    (atol 1e-10), timed beside them; ``optimize(chain_impl="assoc")``
    against the default path (8 problems, float64, 1e-9, the same steps),
    counted (no kernel: the plain quadrature follows the chain); one chain
    of N = 4096 states against K1, both timed."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.kernels import chain
    from gaussianvi_tpu_torch.ops import parallel_chain as pc
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    f64 = torch.float64
    rng = np.random.default_rng(SEED + 12)
    out = {}
    for tag, nb, n in (("flagship", B, N), ("one chain", 1, SP_N)):
        diag, off, rhs = spd_chains(nb, n, 4, rng, f64, dev)
        a = BlockTridiag(diag, off)
        got = pc.gbp_covariance_logdet_assoc(a)
        want = chain.gbp_covariance_logdet_lanes(diag, off)
        err = max(compare(f"assoc {tag} {what}", g, w, 0.0, 1e-10)
                  for what, g, w in zip(("cov_diag", "cov_off", "logdet"),
                                        got, want))
        err = max(err, compare(f"assoc {tag} solve", pc.solve_assoc(a, rhs),
                               chain.solve_lanes(diag, off, rhs), 0.0, 1e-10))
        ms = {"assoc": cuda_ms(lambda: pc.gbp_covariance_logdet_assoc(a),
                               reps=3),
              "K1": cuda_ms(lambda: chain.gbp_covariance_logdet_lanes(
                  diag, off))}
        if tag == "flagship":
            ms["solve_assoc"] = cuda_ms(lambda: pc.solve_assoc(a, rhs),
                                        reps=3)
            ms["K2"] = cuda_ms(lambda: chain.solve_lanes(diag, off, rhs))
        print(f"[assoc] {tag} ({nb} x N={n}, s=4, f64): max abs err vs "
              f"K1 / K2 {err:.3e}; ms per call " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        out[tag] = dict(max_abs_err=err, ms=ms)
    g8, s8 = build_batch(f64, dev, num_problems=8)
    (_, h_assoc), n = counted(optimize, g8, s8,
                              replace(cfg, chain_impl="assoc"))
    print(f"[assoc path] launches {n}", flush=True)
    check(sum(n.values()) == 0, f"the assoc path launched kernels: {n}")
    held_to_plain("assoc path vs the default path", h_assoc,
                  optimize(g8, s8, cfg)[1], dev, tag="assoc end to end")
    return out


# ---- the planar planner (examples/planar_planning.py) --------------------
# build_planar_planning's own config: N = 20 states of dim 4, a 100 x 100
# field, the 13-node 2-D marginal rule of degree 3, 30 iterations (20 at
# temperature 0.1, then 1.0); restarts from parallel.perturb_inits with
# mean_scale 0.3, the batch the JAX package's planning bench ran
PLAN_B, PLAN_N, PLAN_ITERS = 1024, 20, 30
PLAN_B_SEPARATE = 256
PLAN_B_PLAIN = 64
# operations of one planar SDF cost evaluation (clip, two divisions, two
# floors, the four-corner blend, the hinge); its four gathers hit L1 / L2
PLANAR_COST_OPS = 35


def restarts(build, dtype, dev, count):
    """``(graph, restarts, config, sdf)``: one planning problem of the
    example builder ``build`` in ``dtype`` and ``count`` perturbed initial
    states (``parallel.perturb_inits``, mean_scale 0.3), drawn in float64
    and cast, so both dtypes start from the same restarts (restart 0 is
    the nominal straight line, through the obstacle)."""
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel import perturb_inits

    graph, _, config, sdf = build(dtype=dtype, device=dev)
    init64 = build(device=dev)[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    inits = perturb_inits(init64, gen, count, mean_scale=0.3)
    prec = inits.precision
    inits = GaussianState(inits.mu.to(dtype), BlockTridiag(
        prec.diag.to(dtype), prec.off.to(dtype)))
    return graph, inits, config, sdf


def planner_problem(dtype, dev, count=None):
    """``(graph, restarts, config, sdf)`` of the planar planner
    (:func:`restarts`)."""
    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )

    return restarts(build_planar_planning, dtype, dev, count or PLAN_B)


def subset(state, count):
    """The first ``count`` problems of a batched state."""
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    return GaussianState(state.mu[:count], BlockTridiag(
        state.precision.diag[:count], state.precision.off[:count]))


def planner_iterate(dev):
    """The float64 iterate five plain NGD iterations reach on the 1024
    restarts, with four restarts moved to where the planar cost's clamps
    act: restart 1 on the field's last column (x = 10), restart 2 on its
    last row (y = 10), restart 3 off the field, restart 4 on grid nodes.
    Returns ``(mu, prec_diag, prec_off)``."""
    from gaussianvi_tpu_torch import optimize

    graph, inits, config, _ = planner_problem(torch.float64, dev)
    state, _ = optimize(graph, inits, replace(
        config, niters=5, niters_lowtemp=5, chain_impl="seq",
        quad_impl="xla"))
    mu = state.mu.clone()
    cell = 10.0 / 99
    mu[1, :, 0] = 10.0
    mu[2, :, 1] = 10.0
    mu[3, :, :2] += torch.tensor([-15.0, 14.0], dtype=mu.dtype, device=dev)
    mu[4, :, :2] = torch.round(mu[4, :, :2] / cell) * cell
    return mu, state.precision.diag, state.precision.off


def tridiag_matvec(diag, off, x):
    """``A x`` for block-tridiagonal ``A`` (``diag [B, N, s, s]``, ``off
    [B, N-1, s, s]`` above the diagonal) and ``x [B, N, s]``."""
    y = torch.einsum("bnij,bnj->bni", diag, x)
    y[:, :-1] += torch.einsum("bnij,bnj->bni", off, x[:, 1:])
    y[:, 1:] += torch.einsum("bnji,bnj->bni", off, x[:, :-1])
    return y


def backward_error(x, x64, diag, off, rows):
    """``max |A (x - x64)| / (|A| |x64|)`` over the problems ``rows`` of a
    block-tridiagonal system ``A`` (float64), max norms, ``|A|`` its
    largest entry times the 3s entries of a row: how far ``x`` is from
    solving the system ``x64`` solves, in units of the system's size.  A
    backward-stable solve keeps it near N eps whatever A's condition."""
    xd, xr = x.double()[rows], x64[rows]
    d, o = diag[rows], off[rows]
    s = xr.shape[-1]
    scale = (3 * s * torch.maximum(d.abs().flatten(1).amax(1),
                                   o.abs().flatten(1).amax(1))
             * xr.abs().flatten(1).amax(1))
    return (tridiag_matvec(d, o, xd - xr).abs().flatten(1).amax(1)
            / scale).max().item()


def compare_backward(name, x_k, x_p, diag, off):
    """A float64 kernel solution ``x_k`` of ``A x = b`` held to the plain
    version's ``x_p`` by its backward error in the plain system
    (:func:`backward_error`) instead of a forward bound: on systems whose
    condition makes float32 saturate, the forward bound scaled from
    float32 says nothing.  NaN patterns (an indefinite A) must be
    identical.  Returns ``(backward error, forward max abs difference)``."""
    check(torch.equal(torch.isnan(x_k), torch.isnan(x_p)),
          f"{name}: NaN pattern differs")
    fin = torch.isfinite(x_p).flatten(1).all(1)
    if not fin.any():
        return 0.0, 0.0
    back = backward_error(x_k, x_p, diag, off, fin)
    check(back <= 1e-10, f"{name}: backward error {back:.3e} over 1e-10")
    return back, (x_k - x_p)[fin].abs().max().item()


def compare_backward_vs_f64(name, x_k32, x_p32, x_p64, diag, off):
    """The float32 counterpart of :func:`compare_backward`, in the form of
    :func:`compare_vs_f64`: the kernel takes no more NaN (indefinite)
    decisions that differ from float64's than the float32 plain version,
    and its backward error in the float64 plain system is at most 4 times
    the float32 plain version's plus 16 float32 ulps.  Returns the
    kernel's backward error."""
    nan_r = ~torch.isfinite(x_p64).flatten(1).all(1)
    mis_k = int(((~torch.isfinite(x_k32).flatten(1).all(1)) != nan_r).sum())
    mis_p = int(((~torch.isfinite(x_p32).flatten(1).all(1)) != nan_r).sum())
    check(mis_k <= mis_p, f"{name}: {mis_k} NaN decisions differ from "
          f"float64, the plain version's {mis_p}")
    rows = (torch.isfinite(x_k32).flatten(1).all(1)
            & torch.isfinite(x_p32).flatten(1).all(1) & ~nan_r)
    if not rows.any():
        return 0.0
    back_k = backward_error(x_k32, x_p64, diag, off, rows)
    back_p = backward_error(x_p32, x_p64, diag, off, rows)
    check(back_k <= 4 * back_p + 16 * torch.finfo(torch.float32).eps,
          f"{name}: backward error {back_k:.3e}, the float32 plain "
          f"version's {back_p:.3e}")
    return back_k


def planner_kernel_checks(dev):
    """K3 (both variants), K5 and K6 ``full`` with the planar SDF cost
    against their plain versions at the planner's shapes: the trial batch
    [11, 1024, 20] and the gradient batch [1024, 20], the 13-node rule,
    the 100 x 100 field.  At :func:`planner_iterate` the factors include
    ones clear of the obstacle (E[phi] exactly 0), inside it, off the
    field and on its last row and column; K5 takes the direction the
    next NGD step takes.  float64 is held with :func:`compare_conditioned`,
    float32 with :func:`compare_vs_f64`, each kernel launched twice for the
    same bits; float64 zeros must fall where the plain version's do.  K6's
    main solve (``Vddmu dmu = -Vdmu``) is held by its backward error
    (:func:`compare_backward`, :func:`compare_backward_vs_f64`): this
    iterate's Vddmu is so ill-conditioned on some restarts that float32
    saturates there, so a forward bound scaled from it says nothing.
    Times the four kernels in float32 with their plain versions and
    bounds, and K1 / K2 (no cost functor) on well-conditioned chains at
    the planner's shapes."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import chain, quad
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f32, f64 = torch.float32, torch.float64
    it64 = planner_iterate(dev)
    cd64 = gbp_covariance_logdet(BlockTridiag(*it64[1:]))[0]
    rng = np.random.default_rng(SEED)
    jitter = torch.tensor(0.05 * rng.standard_normal(
        (TRIALS, PLAN_B, PLAN_N, 4)), dtype=f64, device=dev)
    graphs, args3, args4, x5, x6, ops = {}, {}, {}, {}, {}, {}
    for dt in (f64, f32):
        graphs[dt] = planner_problem(dt, dev, 1)[0]
        fb = graphs[dt].nonlinear[0]
        mu, pd, po = (x.to(dt) for x in it64)
        cd = cd64.to(dt)
        args3[dt] = ((mu + jitter.to(dt)).contiguous(),
                     cd.expand(TRIALS, *cd.shape).contiguous(), fb.nodes,
                     fb.weights, "planar_sdf", fb.kernel_params)
        args4[dt] = (mu, cd, fb.nodes, fb.weights, "planar_sdf",
                     fb.kernel_params)
        ops[dt] = fused_operands(_batch_graph(graphs[dt], PLAN_B))
        x6[dt] = (mu, pd, po, torch.full((PLAN_B,), 0.1, dtype=dt,
                                         device=dev))
    p6 = fg.gradient_plain(*x6[f64], *ops[f64])
    finite = torch.isfinite(p6[5]).flatten(1).all(1)
    direction = (torch.where(finite[:, None, None], p6[5], p6[6]), p6[3],
                 p6[4])
    for dt in (f64, f32):
        dmu, dpd, dpo = (x.to(dt) for x in direction)
        trials = 0.9 * 0.75 ** torch.arange(1, TRIALS + 1, dtype=dt,
                                            device=dev)
        mu, pd, po, _ = x6[dt]
        x5[dt] = (mu, dmu, pd, po, dpd, dpo, trials)

    def k3_phi(dt):
        fb = graphs[dt].nonlinear[0]
        return (quad.quad_lanes_phi(*args3[dt], nonneg=True,
                                    field=fb.kernel_field),)

    def p3_phi(dt):
        fb = graphs[dt].nonlinear[0]
        return (quad.quad_phi_plain(*args3[dt], nonneg=True,
                                    field=fb.kernel_field),)

    def k3_mom(dt):
        fb = graphs[dt].nonlinear[0]
        return quad.quad_lanes_moments(*args4[dt], rdim=fb.quad_rdim,
                                       field=fb.kernel_field)

    def p3_mom(dt):
        fb = graphs[dt].nonlinear[0]
        return quad.quad_moments_plain(*args4[dt], rdim=fb.quad_rdim,
                                       field=fb.kernel_field)

    def flat5(out):
        return (out[0], *out[1])

    cases = {
        "quad_phi": (k3_phi, p3_phi),
        "quad_moments": (k3_mom, p3_mom),
        "fused_trials": (lambda dt: flat5(ft.trial_costs_lanes(*x5[dt],
                                                               *ops[dt])),
                         lambda dt: flat5(ft.trial_costs_plain(*x5[dt],
                                                               *ops[dt]))),
        "fused_gradient": (lambda dt: fg.gradient_lanes(*x6[dt], *ops[dt]),
                           lambda dt: fg.gradient_plain(*x6[dt], *ops[dt])),
    }
    errs, zeros, solve = {}, {}, {}
    for name, (kern, plain) in cases.items():
        k = {dt: check_repeatable(f"planner {name} {dt}",
                                  lambda dt=dt: kern(dt)) for dt in (f64, f32)}
        p = {dt: plain(dt) for dt in (f64, f32)}
        held64 = list(zip(k[f64], p[f64], p[f32]))
        held32 = list(zip(k[f32], p[f32], p[f64]))
        if name == "fused_gradient":
            # output 5, dmu, by its backward error in the float64 plain
            # system Vddmu = dprec + Lambda
            _, pd, po, _ = x6[f64]
            vdd = (p[f64][3] + pd, p[f64][4] + po)
            solve["backward"], solve["forward"] = compare_backward(
                "planner fused_gradient dmu float64", k[f64][5], p[f64][5],
                *vdd)
            solve["backward32"] = compare_backward_vs_f64(
                "planner fused_gradient dmu float32", k[f32][5], p[f32][5],
                p[f64][5], *vdd)
            solve["indefinite"] = int(
                (~torch.isfinite(p[f64][5]).flatten(1).all(1)).sum())
            held64, held32 = held64[:5] + held64[6:], held32[:5] + held32[6:]
        errs[name, f64] = max(
            compare_conditioned(f"planner {name}[{i}] float64", a, b, c)
            for i, (a, b, c) in enumerate(held64))
        errs[name, f32] = max(
            compare_vs_f64(f"planner {name}[{i}] float32", a, b, c)
            for i, (a, b, c) in enumerate(held32))
        if name in ("quad_phi", "quad_moments", "fused_trials"):
            # E[phi] of the clear factors: exactly 0 in both, never NaN
            at = 1 if name == "fused_trials" else 0
            got, want = k[f64][at], p[f64][at]
            check(torch.equal(got == 0, want == 0) and bool((want == 0).any())
                  and bool((want > 0).any()),
                  f"planner {name}: exact zeros differ from the plain "
                  f"version's ({int((got == 0).sum())} vs "
                  f"{int((want == 0).sum())})")
            zeros[name] = (int((want == 0).sum()), want.numel(),
                           int((k[f32][at] == 0).sum()),
                           int((p[f32][at] == 0).sum()))
    print("[planner kernels] max abs err vs plain, f64 / f32 (two launches "
          "bit-identical each): " + "; ".join(
              f"{n} {errs[n, f64]:.3e} / {errs[n, f32]:.3e}" for n in cases)
          + "; exact-zero E[phi] (f64 kernel = plain, f32 kernel / plain): "
          + "; ".join(f"{n} {z[0]}/{z[1]} ({z[2]} / {z[3]})"
                      for n, z in zeros.items())
          + f"; K6 dmu: backward error f64 {solve['backward']:.3e} (max abs "
          f"difference {solve['forward']:.3e}), f32 {solve['backward32']:.3e};"
          f" Vddmu indefinite on {solve['indefinite']}/{PLAN_B}", flush=True)

    field = graphs[f32].nonlinear[0].kernel_field
    m = graphs[f32].nonlinear[0].nodes.shape[0]
    cost = dict(cost=PLANAR_COST_OPS)
    work = {
        "quad_phi": TRIALS * PLAN_B * PLAN_N * quad_flops(4, m, 2, False,
                                                          **cost),
        "quad_moments": PLAN_B * PLAN_N * quad_flops(4, m, 2, True, **cost),
        "fused_trials": TRIALS * PLAN_B * PLAN_N * (
            chain_flops(4) + quad_flops(4, m, 2, False, **cost) + 16 * 4**2),
        "fused_gradient": PLAN_B * PLAN_N * (
            chain_flops(4) + quad_flops(4, m, 2, True, **cost)
            + 12 * 4**3 + 2 * solve_flops(4)),
    }
    inputs = {"quad_phi": args3[f32][:4] + args3[f32][5:] + (field,),
              "quad_moments": args4[f32][:4] + args4[f32][5:] + (field,),
              "fused_trials": (x5[f32], ops[f32][2:]),
              "fused_gradient": (x6[f32], ops[f32][2:])}
    out = {}
    for name, (kern, plain) in cases.items():
        out[name] = dict(
            max_abs_err=errs[name, f64], err_dtype="float64",
            ms=cuda_ms(lambda: kern(f32)),
            ms_flushed_l2=cuda_ms_flushed(lambda: kern(f32)),
            plain_ms=cuda_ms(lambda: plain(f32), reps=1),
            **bound(inputs[name], kern(f32), work[name]))
    # K1 on the trial batch and K2 on the pair at the planner's shapes
    # (cost-free: well-conditioned chains, the flagship's float32
    # tolerances), timed beside the others
    rng = np.random.default_rng(SEED + 2)
    d1, o1, _ = spd_chains(TRIALS * PLAN_B, PLAN_N, 4, rng, f32, dev)
    d2, o2, rhs = spd_chains(2 * PLAN_B, PLAN_N, 4, rng, f32, dev)
    chains = {
        "gbp_covariance_logdet": (
            chain.gbp_covariance_logdet_lanes,
            chain.gbp_covariance_logdet_plain,
            (d1.reshape(TRIALS, PLAN_B, PLAN_N, 4, 4),
             o1.reshape(TRIALS, PLAN_B, PLAN_N - 1, 4, 4)),
            TRIALS * PLAN_B * PLAN_N * chain_flops(4)),
        "solve": (chain.solve_pair_lanes, chain.solve_pair_plain,
                  (d2[:PLAN_B], o2[:PLAN_B], d2[PLAN_B:], o2[PLAN_B:],
                   rhs[:PLAN_B]), 2 * PLAN_B * PLAN_N * solve_flops(4)),
    }
    for name, (kern, plain, args, flops) in chains.items():
        got = check_repeatable(f"planner {name} {f32}",
                               lambda kern=kern, args=args: kern(*args))
        want = plain(*args)
        err = max(compare(f"planner {name}[{i}] float32", a, b_,
                          *((1e-5, 0.0) if a.ndim == 2 else (1e-4, 1e-6)))
                  for i, (a, b_) in enumerate(zip(got, want)))
        out[name] = dict(
            max_abs_err=err, err_dtype="float32",
            ms=cuda_ms(lambda kern=kern, args=args: kern(*args)),
            ms_flushed_l2=cuda_ms_flushed(
                lambda kern=kern, args=args: kern(*args)),
            plain_ms=cuda_ms(lambda plain=plain, args=args: plain(*args),
                             reps=1),
            **bound(args, got, flops))
    out["solve"]["library_ms"] = dense_solve_ms(chains["solve"][2])
    return out


def check_plan(name, hist, state, sdf, batch):
    """Costs finite, non-increasing and non-negative on every restart;
    restart 0 (the straight line through the obstacle) ends clear of it
    with its endpoints within 0.05 of start and goal
    (``tests/test_planning.py``)."""
    check_costs(name, hist, batch, PLAN_ITERS, nonneg=True)
    pos = state.mu[0, :, :2]
    clearance = float(sdf.signed_distance(pos).min())
    ends = max(float((pos[0] - torch.tensor([1.0, 1.0], device=pos.device))
                     .abs().max()),
               float((pos[-1] - torch.tensor([8.5, 8.5], device=pos.device))
                     .abs().max()))
    check(clearance > 0.0, f"{name}: restart 0 ends in the obstacle "
          f"(signed distance {clearance:.3e})")
    check(ends < 0.05, f"{name}: restart 0's endpoints off by {ends:.3e}")
    clear = int((sdf.signed_distance(state.mu[..., :2]).amin(-1) > 0).sum())
    return clearance, clear


def planner_runs(card, dev):
    """The planner's paths, each counted: fused (the default) and
    separate, against the plain path and float64; throughput.  Returns
    ``(counts per path, rates)``."""
    from gaussianvi_tpu_torch import optimize

    f32, f64 = torch.float32, torch.float64
    graph32, inits32, cfg, sdf = planner_problem(f32, dev)
    graph64, inits64, _, _ = planner_problem(f64, dev)
    cfg_sep = replace(cfg, fused_trials="off", fused_gradient="off")
    cfg_plain = replace(cfg, chain_impl="seq", quad_impl="xla")

    (state32, hist32), fused_counts = counted(optimize, graph32, inits32, cfg)
    print(f"[planner fused path] launches {fused_counts}", flush=True)
    check(fused_counts["fused_trials"] == PLAN_ITERS
          and fused_counts["fused_gradient"] == PLAN_ITERS,
          f"planner: the fused kernels did not run once per iteration: "
          f"{fused_counts}")
    check(fused_counts["gbp_covariance_logdet"] > 0
          and fused_counts["quad_phi"] > 0,
          f"planner: the initial covariance / costs skipped their kernels: "
          f"{fused_counts}")
    clearance, clear = check_plan("planner fused path", hist32, state32, sdf,
                                  PLAN_B)
    print(f"[planner fused path] restart 0 clears the obstacle by "
          f"{clearance:.4f}; {clear}/{PLAN_B} restarts end clear of it; "
          f"final cost min {float(hist32.cost[:, -1].min()):.4f}, median "
          f"{float(hist32.cost[:, -1].median()):.4f}", flush=True)

    # float32 against float64: every restart's first record, the batch
    # median of the final costs, and restart 0's final cost.  Restart 0's
    # whole history is printed, not gated: on the planner's nominal problem
    # float32 takes another line-search step than float64 at iteration 6
    # on the plain path and in the JAX package alike (history 0.3 apart,
    # final costs 1e-4 apart; tests/test_torch_planning.py
    # test_float32_takes_other_steps_in_both_packages)
    state64, hist64 = optimize(graph64, inits64, cfg)
    rel = ((hist32.cost.double() - hist64.cost).abs()
           / hist64.cost.abs().clamp_min(1e-12))
    rel_first, rel_seed0 = rel[:, 0].max().item(), rel[0].max().item()
    rel_final_median = rel[:, -1].median().item()
    rel_final0 = rel[0, -1].item()
    other = int((~torch.isclose(hist32.accepted_step[0].double(),
                                hist64.accepted_step[0], rtol=1e-5)).sum())
    print(f"[planner fused path] f32 vs f64 relative cost difference: first "
          f"record max {rel_first:.3e}, restart-0 final {rel_final0:.3e} "
          f"(history max {rel_seed0:.3e}; other steps at {other}/"
          f"{PLAN_ITERS} iterations), final median {rel_final_median:.3e} "
          f"(final max {rel[:, -1].max().item():.3e})", flush=True)
    check(rel_first < 1e-4, f"planner first-record f32 vs f64 {rel_first:.3e}")
    check(rel_final0 < 1e-3,
          f"planner restart-0 final f32 vs f64 {rel_final0:.3e}")
    check(rel_final_median < 1e-3,
          f"planner median final f32 vs f64 {rel_final_median:.3e}")

    sep = subset(inits32, PLAN_B_SEPARATE)
    (state_s, hist_s), sep_counts = counted(optimize, graph32, sep, cfg_sep)
    print(f"[planner separate path] launches {sep_counts}", flush=True)
    check(all(sep_counts[k] > 0 for k in ("gbp_covariance_logdet", "solve",
                                          "quad_phi", "quad_moments"))
          and sep_counts["fused_trials"] == sep_counts["fused_gradient"] == 0,
          f"planner: the separate path skipped a kernel: {sep_counts}")
    check_plan("planner separate path", hist_s, state_s, sdf,
               PLAN_B_SEPARATE)

    # kernels against plain versions end to end (float64, 8 restarts).
    # The planner amplifies rounding: on the plain path alone, initial
    # means changed by 1e-15 of their size move the costs by ~1e-6 within
    # 8 iterations and take other steps within ~16 (printed below), so two
    # correct orders of the same sums part after that.  The gate (rtol
    # 1e-9, the same steps) holds the first 6 iterations (20 states, the
    # switch to the high temperature at 4), the horizon of the CPU parity
    # test against the JAX package; the 30-iteration runs are printed
    # beside the plain path's own sensitivity.
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    short = replace(cfg, niters=6, niters_lowtemp=4)
    g8c = planner_problem(f64, torch.device("cpu"), 1)[0]
    s8 = subset(inits64, 8)
    s8c = GaussianState(s8.mu.cpu(), BlockTridiag(
        s8.precision.diag.cpu(), s8.precision.off.cpu()))
    _, hk = optimize(graph64, s8, short)
    _, hs = optimize(graph64, s8, replace(short, fused_trials="off",
                                          fused_gradient="off"))
    _, hp = optimize(graph64, s8, replace(short, chain_impl="seq",
                                          quad_impl="xla"))
    _, hc = optimize(g8c, s8c, replace(short, fused_trials="on",
                                       fused_gradient="on"))
    for name, got, want in (
            ("fused kernels vs plain path", hk, hp),
            ("separate kernels vs plain path", hs, hp),
            ("fused kernels vs fused plain versions (CPU)", hk, hc)):
        held_to_plain(f"planner {name}", got, want, dev)

    def apart(a, b):
        rel = ((a.cost - b.cost).abs() / b.cost.abs()).max(0).values
        steps = int((a.accepted_step != b.accepted_step).any(0).sum())
        return rel, steps

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    nudged = GaussianState(s8.mu * (1 + 1e-15 * torch.randn(
        s8.mu.shape, generator=gen, dtype=f64, device=dev)), s8.precision)
    _, hk30 = optimize(graph64, s8, cfg)
    _, hp30 = optimize(graph64, s8, cfg_plain)
    _, hn30 = optimize(graph64, nudged, cfg_plain)
    for name, (rel, steps) in (
            ("fused kernels vs plain path", apart(hk30, hp30)),
            ("plain path vs itself from means nudged by 1e-15",
             apart(hn30, hp30))):
        check(bool(torch.isfinite(rel).all()), f"planner {name}: non-finite")
        print(f"[planner end to end] {name} (f64, 8 restarts, {PLAN_ITERS} "
              f"iters): max relative cost difference at iterations 6 / 8 / "
              f"16 / last {rel[5]:.1e} / {rel[7]:.1e} / {rel[15]:.1e} / "
              f"{rel[-1]:.1e}, max {rel.max().item():.1e}; steps differ at "
              f"{steps}/{PLAN_ITERS} iterations", flush=True)

    plain = subset(inits32, PLAN_B_PLAIN)
    rates = {"fused": rate(lambda: optimize(graph32, inits32, cfg),
                           PLAN_B * PLAN_ITERS),
             "separate": rate(lambda: optimize(graph32, inits32, cfg_sep),
                              PLAN_B * PLAN_ITERS),
             "plain": rate(lambda: optimize(graph32, plain, cfg_plain),
                           PLAN_B_PLAIN * PLAN_ITERS, runs=1)}
    print(f"[throughput] {card}: planar planner fused {rates['fused']:.1f}, "
          f"separate {rates['separate']:.1f} prob-iters/s (B={PLAN_B}, "
          f"N={PLAN_N}, {PLAN_ITERS} iters, f32, median of 3); plain PyTorch "
          f"{rates['plain']:.1f} prob-iters/s (B={PLAN_B_PLAIN}, one run)",
          flush=True)
    return {"fused": fused_counts, "separate": sep_counts}, rates


# ---- s = 6: the 3-D point and quadrotor planners, chain estimation at
# dim_x = 3 ------------------------------------------------------------------
# build_point3d_planning's own config: N = 20 states of dim 6, a 50^3 field,
# the 25-node 3-D marginal rule of degree 3, 30 iterations (20 at
# temperature 0.1, then 1.0); build_quadrotor_planning's: N = 12, the
# 7-node (3, 2) pose-marginal rule, a 120 x 120 planar field, 20
# iterations; chain estimation at dim_x = 3: the flagship's N = 32 and
# degree 4 (the 69-node (3, 4) marginal rule), 10 iterations.  B = 1024
# restarts (perturb_inits, mean_scale 0.3) or problems; not cut.
S6_B = 1024
S6_B_PLAIN = 64
P3_N, P3_ITERS = 20, 30
QR_N, QR_ITERS = 12, 20
# operations of one 3-D SDF cost evaluation (clip, three divisions, three
# floors, the eight-corner blend, the hinge); its eight gathers hit L2
SDF3D_COST_OPS = 55


def point3d_problem(dtype, dev, count=None):
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )

    return restarts(build_point3d_planning, dtype, dev, count or S6_B)


def quadrotor_problem(dtype, dev, count=None):
    from gaussianvi_tpu_torch.examples.quadrotor_planning import (
        build_quadrotor_planning,
    )

    return restarts(build_quadrotor_planning, dtype, dev, count or S6_B)


def plain_iterate(graph, state, config):
    """The float64 iterate five plain NGD iterations reach:
    ``(mu, prec_diag, prec_off)``."""
    from gaussianvi_tpu_torch import optimize

    state, _ = optimize(graph, state, replace(
        config, niters=5, niters_lowtemp=5, chain_impl="seq",
        quad_impl="xla"))
    return state.mu, state.precision.diag, state.precision.off


def s6_models(dev):
    """The two models whose kernels run at s = 6 with a cost functor, at
    their real iterates (float64, five plain iterations): ``{name: (graphs
    by dtype, iterate, cost, cost operations)}``.  Four of the point
    planner's restarts are moved to where the 3-D cost's clamps act: on
    the field's last x, y and z planes, and off the field; a fifth onto
    grid nodes."""
    from gaussianvi_tpu_torch import GVIConfig
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f32, f64 = torch.float32, torch.float64
    g64, s64 = build_batch(f64, dev, S6_B, dim_x=3)
    dx3 = {f32: build_batch(f32, dev, S6_B, dim_x=3)[0], f64: g64}
    it_dx3 = plain_iterate(g64, s64, GVIConfig(step_size_base=0.9))
    p3 = {dt: _batch_graph(point3d_problem(dt, dev, 1)[0], S6_B)
          for dt in (f32, f64)}
    g64, inits, config, _ = point3d_problem(f64, dev)
    mu, pd, po = plain_iterate(g64, inits, config)
    mu = mu.clone()
    cell = 10.0 / 49
    for r, axis in ((1, 0), (2, 1), (3, 2)):
        mu[r, :, axis] = 10.0
    mu[4, :, :3] += torch.tensor([-15.0, 14.0, 3.0], dtype=mu.dtype,
                                 device=dev)
    mu[5, :, :3] = torch.round(mu[5, :, :3] / cell) * cell
    return {"dim_x=3": (dx3, it_dx3, "range", None),
            "point3d": (p3, (mu, pd, po), "sdf3d", SDF3D_COST_OPS)}


def s6_kernel_checks(dev):
    """Every kernel at s = 6 against its plain version on the card, at the
    shapes of chain estimation at dim_x = 3 (B = 1024, N = 32, the range
    cost on 69 nodes) and of the point planner (1024 restarts, N = 20, the
    3-D SDF cost on 25 nodes): K1 on the trial batch and K2 on the solve
    pair on well-conditioned chains (float64 atol 1e-10, float32 rtol
    1e-4 / atol 1e-6); K3 (both variants), K4 (dim_x = 3: the block-form
    path's), K5 and K6 ``full`` at the model's real iterate, float64 by
    :func:`compare_conditioned` and float32 by :func:`compare_vs_f64`, K6's
    main solve by its backward error; each launched twice for the same
    bits, K4 = K3 moments bit for bit; on the point planner the exact-zero
    E[phi] where the plain version has them.  Times each kernel in
    float32: ``{(model, name): row}``."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import chain, quad
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_moments as fm
    from gaussianvi_tpu_torch.kernels import fused_trials as ft
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 6)
    out = {}
    for model, (graphs, it64, cost, cost_ops) in s6_models(dev).items():
        n = it64[0].shape[1]
        field = graphs[f64].nonlinear[0].kernel_field
        # K1 on the trial batch and K2 on the pair: well-conditioned chains
        chains = {}
        for dt in (f64, f32):
            d1, o1, _ = spd_chains(TRIALS * S6_B, n, 6, rng, dt, dev)
            d2, o2, rhs = spd_chains(2 * S6_B, n, 6, rng, dt, dev)
            chains[dt] = ((d1.reshape(TRIALS, S6_B, n, 6, 6),
                           o1.reshape(TRIALS, S6_B, n - 1, 6, 6)),
                          (d2[:S6_B], o2[:S6_B], d2[S6_B:], o2[S6_B:],
                           rhs[:S6_B]))
        errs = {}
        for dt in (f64, f32):
            tol = (1e-10, 1e-10) if dt == f64 else (1e-4, 1e-6)
            tol_ld = (0.0, 1e-10) if dt == f64 else (1e-5, 0.0)
            k1 = check_repeatable(f"{model} K1 {dt}", lambda dt=dt:
                                  chain.gbp_covariance_logdet_lanes(
                                      *chains[dt][0]))
            p1 = chain.gbp_covariance_logdet_plain(*chains[dt][0])
            errs["gbp_covariance_logdet", dt] = max(
                compare(f"{model} K1 cov_diag {dt}", k1[0], p1[0], *tol),
                compare(f"{model} K1 cov_off {dt}", k1[1], p1[1], *tol),
                compare(f"{model} K1 logdet {dt}", k1[2], p1[2], *tol_ld))
            k2 = check_repeatable(f"{model} K2 {dt}", lambda dt=dt:
                                  chain.solve_pair_lanes(*chains[dt][1]))
            errs["solve", dt] = max(
                compare(f"{model} K2 x{i} {dt}", a, b_, *tol)
                for i, (a, b_) in enumerate(zip(
                    k2, chain.solve_pair_plain(*chains[dt][1]))))
        # K3, K4, K5, K6 at the model's iterate
        cd64 = gbp_covariance_logdet(BlockTridiag(*it64[1:]))[0]
        jitter = torch.tensor(0.05 * rng.standard_normal(
            (TRIALS, S6_B, n, 6)), dtype=f64, device=dev)
        args3, args4, x5, x6, ops = {}, {}, {}, {}, {}
        for dt in (f64, f32):
            fb = graphs[dt].nonlinear[0]
            mu, pd, po = (x.to(dt) for x in it64)
            cd = cd64.to(dt)
            args3[dt] = ((mu + jitter.to(dt)).contiguous(),
                         cd.expand(TRIALS, *cd.shape).contiguous(), fb.nodes,
                         fb.weights, cost, fb.kernel_params)
            args4[dt] = (mu, cd, fb.nodes, fb.weights, cost, fb.kernel_params)
            ops[dt] = fused_operands(graphs[dt])
            x6[dt] = (mu, pd, po, torch.full((S6_B,), 0.1, dtype=dt,
                                             device=dev))
        p6 = fg.gradient_plain(*x6[f64], *ops[f64])
        finite = torch.isfinite(p6[5]).flatten(1).all(1)
        direction = (torch.where(finite[:, None, None], p6[5], p6[6]),
                     p6[3], p6[4])
        for dt in (f64, f32):
            dmu, dpd, dpo = (x.to(dt) for x in direction)
            trials = 0.9 * 0.75 ** torch.arange(1, TRIALS + 1, dtype=dt,
                                                device=dev)
            mu, pd, po, _ = x6[dt]
            x5[dt] = (mu, dmu, pd, po, dpd, dpo, trials)
        fields = {dt: graphs[dt].nonlinear[0].kernel_field
                  for dt in (f64, f32)}
        rdim = graphs[f64].nonlinear[0].quad_rdim
        # the split pair as a dp = 1 x fp = 2 mesh's ranks run it: accum on
        # each half of the factors, solve on the float64 plain sum of the
        # halves (both dtypes get the same seeds)
        halves = {dt: [half_operands(graphs[dt], i) for i in (0, 1)]
                  for dt in (f64, f32)}
        lin = {dt: (ops[dt][1], ops[dt][3]) for dt in (f64, f32)}

        def accum_plain(dt, i):
            specs, arrays = halves[dt][i]
            return fg.gradient_plain(*x6[dt], specs, (), arrays, (),
                                     mode="accum")

        seeds = {f64: tuple(a + b_ for a, b_ in zip(accum_plain(f64, 0),
                                                    accum_plain(f64, 1)))}
        seeds[f32] = tuple(t.to(f32) for t in seeds[f64])

        def flat5(o):
            return (o[0], *o[1])

        cases = {
            "quad_phi": (
                lambda dt: (quad.quad_lanes_phi(*args3[dt], nonneg=True,
                                                field=fields[dt]),),
                lambda dt: (quad.quad_phi_plain(*args3[dt], nonneg=True,
                                                field=fields[dt]),)),
            "quad_moments": (
                lambda dt: quad.quad_lanes_moments(*args4[dt], rdim=rdim,
                                                   field=fields[dt]),
                lambda dt: quad.quad_moments_plain(*args4[dt], rdim=rdim,
                                                   field=fields[dt])),
            "fused_trials": (
                lambda dt: flat5(ft.trial_costs_lanes(*x5[dt], *ops[dt])),
                lambda dt: flat5(ft.trial_costs_plain(*x5[dt], *ops[dt]))),
            "fused_gradient": (
                lambda dt: fg.gradient_lanes(*x6[dt], *ops[dt]),
                lambda dt: fg.gradient_plain(*x6[dt], *ops[dt])),
        }
        if model == "dim_x=3":
            def k4(dt):
                a = args4[dt]
                return fm.fused_moments(a[2], a[3], a[0], a[1], cost, a[5],
                                        rdim=rdim)

            def p4(dt):
                mu, cd, nodes, weights, _, par = args4[dt]
                got = fm.fused_moments_plain(
                    nodes, weights, mu.reshape(-1, 6), cd.reshape(-1, 6, 6),
                    quad.KERNEL_COSTS[cost][1], (par.reshape(-1, 5),), rdim)
                return tuple(x.reshape(y.shape) for x, y in zip(
                    got, (mu[..., 0], mu, cd)))

            cases["fused_moments"] = (k4, p4)
        cases["fused_gradient_accum"] = (
            lambda dt: (*fg.gradient_accum_lanes(*x6[dt], *halves[dt][0]),
                        *fg.gradient_accum_lanes(*x6[dt], *halves[dt][1])),
            lambda dt: (*accum_plain(dt, 0), *accum_plain(dt, 1)))
        cases["fused_gradient_solve"] = (
            lambda dt: fg.gradient_solve_lanes(*x6[dt], seeds[dt], *lin[dt]),
            lambda dt: fg.gradient_plain(*x6[dt], (), lin[dt][0], (),
                                         lin[dt][1], mode="solve",
                                         seeds=seeds[dt]))
        solve, kept = {}, {}
        for name, (kern, plain) in cases.items():
            k = {dt: check_repeatable(f"{model} {name} {dt}",
                                      lambda dt=dt, kern=kern: kern(dt))
                 for dt in (f64, f32)}
            p = {dt: plain(dt) for dt in (f64, f32)}
            kept[name] = k, p
            held64 = list(zip(k[f64], p[f64], p[f32]))
            held32 = list(zip(k[f32], p[f32], p[f64]))
            if name in ("fused_gradient", "fused_gradient_solve"):
                # dmu by its backward error in the float64 plain system
                # Vddmu = dprec + Lambda
                tag = "" if name == "fused_gradient" else " solve"
                vdd = (p[f64][3] + x6[f64][1], p[f64][4] + x6[f64][2])
                solve["backward" + tag], solve["forward" + tag] = (
                    compare_backward(f"{model} K6{tag} dmu float64",
                                     k[f64][5], p[f64][5], *vdd))
                solve["backward32" + tag] = compare_backward_vs_f64(
                    f"{model} K6{tag} dmu float32", k[f32][5], p[f32][5],
                    p[f64][5], *vdd)
                solve["indefinite"] = int((~finite).sum())
                held64 = held64[:5] + held64[6:]
                held32 = held32[:5] + held32[6:]
            if name == "fused_moments":
                k3 = cases["quad_moments"][0]
                for dt in (f64, f32):
                    check(all(same_bits(a, b_) for a, b_ in zip(k[dt],
                                                                k3(dt))),
                          f"{model} K4 {dt}: not K3 moments' bits")
            errs[name, f64] = max(
                compare_conditioned(f"{model} {name}[{i}] float64", a, b_, c)
                for i, (a, b_, c) in enumerate(held64))
            errs[name, f32] = max(
                compare_vs_f64(f"{model} {name}[{i}] float32", a, b_, c)
                for i, (a, b_, c) in enumerate(held32))
            if model == "point3d" and name in ("quad_phi", "quad_moments",
                                               "fused_trials",
                                               "fused_moments"):
                at = 1 if name == "fused_trials" else 0
                got, want = k[f64][at], p[f64][at]
                check(torch.equal(got == 0, want == 0)
                      and bool((want == 0).any()) and bool((want > 0).any()),
                      f"{model} {name}: exact zeros differ from the plain "
                      f"version's ({int((got == 0).sum())} vs "
                      f"{int((want == 0).sum())})")
                solve[f"zeros {name}"] = (int((want == 0).sum()),
                                          want.numel())
        # the pair (accum on each half, summed, solve) against the full
        # kernel: equal up to the reassociation of one sum; dmu by its
        # backward error
        for dt in (f64, f32):
            total = fg.gradient_accum_lanes(*x6[dt], *halves[dt][0])
            total.buffer.add_(fg.gradient_accum_lanes(
                *x6[dt], *halves[dt][1]).buffer)
            kept["pair", dt] = fg.gradient_solve_lanes(*x6[dt], total,
                                                       *lin[dt])
        full_k, full_p = kept["fused_gradient"]
        pair64 = list(zip(kept["pair", f64], full_k[f64], full_p[f32]))
        errs["pair vs full", f64] = max(
            compare_conditioned(f"{model} K6 pair vs full[{i}] float64", a,
                                b_, c)
            for i, (a, b_, c) in enumerate(pair64) if i != 5)
        errs["pair vs full", f32] = max(
            compare_vs_f64(f"{model} K6 pair vs full[{i}] float32", a, b_, c)
            for i, (a, b_, c) in enumerate(zip(
                kept["pair", f32], full_k[f32], full_p[f64])) if i != 5)
        vdd = (full_p[f64][3] + x6[f64][1], full_p[f64][4] + x6[f64][2])
        solve["backward pair"], _ = compare_backward(
            f"{model} K6 pair dmu float64", kept["pair", f64][5],
            full_k[f64][5], *vdd)
        names = ("gbp_covariance_logdet", "solve", *cases, "pair vs full")
        print(f"[s=6 kernels, {model}] max abs err vs plain, f64 / f32 (two "
              f"launches bit-identical each): " + "; ".join(
                  f"{nm} {errs[nm, f64]:.3e} / {errs[nm, f32]:.3e}"
                  for nm in names)
              + f"; K6 dmu backward error f64 {solve['backward']:.3e} (max "
              f"abs difference {solve['forward']:.3e}), f32 "
              f"{solve['backward32']:.3e}; K6 solve's {solve['backward solve']:.3e}"
              f" / {solve['backward32 solve']:.3e}, the pair's (vs full) "
              f"{solve['backward pair']:.3e}; Vddmu indefinite on "
              f"{solve['indefinite']}/{S6_B}" + "".join(
                  f"; {k} exact {v[0]}/{v[1]}" for k, v in solve.items()
                  if k.startswith("zeros")), flush=True)

        m = graphs[f32].nonlinear[0].nodes.shape[0]
        cost_kw = {} if cost_ops is None else dict(cost=cost_ops)
        q = dict(d=6, m=m, dx=3, **cost_kw)
        work = {
            "gbp_covariance_logdet": TRIALS * S6_B * n * chain_flops(6),
            "solve": 2 * S6_B * n * solve_flops(6),
            "quad_phi": TRIALS * S6_B * n * quad_flops(moments=False, **q),
            "quad_moments": S6_B * n * quad_flops(moments=True, **q),
            "fused_moments": S6_B * n * quad_flops(moments=True, **q),
            "fused_trials": TRIALS * S6_B * n * (
                chain_flops(6) + quad_flops(moments=False, **q) + 16 * 6**2),
            "fused_gradient": S6_B * n * (
                chain_flops(6) + quad_flops(moments=True, **q) + 12 * 6**3
                + 2 * solve_flops(6)),
            # per problem both sweeps with the edge blocks, then the
            # moments and the assembly of the half's factors; solve: the
            # sweeps again and both solves
            "fused_gradient_accum": S6_B * (
                n * chain_flops(6) + halves[f32][0][0][0].k * (
                    quad_flops(moments=True, **q) + 12 * 6**3)),
            "fused_gradient_solve": S6_B * n * (chain_flops(6)
                                                + 2 * solve_flops(6)),
        }
        extra = () if fields[f32] is None else (fields[f32],)
        inputs = {"gbp_covariance_logdet": chains[f32][0],
                  "solve": chains[f32][1],
                  "quad_phi": args3[f32][:4] + args3[f32][5:] + extra,
                  "quad_moments": args4[f32][:4] + args4[f32][5:] + extra,
                  "fused_moments": args4[f32][:4] + args4[f32][5:],
                  "fused_trials": (x5[f32], ops[f32][2:]),
                  "fused_gradient": (x6[f32], ops[f32][2:]),
                  "fused_gradient_accum": (x6[f32], halves[f32][0][1]),
                  "fused_gradient_solve": (x6[f32], seeds[f32],
                                           lin[f32][1])}
        calls = {
            "gbp_covariance_logdet": (
                lambda: chain.gbp_covariance_logdet_lanes(*chains[f32][0]),
                lambda: chain.gbp_covariance_logdet_plain(*chains[f32][0])),
            "solve": (lambda: chain.solve_pair_lanes(*chains[f32][1]),
                      lambda: chain.solve_pair_plain(*chains[f32][1])),
            **{name: (lambda kern=kern: kern(f32),
                      lambda plain=plain: plain(f32))
               for name, (kern, plain) in cases.items()},
            # a rank's accum: one half of the factors
            "fused_gradient_accum": (
                lambda: fg.gradient_accum_lanes(*x6[f32], *halves[f32][0]),
                lambda: accum_plain(f32, 0)),
        }
        for name, (kern, plain) in calls.items():
            out[model, name] = dict(
                max_abs_err=errs[name, f64], err_dtype="float64",
                ms=cuda_ms(kern), ms_flushed_l2=cuda_ms_flushed(kern),
                plain_ms=cuda_ms(plain, reps=1),
                **bound(inputs[name], kern(), work[name]))
        out[model, "solve"]["library_ms"] = dense_solve_ms(chains[f32][1])
        print(f"[s=6 ptxas] {model}: " + "; ".join(
            f"{name} {out[model, name]['ms']:.4f} ms "
            f"({out[model, name]['ms_flushed_l2']:.4f} flushed), "
            + s6_ptxas(name, cost) for name in (
                "fused_trials", "fused_gradient", "fused_gradient_accum",
                "fused_gradient_solve"))
            + " (f32 times; registers, spill stores + loads, f32 / f64)",
            flush=True)
    return out


# K6's modes as its kernels' template argument (csrc/fused_gradient.cuh
# GradMode)
GRAD_MODES = {"full": 0, "accum": 1, "solve": 2}
# K5 / K6 at s = 6: the wrapper and its K6 mode (None: K5)
S6_MODES = {"fused_trials": None, "fused_gradient": "full",
            "fused_gradient_accum": "accum", "fused_gradient_solve": "solve"}


def s6_ptxas(name, cost):
    """``"layout R / R regs, spill a+b / a+b B"``: the layout (lane
    ``groups`` or a ``lane`` an edge) and what ptxas says of the s = 6
    instance of K5 or a mode of K6 with ``cost`` (mode "solve" runs the
    range cost's instance whatever the model's), float32 / float64."""
    from gaussianvi_tpu_torch.kernels import _build
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg

    mode = S6_MODES[name]
    cost = "range" if mode == "solve" else cost
    report = _build.ptxas_report()
    found = []
    for size, dtype in ((4, "float32"), (8, "float64")):
        if mode is None:    # K5 at s = 6: always the lane groups
            groups, kernel = True, "trials_s6_kernel"
        else:
            groups = fg.grad_groups(6, size, cost, mode)
            kernel = "grad_s6_kernel" if groups else "grad_kernel"
        rows = [r for r in report
                if r["kernel"] == kernel and r["dtype"] == dtype
                and r["cost"] == cost and r["ints"][0] == 6
                and (mode is None or r["ints"][-1] == GRAD_MODES[mode])]
        check(len(rows) == 1, f"ptxas lists {len(rows)} {kernel} {cost} "
              f"{dtype} instances at s = 6, not one")
        found.append(("groups" if groups else "lane", rows[0]))
    (lf, f), (ld, d) = found
    return (f"{lf} / {ld}, {f['registers']} / {d['registers']} regs, spill "
            f"{f['spill_stores']}+{f['spill_loads']} / "
            f"{d['spill_stores']}+{d['spill_loads']} B")


def f32_vs_f64(name, hist32, hist64, final0):
    """float32 against float64: every problem's first record (< 1e-4),
    the batch median of the final costs (< 1e-3) and problem 0's final
    cost (< ``final0``).  Problem 0's history is printed, not held: at
    s = 6 float32 takes other line-search steps than float64 on it in the
    JAX package too (dim_x = 3 seed 0 5.3e-2 apart at iteration 5 and
    2.0e-3 at the end, the quadrotor's final cost 1.3e-3 apart, the point
    planner 9e-4 to 0.40 apart from means nudged by 1e-7;
    tests/test_torch_point3d.py test_float32_steps_differ_in_jax), so
    ``final0`` is 1e-3 where JAX ends within it (the point planner) and
    1e-2 where it ends 1e-3 to 2e-3 apart."""
    rel = ((hist32.cost.double() - hist64.cost).abs()
           / hist64.cost.abs().clamp_min(1e-12))
    first, seed0 = rel[:, 0].max().item(), rel[0].max().item()
    median, last0 = rel[:, -1].median().item(), rel[0, -1].item()
    print(f"[{name}] f32 vs f64 relative cost difference: first record max "
          f"{first:.3e}, final median {median:.3e}, problem-0 final "
          f"{last0:.3e} (problem-0 history max {seed0:.3e}, final max "
          f"{rel[:, -1].max().item():.3e})", flush=True)
    check(first < 1e-4, f"{name}: first-record f32 vs f64 {first:.3e}")
    check(median < 1e-3, f"{name}: median final f32 vs f64 {median:.3e}")
    check(last0 < final0, f"{name}: problem-0 final f32 vs f64 {last0:.3e}")


def s6_runs(card, dev):
    """The three s = 6 models through ``optimize`` under the defaults on
    the card, each path counted: the point planner fused and separate at
    B = 1024 (plain at B = 64), the quadrotor on K1 / K2 at B = 1024
    (plain at B = 64), chain estimation at dim_x = 3 fused and block-form
    at B = 1024; float32 against float64; the kernel paths against the
    plain path on 8 problems in float64; the planners' own checks
    (``tests/test_sdf_io.py``, ``tests/test_quadrotor.py``); throughput.
    Returns ``(counts per path, rates)``."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.factors.robots import planar_quad_balls
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    f32, f64 = torch.float32, torch.float64
    counts, rates = {}, {}

    def path_rate(graph, state, config, iters, runs=3):
        return rate(lambda: optimize(graph, state, config),
                    state.mu.shape[0] * iters, runs)

    def plain_of(config):
        return replace(config, chain_impl="seq", quad_impl="xla")

    def on_cpu(state):
        return GaussianState(state.mu.cpu(), BlockTridiag(
            state.precision.diag.cpu(), state.precision.off.cpu()))

    # ---- the 3-D point planner ----
    graph32, inits32, cfg, sdf = point3d_problem(f32, dev)
    graph64, inits64, _, _ = point3d_problem(f64, dev)
    cfg_sep = replace(cfg, fused_trials="off", fused_gradient="off")
    (state32, hist32), counts["point3d fused"] = counted(
        optimize, graph32, inits32, cfg)
    n = counts["point3d fused"]
    print(f"[point3d fused path] launches {n}", flush=True)
    check(n["fused_trials"] == n["fused_gradient"] == P3_ITERS
          and n["gbp_covariance_logdet"] > 0 and n["quad_phi"] > 0,
          f"point3d: the fused path skipped its kernels: {n}")
    check_costs("point3d fused path", hist32, S6_B, P3_ITERS, nonneg=True)
    pos = state32.mu[0, :, :3]
    clearance = float(sdf.signed_distance(pos).min())
    ends = max(float((pos[0] - torch.tensor([1.0, 1.0, 4.5], device=dev))
                     .abs().max()),
               float((pos[-1] - torch.tensor([8.5, 8.5, 4.5], device=dev))
                     .abs().max()))
    clear = int((sdf.signed_distance(state32.mu[..., :3]).amin(-1) > 0).sum())
    print(f"[point3d fused path] restart 0 clears the box by {clearance:.4f}"
          f", endpoints within {ends:.3e}; {clear}/{S6_B} restarts end "
          f"clear; final cost median "
          f"{float(hist32.cost[:, -1].median()):.4f}", flush=True)
    check(clearance > 0.0, f"point3d: restart 0 ends in the box "
          f"({clearance:.3e})")
    check(ends < 0.2, f"point3d: restart 0's endpoints off by {ends:.3e}")
    _, hist64 = optimize(graph64, inits64, cfg)
    f32_vs_f64("point3d fused path", hist32, hist64, 1e-3)
    (_, hist_s), counts["point3d separate"] = counted(
        optimize, graph32, inits32, cfg_sep)
    n = counts["point3d separate"]
    print(f"[point3d separate path] launches {n}", flush=True)
    check(all(n[k] > 0 for k in ("gbp_covariance_logdet", "solve",
                                 "quad_phi", "quad_moments"))
          and n["fused_trials"] == n["fused_gradient"] == 0,
          f"point3d: the separate path skipped a kernel: {n}")
    check_costs("point3d separate path", hist_s, S6_B, P3_ITERS, nonneg=True)

    took("point planner runs at B = 1024")
    # kernel paths against the plain path (float64, 8 restarts) over the
    # whole run: the point planner keeps rounding in check (its plain
    # path's costs from means nudged by 1e-15, printed beside, stay within
    # ~2e-11 over the 30 iterations), unlike the planar planner
    s8 = subset(inits64, 8)
    g8c = point3d_problem(f64, torch.device("cpu"), 1)[0]
    hp = optimize(graph64, s8, plain_of(cfg))[1]
    hk = optimize(graph64, s8, cfg)[1]
    for name, got, want in (
            ("point3d fused kernels vs plain path", hk, hp),
            ("point3d separate kernels vs plain path",
             optimize(graph64, s8, cfg_sep)[1], hp),
            ("point3d fused kernels vs fused plain versions (CPU)", hk,
             optimize(g8c, on_cpu(s8), replace(
                 cfg, fused_trials="on", fused_gradient="on"))[1])):
        held_to_plain(name, got, want, dev, tag="s=6 end to end")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    nudged = GaussianState(s8.mu * (1 + 1e-15 * torch.randn(
        s8.mu.shape, generator=gen, dtype=f64, device=dev)), s8.precision)
    hn = optimize(graph64, nudged, plain_of(cfg))[1]
    for name, a, b_ in (("fused kernels vs plain path", hk, hp),
                        ("plain path vs itself from means nudged by 1e-15",
                         hn, hp)):
        rel = ((a.cost - b_.cost).abs() / b_.cost.abs()).max(0).values
        steps = int((a.accepted_step != b_.accepted_step).any(0).sum())
        check(bool(torch.isfinite(rel).all()), f"point3d {name}: non-finite")
        print(f"[point3d end to end] {name} (f64, 8 restarts, {P3_ITERS} "
              f"iters): max relative cost difference at iterations 6 / 10 / "
              f"20 / last {rel[5]:.1e} / {rel[9]:.1e} / {rel[19]:.1e} / "
              f"{rel[-1]:.1e}, max {rel.max().item():.1e}; steps differ at "
              f"{steps}/{P3_ITERS} iterations", flush=True)
    took("point planner end to end")
    rates["point3d fused"] = path_rate(graph32, inits32, cfg, P3_ITERS)
    rates["point3d separate"] = path_rate(graph32, inits32, cfg_sep,
                                          P3_ITERS)
    rates["point3d plain"] = path_rate(graph32, subset(inits32, S6_B_PLAIN),
                                       plain_of(cfg), P3_ITERS, runs=1)

    took("point planner paths")
    # ---- the planar quadrotor ----
    graph32, inits32, qcfg, qsdf = quadrotor_problem(f32, dev)
    graph64, inits64, _, _ = quadrotor_problem(f64, dev)
    (state32, hist32), counts["quadrotor"] = counted(
        optimize, graph32, inits32, qcfg)
    n = counts["quadrotor"]
    print(f"[quadrotor path] launches {n}", flush=True)
    check(n["gbp_covariance_logdet"] > 0 and n["solve"] == QR_ITERS
          and n["quad_phi"] == n["quad_moments"] == n["fused_trials"]
          == n["fused_gradient"] == 0,
          f"quadrotor: not K1 / K2 with the plain quadrature: {n}")
    check_costs("quadrotor path", hist32, S6_B, QR_ITERS, nonneg=True)
    cost0 = hist32.cost[0].double()
    balls = planar_quad_balls(state32.mu[0], 5, 5.0, 1.0)
    clearance = float(qsdf.signed_distance(balls.reshape(-1, 2)).min())
    print(f"[quadrotor path] restart 0: balls clear by {clearance:.4f}, cost "
          f"{float(cost0[0]):.2f} -> {float(cost0[-1]):.2f}", flush=True)
    check(clearance > 0.0, f"quadrotor: restart 0's balls in the block "
          f"({clearance:.3e})")
    check(float(cost0[-1]) < float(cost0[0]) / 10,
          f"quadrotor: restart 0's cost fell only to {float(cost0[-1]):.3e}")
    _, hist64 = optimize(graph64, inits64, qcfg)
    f32_vs_f64("quadrotor path", hist32, hist64, 1e-2)
    s8 = subset(inits64, 8)
    held_to_plain("quadrotor chain kernels vs plain path",
                  optimize(graph64, s8, qcfg)[1],
                  optimize(graph64, s8, plain_of(qcfg))[1], dev,
                  tag="s=6 end to end")
    rates["quadrotor"] = path_rate(graph32, inits32, qcfg, QR_ITERS)
    rates["quadrotor plain"] = path_rate(graph32, subset(inits32, S6_B_PLAIN),
                                         plain_of(qcfg), QR_ITERS, runs=1)

    took("quadrotor path")
    # ---- chain estimation at dim_x = 3 ----
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    cfg_block = replace(cfg, use_pallas=True, fused_gradient="off")
    graph32, state32 = build_batch(f32, dev, S6_B, dim_x=3)
    graph64, state64 = build_batch(f64, dev, S6_B, dim_x=3)
    (_, hist32), counts["dim_x=3 fused"] = counted(
        optimize, graph32, state32, cfg)
    n = counts["dim_x=3 fused"]
    print(f"[dim_x=3 fused path] launches {n}", flush=True)
    check(n["fused_trials"] == n["fused_gradient"] == NITERS
          and n["gbp_covariance_logdet"] > 0 and n["quad_phi"] > 0,
          f"dim_x=3: the fused path skipped its kernels: {n}")
    check_costs("dim_x=3 fused path", hist32, S6_B, NITERS)
    f32_vs_f64("dim_x=3 fused path", hist32,
               optimize(graph64, state64, cfg)[1], 1e-2)
    (_, hist_a), counts["dim_x=3 block"] = counted(
        optimize, graph32, state32, cfg_block)
    n = counts["dim_x=3 block"]
    print(f"[dim_x=3 block-moments path] launches {n}", flush=True)
    check(n["fused_moments"] == n["solve"] == n["fused_trials"] == NITERS
          and n["fused_gradient"] == n["quad_moments"] == 0,
          f"dim_x=3: the block-form moments path took other kernels: {n}")
    check_costs("dim_x=3 block-moments path", hist_a, S6_B, NITERS)
    g8, s8 = build_batch(f64, dev, 8, dim_x=3)
    g8c, s8c = build_batch(f64, torch.device("cpu"), 8, dim_x=3)
    hp = optimize(g8, s8, plain_of(cfg))[1]
    hk = optimize(g8, s8, cfg)[1]
    hs = optimize(g8, s8, replace(cfg, fused_trials="off",
                                  fused_gradient="off"))[1]
    for name, got, want in (
            ("dim_x=3 fused kernels vs plain path", hk, hp),
            ("dim_x=3 separate kernels vs plain path", hs, hp),
            ("dim_x=3 block-form moments vs separate kernels",
             optimize(g8, s8, cfg_block)[1], hs),
            ("dim_x=3 fused kernels vs fused plain versions (CPU)", hk,
             optimize(g8c, s8c, replace(cfg, fused_trials="on",
                                        fused_gradient="on"))[1])):
        held_to_plain(name, got, want, dev, tag="s=6 end to end")
    rates["dim_x=3 fused"] = path_rate(graph32, state32, cfg, NITERS)
    print(f"[throughput] {card}: point3d fused {rates['point3d fused']:.1f}, "
          f"separate {rates['point3d separate']:.1f} prob-iters/s (B={S6_B}, "
          f"N={P3_N}, {P3_ITERS} iters), plain {rates['point3d plain']:.1f} "
          f"(B={S6_B_PLAIN}); quadrotor (K1 / K2) {rates['quadrotor']:.1f} "
          f"(B={S6_B}, N={QR_N}, {QR_ITERS} iters), plain "
          f"{rates['quadrotor plain']:.1f} (B={S6_B_PLAIN}); dim_x=3 fused "
          f"{rates['dim_x=3 fused']:.1f} (B={S6_B}, N={N}, {NITERS} iters); "
          f"f32, median of 3, plain one run", flush=True)
    return counts, rates


ARM_B, ARM_ITERS = 1024, 15     # the arm planner's restarts, iterations
ARM_B_PLAIN = 64
# operations of one arm cost evaluation (csrc/costs.cuh ArmSdfCost): a
# joint 66 (the angle's sine and cosine, the transform's products), a
# sphere 75 (its center 18, the 3-D lookup and hinge 55, the sum 2)
ARM_COST_OPS = 7 * 66 + 7 * 75
# the float32 guard may poison a restart's first E[phi] (NaN from the
# first record on, as in the JAX package in float32): at most this share
ARM_POISON_MAX = 0.05


def arm_problem(dtype, dev, count=None):
    """``(graph, restarts, config, (fk, sdf))`` of the 7-DOF arm planner
    (:func:`restarts`)."""
    from gaussianvi_tpu_torch.examples.arm_planning import build_arm_planning

    return restarts(build_arm_planning, dtype, dev, count or ARM_B)


def golden_1d():
    """The reference's golden 1-D trajectories, ``REF_*`` of
    ``tests/test_golden_1d.py``, read as literals (that module imports the
    JAX package)."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_golden_1d.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and node.targets[0].id.startswith("REF_")}


def wide_kernel_checks(dev):
    """K1 and K2 at s = 14 (the arm planner's shapes: 11 x 1024 chains of
    N = 10 for K1, the pair of 1024 systems for K2) and at s = 1 (11 x 1024
    one-state chains and the pair of 1024: a batch of Barfoot problems)
    against their plain versions on the card: well-conditioned chains
    (float64 atol 1e-10, float32 rtol 1e-4 / atol 1e-6), and at s = 14 the
    arm's real iterate too (five plain float64 iterations on the 1024
    restarts: K1 on its precision, K2 on it and its unit shift against its
    mean) by :func:`compare_conditioned` / :func:`compare_vs_f64`; each
    launched twice for the same bits.  Times each in float32 beside its
    plain version and, for K2, ``torch.linalg.solve_ex`` on the densified
    pair: ``{(s, name): row}``."""
    from gaussianvi_tpu_torch.kernels import chain

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 14)
    g64, inits, cfg, _ = arm_problem(f64, dev)
    it64 = plain_iterate(g64, inits, cfg)
    out, errs, held = {}, {}, {}
    for s, n in ((14, it64[0].shape[1]), (1, 1)):
        chains = {}
        for dt in (f64, f32):
            d1, o1, _ = spd_chains(TRIALS * ARM_B, n, s, rng, dt, dev)
            d2, o2, rhs = spd_chains(2 * ARM_B, n, s, rng, dt, dev)
            chains[dt] = ((d1.reshape(TRIALS, ARM_B, n, s, s),
                           o1.reshape(TRIALS, ARM_B, n - 1, s, s)),
                          (d2[:ARM_B], o2[:ARM_B], d2[ARM_B:], o2[ARM_B:],
                           rhs[:ARM_B]))
        for dt in (f64, f32):
            tol = (1e-10, 1e-10) if dt == f64 else (1e-4, 1e-6)
            tol_ld = (0.0, 1e-10) if dt == f64 else (1e-5, 0.0)
            k1 = check_repeatable(f"s={s} K1 {dt}", lambda dt=dt:
                                  chain.gbp_covariance_logdet_lanes(
                                      *chains[dt][0]))
            p1 = chain.gbp_covariance_logdet_plain(*chains[dt][0])
            errs[s, "gbp_covariance_logdet", dt] = max(
                compare(f"s={s} K1 cov_diag {dt}", k1[0], p1[0], *tol),
                compare(f"s={s} K1 cov_off {dt}", k1[1], p1[1], *tol),
                compare(f"s={s} K1 logdet {dt}", k1[2], p1[2], *tol_ld))
            k2 = check_repeatable(f"s={s} K2 {dt}", lambda dt=dt:
                                  chain.solve_pair_lanes(*chains[dt][1]))
            errs[s, "solve", dt] = max(
                compare(f"s={s} K2 x{i} {dt}", a, b_, *tol)
                for i, (a, b_) in enumerate(zip(
                    k2, chain.solve_pair_plain(*chains[dt][1]))))
        work = {"gbp_covariance_logdet": TRIALS * ARM_B * n * chain_flops(s),
                "solve": 2 * ARM_B * n * solve_flops(s)}
        calls = {
            "gbp_covariance_logdet": (
                lambda c=chains: chain.gbp_covariance_logdet_lanes(*c[f32][0]),
                lambda c=chains: chain.gbp_covariance_logdet_plain(*c[f32][0]),
                0),
            "solve": (lambda c=chains: chain.solve_pair_lanes(*c[f32][1]),
                      lambda c=chains: chain.solve_pair_plain(*c[f32][1]), 1),
        }
        for name, (kern, plain, which) in calls.items():
            out[s, name] = dict(
                max_abs_err=errs[s, name, f64], err_dtype="float64",
                max_abs_err_f32=errs[s, name, f32],
                ms=cuda_ms(kern), ms_flushed_l2=cuda_ms_flushed(kern),
                plain_ms=cuda_ms(plain, reps=1),
                library_ms=(dense_solve_ms(chains[f32][1]) if name == "solve"
                            else None),
                **bound(chains[f32][which], kern(), work[name]))
    # s = 14 at the arm's iterate: ill-conditioned blocks of a real run
    mu64, pd64, po64 = it64
    eye = torch.eye(14, dtype=f64, device=dev)
    args = {f64: ((pd64, po64), (pd64, po64, pd64 + eye, po64, mu64))}
    args[f32] = tuple(tuple(x.float() for x in a) for a in args[f64])
    for name, fn, plain, at in (
            ("gbp_covariance_logdet", chain.gbp_covariance_logdet_lanes,
             chain.gbp_covariance_logdet_plain, 0),
            ("solve", chain.solve_pair_lanes, chain.solve_pair_plain, 1)):
        k = {dt: check_repeatable(f"s=14 {name} at the iterate {dt}",
                                  lambda dt=dt, fn=fn, at=at:
                                  fn(*args[dt][at])) for dt in (f64, f32)}
        p = {dt: plain(*args[dt][at]) for dt in (f64, f32)}
        held[name] = (
            max(compare_conditioned(f"s=14 {name}[{i}] at the iterate "
                                    "float64", a, b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f64], p[f64], p[f32]))),
            max(compare_vs_f64(f"s=14 {name}[{i}] at the iterate float32",
                               a, b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f32], p[f32], p[f64]))))
    print("[s=14 / s=1 kernels] max abs err vs plain, f64 / f32 (two "
          "launches bit-identical each): " + "; ".join(
              f"s={s} {nm} {errs[s, nm, f64]:.3e} / {errs[s, nm, f32]:.3e}"
              for s in (14, 1) for nm in ("gbp_covariance_logdet", "solve"))
          + "; at the arm's iterate " + "; ".join(
              f"{nm} {a:.3e} / {b_:.3e}" for nm, (a, b_) in held.items()),
          flush=True)
    out.update(arm_quad_checks(dev, it64))
    out.update(arm_trial_checks(dev, g64, cfg, it64))
    return out


def arm_direction(graph, cfg, it, dev):
    """The NGD step's direction at the arm's iterate ``it`` as the loop
    forms it on the kernel route: ``(state, dmu, dprec)``."""
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    mu, pd, po = it
    state = GaussianState(mu, BlockTridiag(pd, po))
    engine = LocalEngine(graph, cfg, dev)
    cd, co, _ = engine.cov_logdet(state.precision)
    temp = torch.full(mu.shape[:1], cfg.temperature, dtype=mu.dtype,
                      device=dev)
    vdmu, vddmu = engine.ngd_gradients(mu, cd, co, temp)
    dmu, fallback = engine.solve_pair(vddmu, state.precision, -vdmu)
    dmu = torch.where(engine.all_finite(dmu)[:, None, None], dmu, fallback)
    return state, dmu, vddmu - state.precision


def arm_trial_checks(dev, g64, cfg, it64):
    """K1's trial form (``gbp_trials``, ``csrc/chain_wide.cu``
    ``gbp_wide_kernel<.., true>``) at the arm's shapes, 11 trials x 1024
    restarts of N = 10, along the NGD direction at the arm's iterate
    ``it64``: its covariance and log det against K1 on the separate
    route's trial precisions, bit for bit; its linear costs against the
    separate route's (``moments.batch_linear_cost`` on K1's blocks),
    float64 by :func:`compare_conditioned` and float32 by
    :func:`compare_vs_f64`; one launch a call, twice for the same bits.
    Times it in float32 beside the separate route's chain and linear
    costs (K1 and the glue it replaces), with its bound (the iterate, the
    direction and the linear operands read once, the trial batch's
    covariance, log det and costs written once; the sweeps'
    ``chain_flops``) and ptxas registers: ``{(14, "gbp_trials"): row}``."""
    from gaussianvi_tpu_torch.factors.moments import batch_linear_cost
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.kernels import _build, chain, launch_counts
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag

    f32, f64 = torch.float32, torch.float64
    it32 = tuple(x.float() for x in it64)
    graphs = {f64: g64, f32: arm_problem(f32, dev)[0]}
    cases = {}
    for dt, it in ((f64, it64), (f32, it32)):
        engine = LocalEngine(graphs[dt], cfg, dev)
        check(engine.gbp_trials_ready, f"arm trial form {dt}: not resolved")
        state, dmu, dprec = arm_direction(graphs[dt], cfg, it, dev)
        trials = cfg.step_size_base * cfg.step_decay ** torch.arange(
            1, TRIALS + 1, dtype=dt, device=dev)
        cases[dt] = (engine, state, dmu, dprec, trials)

    def trial_form(dt):
        before = launch_counts()["gbp_trials"]
        cd, co, ld, fc = cases[dt][0].gbp_trials(*cases[dt][1:])
        check(launch_counts()["gbp_trials"] == before + 1,
              f"arm trial form {dt}: not one gbp_trials launch")
        return (cd, co, ld, *fc)

    def separate(dt, up=False):
        engine, state, dmu, dprec, trials = cases[dt]
        if up:
            engine = cases[f64][0]
            prec = state.precision
            state = GaussianState(state.mu.double(), BlockTridiag(
                prec.diag.double(), prec.off.double()))
            dmu, trials = dmu.double(), trials.double()
            dprec = BlockTridiag(dprec.diag.double(), dprec.off.double())
        steps = trials.reshape(-1, 1)
        t_prec = (state.precision + dprec.scale(steps)).symmetrize()
        cd, co, ld = engine.cov_logdet(t_prec)
        t_mu = state.mu + steps[..., None, None] * dmu
        return (cd, co, ld, *(batch_linear_cost(lb, t_mu, cd, co)
                              for lb in engine.graph.linear))

    k = {dt: check_repeatable(f"arm trial form {dt}",
                              lambda dt=dt: trial_form(dt))
         for dt in (f64, f32)}
    p = {dt: separate(dt) for dt in (f64, f32)}
    for dt in (f64, f32):
        check(all(same_bits(a, b) for a, b in zip(k[dt][:3], p[dt][:3])),
              f"arm trial form {dt}: covariance or log det not K1's bits on "
              "the separate route's trial precisions")
    p64_up = separate(f32, up=True)
    err64 = max(compare_conditioned(f"arm trial form cost[{i}] float64", a,
                                    b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f64][3:], p[f64][3:],
                                                   p[f32][3:])))
    err32 = max(compare_vs_f64(f"arm trial form cost[{i}] float32", a, b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f32][3:], p[f32][3:],
                                                   p64_up[3:])))
    regs = {r["dtype"]: r for r in _build.ptxas_report()
            if r["kernel"] == "gbp_wide_kernel" and r["ints"][-1] == 1}
    engine, state, dmu, dprec, trials = cases[f32]
    n, s = state.mu.shape[1:]
    prec = state.precision
    _, lin_specs, _, lin = engine._flat_operands(state.mu.shape[:1],
                                                 state.mu)
    ops = (state.mu, dmu, prec.diag, prec.off, dprec.diag, dprec.off, trials,
           *(x for arrays in lin for x in arrays[1:]))
    row = dict(
        max_abs_err=err64, err_dtype="float64", max_abs_err_f32=err32,
        ms=cuda_ms(lambda: trial_form(f32)),
        ms_flushed_l2=cuda_ms_flushed(lambda: trial_form(f32)),
        separate_ms=cuda_ms(lambda: separate(f32)),
        plain_ms=cuda_ms(lambda: chain.gbp_trials_plain(
            prec.diag, prec.off, dprec.diag, dprec.off, state.mu, dmu,
            trials, lin_specs, lin), reps=1),
        library_ms=None, kernel="gbp_wide_kernel<.., true>",
        registers=(regs.get("float32", {}).get("registers"),
                   regs.get("float64", {}).get("registers")),
        spills=tuple((regs.get(d, {}).get("spill_stores"),
                      regs.get(d, {}).get("spill_loads"))
                     for d in ("float32", "float64")),
        **bound(ops, k[f32], TRIALS * ARM_B * n * chain_flops(s)))
    print(f"[s=14 K1 trial form] 11 x {ARM_B} chains of N = {n} at the "
          f"arm's iterate: covariance and log det K1's bits on the separate "
          f"route's trial precisions (f64, f32); linear costs vs the "
          f"separate route's {err64:.3e} / {err32:.3e} (f64 / f32); two "
          f"launches bit-identical, one a call; {row['ms']:.4f} ms "
          f"({row['ms_flushed_l2']:.4f} flushed), the separate route's K1 + "
          f"glue {row['separate_ms']:.4f} ms; registers f32 / f64 "
          f"{row['registers']}, spills {row['spills']}", flush=True)
    return {(14, "gbp_trials"): row}


def arm_quad_checks(dev, it64):
    """The arm's K3 instance (``"arm_sdf"``, ``csrc/quad_arm.cu``) at the
    shapes ``optimize`` gives it on the arm planner, against the plain
    form on the same inputs: phi on the trial batch, 11 x 1024 restarts x
    10 factors (means jittered by 0.05 about the arm's iterate ``it64``,
    the iterate's covariances), and the moments on the 1024 x 10 factors
    at the iterate; float64 by :func:`compare_conditioned`, float32 by
    :func:`compare_vs_f64` (no more guard decisions apart from float64's
    than the plain form takes); each wrapper counted once a call and
    launched twice for the same bits.  Times each in float32 beside the
    plain form, with its bound and ptxas registers: ``{(14, name): row}``
    for ``quad_phi`` / ``quad_moments``."""
    from gaussianvi_tpu_torch.kernels import _build, launch_counts, quad
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 15)
    mu64, pd64, po64 = it64
    cov64 = gbp_covariance_logdet(BlockTridiag(pd64, po64))[0]
    b, n, d = mu64.shape
    jitter = torch.tensor(0.05 * rng.standard_normal((TRIALS, b, n, d)),
                          dtype=f64, device=dev)
    fbs = {dt: arm_problem(dt, dev, 1)[0].nonlinear[0] for dt in (f64, f32)}
    check(all(fb.kernel_cost == "arm_sdf" for fb in fbs.values()),
          "arm K3: the arm's batch names no kernel cost")
    args3, args4 = {}, {}
    for dt, fb in fbs.items():
        mu, cov = mu64.to(dt), cov64.to(dt)
        rule = (fb.nodes, fb.weights, "arm_sdf", fb.kernel_params)
        args3[dt] = ((mu + jitter.to(dt)).contiguous(),
                     cov.expand(TRIALS, *cov.shape).contiguous(), *rule)
        args4[dt] = (mu, cov, *rule)
    rdim = fbs[f64].quad_rdim
    cases = {
        "quad_phi": ("quad_arm_phi", args3, lambda dt, fn: (fn(
            *args3[dt], nonneg=True, field=fbs[dt].kernel_field),)),
        "quad_moments": ("quad_arm_moments", args4, lambda dt, fn: fn(
            *args4[dt], rdim=rdim, field=fbs[dt].kernel_field)),
    }
    wrappers = {"quad_phi": (quad.quad_lanes_phi, quad.quad_phi_plain),
                "quad_moments": (quad.quad_lanes_moments,
                                 quad.quad_moments_plain)}
    m = fbs[f32].nodes.shape[0]
    work = {name: (TRIALS if name == "quad_phi" else 1) * b * n * quad_flops(
        d, m, rdim, name == "quad_moments", cost=ARM_COST_OPS)
        for name in cases}
    regs = {(r["dtype"], bool(r["ints"][-1])): r for r in _build.ptxas_report()
            if r["kernel"] == "quad_arm_kernel"}
    out, errs = {}, {}
    for name, (key, args, call) in cases.items():
        kern, plain = wrappers[name]

        def launched(dt, kern=kern, key=key, call=call):
            before = launch_counts()[key]
            got = call(dt, kern)
            check(launch_counts()[key] == before + 1,
                  f"arm K3 {name} {dt}: not one {key} launch")
            return got

        k = {dt: check_repeatable(f"arm K3 {name} {dt}",
                                  lambda dt=dt: launched(dt))
             for dt in (f64, f32)}
        p = {dt: call(dt, plain) for dt in (f64, f32)}
        errs[name] = (
            max(compare_conditioned(f"arm K3 {name}[{i}] float64", a, b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f64], p[f64], p[f32]))),
            max(compare_vs_f64(f"arm K3 {name}[{i}] float32", a, b_, c)
                for i, (a, b_, c) in enumerate(zip(k[f32], p[f32], p[f64]))),
            int(torch.isnan(k[f32][0]).sum()), int(torch.isnan(p[f32][0]).sum()))
        # bytes: every operand read once, the params (one row every factor
        # reads) and the field once, the outputs written once
        fb = fbs[f32]
        ops = (*args[f32][:4], fb.kernel_params.reshape(-1, quad.ARM_NP)[:1],
               fb.kernel_field)
        with_moments = name == "quad_moments"
        r32, r64 = (regs.get((dt, with_moments), {})
                    for dt in ("float32", "float64"))
        out[14, name] = dict(
            max_abs_err=errs[name][0], err_dtype="float64",
            max_abs_err_f32=errs[name][1],
            ms=cuda_ms(lambda call=call, kern=kern: call(f32, kern)),
            ms_flushed_l2=cuda_ms_flushed(
                lambda call=call, kern=kern: call(f32, kern)),
            plain_ms=cuda_ms(lambda call=call, plain=plain: call(f32, plain),
                             reps=1),
            library_ms=None, kernel="quad_arm_kernel",
            registers=(r32.get("registers"), r64.get("registers")),
            spills=((r32.get("spill_stores"), r32.get("spill_loads")),
                    (r64.get("spill_stores"), r64.get("spill_loads"))),
            **bound(ops, k[f32], work[name]))
    print("[s=14 arm K3] max abs err vs plain at the cell's shapes, f64 / "
          "f32 (two launches bit-identical each, one launch a call): "
          + "; ".join(f"{nm} {e64:.3e} / {e32:.3e}, f32 NaN {nk} (plain "
                      f"{np_})" for nm, (e64, e32, nk, np_) in errs.items())
          + "; registers f32 / f64 " + "; ".join(
              f"{nm} {out[14, nm]['registers']}" for nm in cases),
          flush=True)
    return out


def arm_runs(card, dev):
    """The 7-DOF arm planner through ``optimize`` under the defaults on
    the card (K1 / K2 at s = 14 and the arm's K3 instance, ``"arm_sdf"``,
    ``csrc/quad_arm.cu``) at B = 1024 restarts
    in float32, counted: every restart's costs finite and non-increasing,
    or NaN from the first record on where the float32 guard poisons the
    first E[phi] (the same restarts the JAX package poisons in float32,
    ``tests/test_torch_arm.py``; at most ``ARM_POISON_MAX`` of them, never
    restart 0); the float64 run of the same restarts finite throughout;
    restart 0's spheres no deeper than -0.05 in the field
    (``tests/test_arm_planning.py``); float32 against float64 on the
    unpoisoned restarts; the kernel path against the plain path in float64
    on 8 restarts over all 15 iterations, beside the plain path's own
    1e-15 sensitivity; the rate.  Returns ``(launches, rates)``."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.inference.graph import GaussianState

    f32, f64 = torch.float32, torch.float64
    graph32, inits32, cfg, (fk, sdf) = arm_problem(f32, dev)
    graph64, inits64, _, _ = arm_problem(f64, dev)
    plain = replace(cfg, chain_impl="seq", quad_impl="xla")
    (state32, hist32), n = counted(optimize, graph32, inits32, cfg)
    print(f"[arm path] launches {n}", flush=True)
    arm_keys = ("gbp_covariance_logdet", "gbp_trials", "solve",
                "quad_arm_phi", "quad_arm_moments")
    check(n["gbp_covariance_logdet"] == 1 and n["gbp_trials"] == ARM_ITERS
          and n["solve"] == ARM_ITERS
          and n["quad_arm_phi"] == ARM_ITERS + 1
          and n["quad_arm_moments"] == ARM_ITERS
          and all(v == 0 for k, v in n.items() if k not in arm_keys),
          f"arm: not K1 at init, its trial form and K2 an iteration, with "
          f"the arm's K3: {n}")
    _, hist64 = optimize(graph64, inits64, cfg)
    check_costs("arm path float64", hist64, ARM_B, ARM_ITERS, nonneg=True)
    poisoned = torch.isnan(hist32.cost[:, 0])
    kept = int((~poisoned).sum())
    check(not bool(poisoned[0]), "arm: restart 0's first cost is NaN")
    check(bool(torch.isnan(hist32.cost[poisoned]).all()),
          "arm: a poisoned restart took a step")
    check(kept >= (1 - ARM_POISON_MAX) * ARM_B,
          f"arm: {ARM_B - kept} restarts poisoned in float32")
    check_costs("arm path float32", SimpleNamespace(
        cost=hist32.cost[~poisoned]), kept, ARM_ITERS, nonneg=True)
    centers = fk.sphere_centers(state32.mu[0, :, :7])
    clearance = float(sdf.signed_distance(centers).min())
    cost0 = hist32.cost[0]
    print(f"[arm path] restart 0: spheres {clearance:.4f} from the obstacle "
          f"(at worst), cost {float(cost0[0]):.2f} -> {float(cost0[-1]):.2f};"
          f" {ARM_B - kept}/{ARM_B} restarts poisoned from the first record "
          f"by the float32 guard", flush=True)
    check(clearance > -0.05, f"arm: restart 0's spheres {clearance:.3e} "
          "deep in the obstacle")
    f32_vs_f64("arm path", SimpleNamespace(cost=hist32.cost[~poisoned]),
               SimpleNamespace(cost=hist64.cost[~poisoned]), 1e-3)
    # the kernel path against the plain path (float64, 8 restarts) over
    # the whole run: the arm keeps rounding in check (its plain path's
    # costs from means nudged by 1e-15, printed beside)
    s8 = subset(inits64, 8)
    hp = optimize(graph64, s8, plain)[1]
    hk = optimize(graph64, s8, cfg)[1]
    held_to_plain("arm kernels vs plain path", hk, hp, dev,
                  tag="s=14 end to end")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    nudged = GaussianState(s8.mu * (1 + 1e-15 * torch.randn(
        s8.mu.shape, generator=gen, dtype=f64, device=dev)), s8.precision)
    hn = optimize(graph64, nudged, plain)[1]
    for name, a, b_ in (("kernels vs plain path", hk, hp),
                        ("plain path vs itself from means nudged by 1e-15",
                         hn, hp)):
        rel = ((a.cost - b_.cost).abs() / b_.cost.abs()).max(0).values
        steps = int((a.accepted_step != b_.accepted_step).any(0).sum())
        print(f"[arm end to end] {name} (f64, 8 restarts, {ARM_ITERS} "
              f"iters): max relative cost difference at iterations 5 / 10 / "
              f"last {rel[4]:.1e} / {rel[9]:.1e} / {rel[-1]:.1e}, max "
              f"{rel.max().item():.1e}; steps differ at {steps}/{ARM_ITERS} "
              f"iterations", flush=True)
    rates = {"arm": rate(lambda: optimize(graph32, inits32, cfg),
                         ARM_B * ARM_ITERS),
             "arm plain": rate(lambda: optimize(
                 graph32, subset(inits32, ARM_B_PLAIN), plain),
                 ARM_B_PLAIN * ARM_ITERS, runs=1)}
    print(f"[throughput] {card}: arm (K1 / K2 at s = 14, K3) {rates['arm']:.1f} "
          f"prob-iters/s (B={ARM_B}, N={hist32.mu.shape[2]}, {ARM_ITERS} "
          f"iters), plain {rates['arm plain']:.1f} (B={ARM_B_PLAIN}); f32, "
          f"median of 3, plain one run", flush=True)
    return n, rates


def barfoot_runs(dev):
    """The Barfoot 1-D example (N = 1, s = 1) on the card in float64
    through K1 / K2 at s = 1, NGD and prox, each counted, against the
    reference's golden trajectories (``tests/test_golden_1d.py``: mean,
    variance and cost, atol 1e-9).  Returns the launches per method."""
    from gaussianvi_tpu_torch.examples.barfoot_1d import run_barfoot_1d

    ref = golden_1d()
    counts = {}
    for method in ("ngd", "prox"):
        (_, hist), n = counted(run_barfoot_1d, method, 10, torch.float64,
                               dev)
        counts[method] = n
        check(n["gbp_covariance_logdet"] > 0
              and (n["solve"] > 0) == (method == "ngd")
              and all(v == 0 for k, v in n.items()
                      if k not in ("gbp_covariance_logdet", "solve")),
              f"barfoot {method}: not K1 / K2: {n}")
        key = method.upper()
        err = max(
            float((got.cpu() - torch.tensor(ref[f"REF_{key}_{name}"],
                                            dtype=torch.float64)).abs().max())
            for name, got in (("MEAN", hist.mu[:, 0, 0]),
                              ("COV", hist.cov_diag[:, 0, 0, 0]),
                              ("COST", hist.cost)))
        print(f"[barfoot {method}] launches {n}; max abs difference from the "
              f"golden mean / variance / cost {err:.3e} (f64, K1 / K2 at "
              f"s = 1)", flush=True)
        check(err <= 1e-9, f"barfoot {method}: {err:.3e} off the golden run")
    return counts


# ---- the loop's further options: bfloat16 offsets in K3, K5 and K6, the
# sequential line search, EMA smoothing, resume, LTV estimation -------------
BF16 = torch.bfloat16
# build_ltv_estimation's own config: N = 10 states of dim 2, the 4-node
# (2, 4) rule, 15 iterations; B = 1024 restarts (perturb_inits, mean_scale
# 0.3), not cut
LTV_B, LTV_ITERS = 1024, 15
RESUME_AT = 4


def bf16_case(tag, kern, plain, skip=()):
    """One kernel with ``eval_dtype=bfloat16`` against its plain version
    with the same option: float64 by :func:`compare_conditioned`, float32
    by :func:`compare_vs_f64` (outputs ``skip`` left to the caller), each
    launched twice for the same bits, and the round trip seen to change
    the output.  ``kern(dtype, eval_dtype)`` / ``plain(dtype, eval_dtype)``
    return tuples.  Times the bfloat16 instance beside the unquantized one
    (float32, warm and with the L2 flushed): ``(row, kernel outputs, plain
    outputs)`` by dtype."""
    f32, f64 = torch.float32, torch.float64
    k = {dt: check_repeatable(f"{tag} bf16 {dt}",
                              lambda dt=dt: kern(dt, BF16))
         for dt in (f64, f32)}
    p = {dt: plain(dt, BF16) for dt in (f64, f32)}
    keep = [i for i in range(len(k[f64])) if i not in skip]
    err64 = max(compare_conditioned(f"{tag}[{i}] bf16 float64", k[f64][i],
                                    p[f64][i], p[f32][i]) for i in keep)
    err32 = max(compare_vs_f64(f"{tag}[{i}] bf16 float32", k[f32][i],
                               p[f32][i], p[f64][i]) for i in keep)
    check(not all(same_bits(a, b_) for a, b_ in zip(k[f32], kern(f32, None))),
          f"{tag}: the bfloat16 round trip changed nothing")
    row = dict(max_abs_err=err64, err_dtype="float64", err_f32=err32,
               ms=cuda_ms(lambda: kern(f32, BF16)),
               ms_flushed_l2=cuda_ms_flushed(lambda: kern(f32, BF16)),
               unquantized_ms=cuda_ms(lambda: kern(f32, None)),
               unquantized_ms_flushed_l2=cuda_ms_flushed(
                   lambda: kern(f32, None)),
               plain_ms=cuda_ms(lambda: plain(f32, BF16), reps=1))
    return row, k, p


def bf16_flagship_checks(graph_b, dev, iterate):
    """K3 (both variants), K5, K6 ``full`` and the split pair with the
    offsets rounded through bfloat16, at the flagship's iterate and shapes
    (:func:`bf16_case`): K3 phi on the trial batch (11 x 1024 x 32
    factors, means jittered), K3 moments on 1024 x 32, K5 / K6 in the
    direction :func:`fused_checks` takes, ``accum`` on the first half of
    the factors as a rank of the factor-parallel path holds it, ``solve``
    on the halves' float64 plain sums.  ``{name: row}``."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft
    from gaussianvi_tpu_torch.kernels import quad
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 11)
    mu64, pd64, po64 = iterate
    cd64 = gbp_covariance_logdet(BlockTridiag(pd64, po64))[0]
    jitter = torch.tensor(0.05 * rng.standard_normal((TRIALS, B, N, 4)),
                          dtype=f64, device=dev)
    args3, args4, x5, x6, ops, halves, lin = {}, {}, {}, {}, {}, {}, {}
    for dt in (f64, f32):
        fb = graph_b[dt].nonlinear[0]
        mu, pd, po, cd = (x.to(dt) for x in (mu64, pd64, po64, cd64))
        args3[dt] = ((mu + jitter.to(dt)).contiguous(),
                     cd.expand(TRIALS, *cd.shape).contiguous(), fb.nodes,
                     fb.weights, "range", fb.kernel_params)
        args4[dt] = (mu, cd, fb.nodes, fb.weights, "range", fb.kernel_params)
        x6[dt] = (mu, pd, po, torch.ones(B, dtype=dt, device=dev))
        ops[dt] = fused_operands(graph_b[dt])
        halves[dt] = [half_operands(graph_b[dt], i) for i in (0, 1)]
        lin[dt] = (ops[dt][1], ops[dt][3])
    p6 = fg.gradient_plain(*x6[f64], *ops[f64])
    finite = torch.isfinite(p6[5]).flatten(1).all(1)
    direction = (torch.where(finite[:, None, None], p6[5], p6[6]), p6[3],
                 p6[4])
    trials = 0.9 * 0.75 ** torch.arange(1, TRIALS + 1, dtype=f64, device=dev)
    for dt in (f64, f32):
        x5[dt] = (x6[dt][0], *(x.to(dt) for x in direction[:1]), x6[dt][1],
                  x6[dt][2], *(x.to(dt) for x in direction[1:]),
                  trials.to(dt))

    def accum_plain(dt, ed, i):
        specs, arrays = halves[dt][i]
        return tuple(fg.gradient_plain(*x6[dt], specs, (), arrays, (),
                                       mode="accum", eval_dtype=ed))

    seeds = {}
    for ed in (None, BF16):
        total = tuple(a + b_ for a, b_ in zip(accum_plain(f64, ed, 0),
                                              accum_plain(f64, ed, 1)))
        seeds[ed] = {f64: total, f32: tuple(t.to(f32) for t in total)}

    def flat5(o):
        return (o[0], *o[1])

    cases = {
        "quad_phi": (
            lambda dt, ed: (quad.quad_lanes_phi(*args3[dt], nonneg=True,
                                                eval_dtype=ed),),
            lambda dt, ed: (quad.quad_phi_plain(*args3[dt], nonneg=True,
                                                eval_dtype=ed),)),
        "quad_moments": (
            lambda dt, ed: quad.quad_lanes_moments(*args4[dt], rdim=DIM_X,
                                                   eval_dtype=ed),
            lambda dt, ed: quad.quad_moments_plain(*args4[dt], rdim=DIM_X,
                                                   eval_dtype=ed)),
        "fused_trials": (
            lambda dt, ed: flat5(ft.trial_costs_lanes(*x5[dt], *ops[dt],
                                                      eval_dtype=ed)),
            lambda dt, ed: flat5(ft.trial_costs_plain(*x5[dt], *ops[dt],
                                                      eval_dtype=ed))),
        "fused_gradient": (
            lambda dt, ed: fg.gradient_lanes(*x6[dt], *ops[dt],
                                             eval_dtype=ed),
            lambda dt, ed: fg.gradient_plain(*x6[dt], *ops[dt],
                                             eval_dtype=ed)),
        "fused_gradient_accum": (
            lambda dt, ed: tuple(fg.gradient_accum_lanes(
                *x6[dt], *halves[dt][0], eval_dtype=ed)),
            lambda dt, ed: accum_plain(dt, ed, 0)),
        "fused_gradient_solve": (
            lambda dt, ed: fg.gradient_solve_lanes(*x6[dt], seeds[ed][dt],
                                                   *lin[dt]),
            lambda dt, ed: fg.gradient_plain(
                *x6[dt], (), lin[dt][0], (), lin[dt][1], mode="solve",
                seeds=seeds[ed][dt])),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        out[name] = bf16_case(f"flagship {name}", kern, plain)[0]
    print("[bf16 kernels, flagship] max abs err vs plain, f64 / f32; ms "
          "flushed bf16 / unquantized (f32): " + "; ".join(
              f"{nm} {r['max_abs_err']:.3e} / {r['err_f32']:.3e}; "
              f"{r['ms_flushed_l2']:.4f} / {r['unquantized_ms_flushed_l2']:.4f}"
              for nm, r in out.items()), flush=True)
    return out


def bf16_s6_checks(dev):
    """K3 (both variants), K5 and K6 ``full`` with bfloat16 offsets at the
    3-D point planner's iterate (1024 restarts, N = 20, s = 6, the 3-D SDF
    cost on 25 nodes), as :func:`s6_kernel_checks` holds the unquantized
    instances (K6's main solve by its backward error).  ``{name: row}``."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft
    from gaussianvi_tpu_torch.kernels import quad
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(SEED + 12)
    graphs = {dt: _batch_graph(point3d_problem(dt, dev, 1)[0], S6_B)
              for dt in (f32, f64)}
    g64, inits, config, _ = point3d_problem(f64, dev)
    it64 = plain_iterate(g64, inits, config)
    n = it64[0].shape[1]
    cd64 = gbp_covariance_logdet(BlockTridiag(*it64[1:]))[0]
    jitter = torch.tensor(0.05 * rng.standard_normal((TRIALS, S6_B, n, 6)),
                          dtype=f64, device=dev)
    args3, args4, x5, x6, ops, fields = {}, {}, {}, {}, {}, {}
    for dt in (f64, f32):
        fb = graphs[dt].nonlinear[0]
        fields[dt] = fb.kernel_field
        mu, pd, po, cd = (x.to(dt) for x in (*it64, cd64))
        args3[dt] = ((mu + jitter.to(dt)).contiguous(),
                     cd.expand(TRIALS, *cd.shape).contiguous(), fb.nodes,
                     fb.weights, "sdf3d", fb.kernel_params)
        args4[dt] = (mu, cd, fb.nodes, fb.weights, "sdf3d", fb.kernel_params)
        ops[dt] = fused_operands(graphs[dt])
        x6[dt] = (mu, pd, po, torch.full((S6_B,), 0.1, dtype=dt, device=dev))
    p6 = fg.gradient_plain(*x6[f64], *ops[f64])
    finite = torch.isfinite(p6[5]).flatten(1).all(1)
    direction = (torch.where(finite[:, None, None], p6[5], p6[6]), p6[3],
                 p6[4])
    for dt in (f64, f32):
        dmu, dpd, dpo = (x.to(dt) for x in direction)
        trials = 0.9 * 0.75 ** torch.arange(1, TRIALS + 1, dtype=dt,
                                            device=dev)
        mu, pd, po, _ = x6[dt]
        x5[dt] = (mu, dmu, pd, po, dpd, dpo, trials)
    rdim = graphs[f64].nonlinear[0].quad_rdim

    def flat5(o):
        return (o[0], *o[1])

    cases = {
        "quad_phi": (
            lambda dt, ed: (quad.quad_lanes_phi(*args3[dt], nonneg=True,
                                                field=fields[dt],
                                                eval_dtype=ed),),
            lambda dt, ed: (quad.quad_phi_plain(*args3[dt], nonneg=True,
                                                field=fields[dt],
                                                eval_dtype=ed),)),
        "quad_moments": (
            lambda dt, ed: quad.quad_lanes_moments(
                *args4[dt], rdim=rdim, field=fields[dt], eval_dtype=ed),
            lambda dt, ed: quad.quad_moments_plain(
                *args4[dt], rdim=rdim, field=fields[dt], eval_dtype=ed)),
        "fused_trials": (
            lambda dt, ed: flat5(ft.trial_costs_lanes(*x5[dt], *ops[dt],
                                                      eval_dtype=ed)),
            lambda dt, ed: flat5(ft.trial_costs_plain(*x5[dt], *ops[dt],
                                                      eval_dtype=ed))),
        "fused_gradient": (
            lambda dt, ed: fg.gradient_lanes(*x6[dt], *ops[dt],
                                             eval_dtype=ed),
            lambda dt, ed: fg.gradient_plain(*x6[dt], *ops[dt],
                                             eval_dtype=ed)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        skip = (5,) if name == "fused_gradient" else ()
        out[name], k, p = bf16_case(f"point3d {name}", kern, plain, skip)
        if name == "fused_gradient":
            # dmu by its backward error in the float64 plain system
            vdd = (p[f64][3] + x6[f64][1], p[f64][4] + x6[f64][2])
            out[name]["dmu_backward_f64"] = compare_backward(
                "point3d K6 bf16 dmu float64", k[f64][5], p[f64][5], *vdd)[0]
            out[name]["dmu_backward_f32"] = compare_backward_vs_f64(
                "point3d K6 bf16 dmu float32", k[f32][5], p[f32][5],
                p[f64][5], *vdd)
    print("[bf16 kernels, point3d] max abs err vs plain, f64 / f32; ms "
          "flushed bf16 / unquantized (f32): " + "; ".join(
              f"{nm} {r['max_abs_err']:.3e} / {r['err_f32']:.3e}; "
              f"{r['ms_flushed_l2']:.4f} / {r['unquantized_ms_flushed_l2']:.4f}"
              for nm, r in out.items()), flush=True)
    return out


def bf16_runs(card, dev, graph_b, state_b, graph_s, state_s):
    """The flagship with ``moments_eval_dtype``: bfloat16 through the fused
    kernels at B = 1024 (counted: K1 and K3 at init, K5 and K6 every
    iteration) and the separate kernels at B = 256 (counted: K3 both
    variants), the kernel paths against the plain path with the same
    option (float64, 8 problems), float32 bfloat16 against float64
    unquantized (the same basin within 10%, the JAX package's pin), the
    rate; float16: the engine's resolution (plain quadrature, no fused
    kernel) and a finite run.  Returns the launches by path."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.inference.engine import LocalEngine

    f32, f64 = torch.float32, torch.float64
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    cfg_b = replace(cfg, moments_eval_dtype="bfloat16")
    cfg_sep = replace(cfg_b, fused_trials="off", fused_gradient="off")
    (_, h32), fused = counted(optimize, graph_b[f32], state_b[f32], cfg_b)
    print(f"[bf16 fused path] launches {fused}", flush=True)
    check(fused["fused_trials"] == NITERS and fused["fused_gradient"] == NITERS
          and fused["gbp_covariance_logdet"] > 0 and fused["quad_phi"] > 0,
          f"bf16: the fused path skipped a kernel: {fused}")
    check_costs("bf16 fused path", h32, B)
    (_, hs), sep = counted(optimize, graph_s, state_s, cfg_sep)
    print(f"[bf16 separate path] launches {sep}", flush=True)
    check(sep["quad_phi"] > 0 and sep["quad_moments"] == NITERS
          and sep["fused_trials"] == sep["fused_gradient"] == 0,
          f"bf16: the separate path skipped a kernel: {sep}")
    check_costs("bf16 separate path", hs, B_SEPARATE)
    # float32 with bfloat16 offsets against float64 without: the same basin
    # (the JAX package pins one problem within 10%); over 1024 problems a
    # few end their search, and so escalate the temperature, at another
    # iteration (a discrete decision, as float32 alone takes on some), so
    # the gate is problem 0 and 99% of the batch within 10%, the median
    # within JAX's bfloat16 envelope of E[phi] (2e-3)
    _, h64 = optimize(graph_b[f64], state_b[f64], cfg)
    rel = ((h32.cost[:, -1].double() - h64.cost[:, -1]).abs()
           / h64.cost[:, -1].abs())
    apart = int((rel >= 0.1).sum())
    print(f"[bf16 fused path] f32 bf16 vs f64 unquantized final cost: "
          f"median {rel.median().item():.3e}, max {rel.max().item():.3e}, "
          f"problem 0 {rel[0].item():.3e}; {apart}/{B} problems 10% or more "
          f"apart", flush=True)
    check(rel[0].item() < 0.1 and apart <= B // 100
          and rel.median().item() < 2e-3,
          f"bf16: final costs off the unquantized float64 run's: problem 0 "
          f"{rel[0].item():.3e}, {apart}/{B} problems 10% or more apart, "
          f"median {rel.median().item():.3e}")
    # the kernel paths against the plain path: a bfloat16 rounding is a
    # step function, and where the kernels' offsets and the plain path's
    # differ by their conditioning-amplified rounding (up to 1e-9 relative
    # on the longest trial steps, fused_checks) about one offset in a
    # million rounds to the neighbouring bfloat16 value, each moving a
    # total cost by up to a few 1e-6 relative (measured on this card:
    # 5.1e-7 fused, 4.5e-6 separate), so the gate is 1e-4 and the same
    # accepted steps (the unquantized paths: 1e-9)
    g8, s8 = build_batch(f64, dev, num_problems=8)
    plain = replace(cfg_b, chain_impl="seq", quad_impl="xla")
    hp = optimize(g8, s8, plain)[1]
    for name, c in (("fused", cfg_b), ("separate", cfg_sep)):
        held_to_plain(f"bf16 {name} kernels vs plain path",
                      optimize(g8, s8, c)[1], hp, dev, rtol=1e-4,
                      tag="bf16 end to end")
    r = rate(lambda: optimize(graph_b[f32], state_b[f32], cfg_b),
             B * NITERS)
    print(f"[throughput] {card}: fused kernels with bfloat16 offsets "
          f"{r:.1f} prob-iters/s (B={B}, N={N}, {NITERS} iters, f32, median "
          f"of 3)", flush=True)
    cfg_h = replace(cfg, moments_eval_dtype="float16")
    eng = LocalEngine(graph_b[f32], cfg_h, dev)
    print(f"[fp16 resolution] chain_kernel {eng.chain_kernel}, quad_kernel "
          f"{eng.quad_kernel} (float16 offsets take the plain quadrature), "
          f"fused_trials {eng.fused_trials_ready}, fused_gradient "
          f"{eng.fused_gradient_ready}", flush=True)
    check(not eng.fused_trials_ready and not eng.fused_gradient_ready,
          "fp16: a fused kernel was resolved")
    (_, hh), half = counted(optimize, graph_s, state_s, cfg_h)
    print(f"[fp16 path] launches {half}", flush=True)
    check(half["quad_phi"] == half["quad_moments"] == 0
          and half["fused_trials"] == half["fused_gradient"] == 0
          and half["gbp_covariance_logdet"] > 0,
          f"fp16: not K1 / K2 with the plain quadrature: {half}")
    check(bool(torch.isfinite(hh.cost).all()), "fp16: non-finite cost")
    return {"bf16 fused": fused, "bf16 separate": sep}


def resume_runs(dev, graph_b, state_b):
    """Checkpoint and resume on the fused path (B = 1024): ten iterations
    straight through ``optimize_from`` against four, then
    ``save_checkpoint`` -> ``load_loop_state`` -> ``optimize_from`` from
    iteration four (the scheduled temperature switch, at six, inside the
    resumed window).  The resumed run's first carried log det and factor
    costs come from K1 and K3 at the loaded state, the straight run's from
    K5 at the accepted trial: apart by their conditioned rounding, so the
    window's first recorded cost is held to 1e-8 (float64), and every
    accept decision compares a trial cost with it.  float64: the final state, the loop values, the
    accepted steps and the recorded means, precisions, covariances and
    later costs the same bits.  float32, where the costs of problems near
    convergence decrease by about an ulp an iteration and the guards'
    float32 thresholds poison a cost in one kernel and not the other,
    those decide a few searches: at most 5% of the problems take another
    decision, and every other problem ends on the same bits.  Then the carry's refreshed
    covariance (``run_gvi_carry``) against K1 on the final precision, bit
    for bit.  Returns the float32 resumed run's launches."""
    import tempfile

    from gaussianvi_tpu_torch import GVIConfig
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.optimize import (
        optimize_from,
        run_gvi_carry,
    )
    from gaussianvi_tpu_torch.kernels import chain
    from gaussianvi_tpu_torch.utils import load_loop_state, save_checkpoint

    cfg = GVIConfig(niters=NITERS, niters_lowtemp=6, step_size_base=0.9)
    names = ("mu", "cov_diag", "cov_off", "prec_diag", "prec_off", "cost",
             "factor_costs", "accepted_step")
    for dt in (torch.float64, torch.float32):
        g, s0 = graph_b[dt], state_b[dt]
        full_state, full_hist, full_loop = optimize_from(g, s0, cfg)
        mid, _, mid_loop = optimize_from(g, s0, replace(cfg,
                                                        niters=RESUME_AT))
        with tempfile.TemporaryDirectory() as tmp:
            path = save_checkpoint(os.path.join(tmp, "ck"), mid, RESUME_AT,
                                   *mid_loop)
            state, it, loop = load_loop_state(path, device=dev)
        check(it == RESUME_AT and same_bits(state.mu, mid.mu),
              "resume: the checkpoint did not read back")
        (res_state, res_hist, res_loop), n = counted(
            optimize_from, g, state, cfg, "ngd", it, loop)
        check(n["fused_trials"] == NITERS - RESUME_AT
              and n["fused_gradient"] == NITERS - RESUME_AT,
              f"resume: the fused kernels did not run: {n}")
        window = [x[:, RESUME_AT:] for x in full_hist]
        a0, b0 = res_hist.cost[:, 0].double(), window[5][:, 0].double()
        both = torch.isfinite(a0) & torch.isfinite(b0)
        first = ((a0 - b0)[both].abs() / b0[both].abs()).max().item()
        poisoned = int((torch.isnan(a0) != torch.isnan(b0)).sum())
        same = (res_hist.accepted_step == window[7]).all(1)
        ends = torch.stack([
            (a == b_).flatten(1).all(1) | (a.isnan() & b_.isnan()).flatten(
                1).all(1)
            for a, b_ in ((res_state.mu, full_state.mu),
                          (res_state.precision.diag,
                           full_state.precision.diag))]).all(0)
        other = int((~same).sum())
        print(f"[resume {str(dt)[6:]}] {B} problems, fused path: resumed "
              f"at iteration {RESUME_AT} of {NITERS} (launches {n}); first "
              f"resumed cost {first:.1e} apart where finite, NaN in one run "
              f"only on {poisoned}; {other}/{B} problems took another "
              f"decision; {int((same & ends).sum())}/{int(same.sum())} of "
              f"the others end on the same bits", flush=True)
        check(bool(ends[same].all()),
              "resume: a problem with the same decisions ended elsewhere")
        if dt == torch.float32:
            # the first cost's ulps, and the float32 guards that poison a
            # cost the other kernel leaves finite (K5 at the trial, K3 at
            # the state), decide a few searches
            check(other <= B // 20,
                  f"resume: {other}/{B} problems took another decision")
            continue
        check(poisoned == 0, "resume: a first cost NaN in one run only")
        # K5 holds the float64 plain version at the flagship's iterate only
        # to its conditioned bound (fused_checks: 4e-7 absolute on costs of
        # ~1e3 at the longest steps), and so do K1 / K3 at the state
        check(first < 1e-8, f"resume: first resumed cost {first:.3e} off")
        check(other == 0 and all(same_bits(a, b_)
                                 for a, b_ in zip(res_loop, full_loop)),
              "resume: decisions or loop values differ (float64)")
        for nm, a, b_ in zip(names, res_hist, window):
            rows = a[:, 1:] if nm in ("cost", "factor_costs") else a
            want = b_[:, 1:] if nm in ("cost", "factor_costs") else b_
            check(same_bits(rows, want), f"resume: history {nm} differs")
        engine = LocalEngine(g, cfg, dev)
        carry, _ = run_gvi_carry(engine, s0, cfg)
        k1 = chain.gbp_covariance_logdet_lanes(carry.state.precision.diag,
                                               carry.state.precision.off)
        check(same_bits(carry.cov_diag, k1[0])
              and same_bits(carry.cov_off, k1[1])
              and same_bits(carry.logdet, k1[2]),
              "resume: the refreshed covariance is not K1's on the final "
              "precision")
        print("[resume float64] final state, loop values and history the "
              "same bits (costs from the window's second row); the carry's "
              "covariance is K1's on the final precision, bit for bit",
              flush=True)
    return n


def options_runs(dev, graph_s, state_s):
    """``linesearch="seq"`` on the separate path (K1-K3, fused kernels
    off) at B = 256 and ``ema_alpha=0.5`` on the fused path (K5 and K6;
    the blended iterate's covariance by K1 and its costs by K3 every
    iteration) at B = 256, each counted and held to the plain path with
    the same option in float64 on 8 problems.  Returns the launches."""
    from gaussianvi_tpu_torch import GVIConfig, optimize

    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    cfg_seq = replace(cfg, linesearch="seq", fused_gradient="off")
    cfg_ema = replace(cfg, ema_alpha=0.5)
    (_, h_seq), n_seq = counted(optimize, graph_s, state_s, cfg_seq)
    print(f"[seq path] launches {n_seq}", flush=True)
    check(n_seq["gbp_covariance_logdet"] > NITERS and n_seq["solve"] == NITERS
          and n_seq["quad_phi"] > NITERS and n_seq["quad_moments"] == NITERS
          and n_seq["fused_trials"] == n_seq["fused_gradient"] == 0,
          f"seq: the separate path skipped a kernel: {n_seq}")
    check_costs("seq path", h_seq, B_SEPARATE)
    (_, h_ema), n_ema = counted(optimize, graph_s, state_s, cfg_ema)
    print(f"[ema path] launches {n_ema}", flush=True)
    # K1 and K3: at init, at every blended iterate, and K1 once more for
    # the carry's covariance at the end of the fused-gradient run
    check(n_ema["fused_trials"] == NITERS and n_ema["fused_gradient"] == NITERS
          and n_ema["gbp_covariance_logdet"] == NITERS + 2
          and n_ema["quad_phi"] == NITERS + 1,
          f"ema: the fused path skipped a kernel: {n_ema}")
    check_costs("ema path", h_ema, B_SEPARATE)
    g8, s8 = build_batch(torch.float64, dev, num_problems=8)
    for name, c in (("seq", cfg_seq), ("ema", cfg_ema)):
        hp = optimize(g8, s8, replace(c, chain_impl="seq", quad_impl="xla"))[1]
        held_to_plain(f"{name} kernels vs plain path",
                      optimize(g8, s8, c)[1], hp, dev, tag=f"{name} end to end")
    trials = int(n_seq["quad_phi"]) - 1
    print(f"[seq path] {trials} trial evaluations in {NITERS} iterations "
          f"({TRIALS * NITERS} batched)", flush=True)
    return {"seq": n_seq, "ema": n_ema}


def ltv_problem(dtype, dev, count=None):
    """``(graph, restarts, config)`` of LTV estimation: one problem's graph
    with a restart axis, ``count`` restarts (``perturb_inits``, drawn in
    float64 and cast)."""
    from gaussianvi_tpu_torch.examples.ltv_estimation import (
        build_ltv_estimation,
    )
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel import perturb_inits
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    graph, _, config = build_ltv_estimation(dtype=dtype, device=dev)
    init64 = build_ltv_estimation(device=dev)[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    count = count or LTV_B
    inits = perturb_inits(init64, gen, count, mean_scale=0.3)
    prec = inits.precision
    return _batch_graph(graph, count), GaussianState(
        inits.mu.to(dtype), BlockTridiag(prec.diag.to(dtype),
                                         prec.off.to(dtype))), config


def ltv_runs(card, dev):
    """LTV estimation at B = 1024 restarts under the defaults on the card:
    the engine's resolution printed (its measurement batch is
    ``cost_fn``-only, as in the JAX package: K1 / K2 at s = 2 and the
    plain quadrature), float32 counted, costs finite and non-increasing
    in both dtypes, float32 against float64 (below), the kernel path against the plain path in float64 on 8 restarts, the
    rate.  Returns the launches."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.inference.engine import LocalEngine

    f32, f64 = torch.float32, torch.float64
    g32, i32, cfg = ltv_problem(f32, dev)
    g64, i64, _ = ltv_problem(f64, dev)
    eng = LocalEngine(g32, cfg, dev)
    print(f"[ltv resolution] chain_kernel {eng.chain_kernel}, quad_kernel "
          f"{eng.quad_kernel}, quad_batches {eng.quad_batches}, fused_trials "
          f"{eng.fused_trials_ready}, fused_gradient "
          f"{eng.fused_gradient_ready}", flush=True)
    (s32, h32), n = counted(optimize, g32, i32, cfg)
    print(f"[ltv path] launches {n}", flush=True)
    check(n["gbp_covariance_logdet"] > 0 and n["solve"] == LTV_ITERS
          and all(v == 0 for k, v in n.items()
                  if k not in ("gbp_covariance_logdet", "solve")),
          f"ltv: not K1 / K2 with the plain quadrature: {n}")
    check_costs("ltv path float32", h32, LTV_B, LTV_ITERS)
    s64, h64 = optimize(g64, i64, cfg)
    check_costs("ltv path float64", h64, LTV_B, LTV_ITERS)
    # float32 ends its search, and so escalates the temperature, some
    # iterations before float64 does (the JAX package's float32 too: at
    # iteration 9 of its own example where float64 never does): the costs
    # are held up to each restart's first failed search in either dtype,
    # and the final means, which the escalation barely moves
    rel = ((h32.cost.double() - h64.cost).abs()
           / h64.cost.abs().clamp_min(1e-12))
    failed = (h32.accepted_step == 0) | (h64.accepted_step == 0)
    until = torch.where(failed.any(1), failed.int().argmax(1), LTV_ITERS)
    held = torch.arange(LTV_ITERS, device=dev)[None, :] < until[:, None]
    pre = rel[held].max().item() if held.any() else 0.0
    dmu = (s32.mu.double() - s64.mu).abs().max().item()
    print(f"[ltv path] f32 vs f64: first record max "
          f"{rel[:, 0].max().item():.3e}, before the first failed search "
          f"max {pre:.3e} ({int(held.sum())} records), final means max abs "
          f"{dmu:.3e}; first failed search at iteration median "
          f"{until.float().median().item():.0f}", flush=True)
    check(rel[:, 0].max().item() < 1e-4, "ltv: first-record f32 vs f64")
    check(pre < 1e-4, f"ltv: f32 vs f64 before the first failed search "
          f"{pre:.3e}")
    check(dmu < 1e-4, f"ltv: final means f32 vs f64 {dmu:.3e} apart")
    g8, s8, _ = ltv_problem(f64, dev, 8)
    hp = optimize(g8, s8, replace(cfg, chain_impl="seq", quad_impl="xla"))[1]
    held_to_plain("ltv chain kernels vs plain path", optimize(g8, s8, cfg)[1],
                  hp, dev, tag="ltv end to end")
    r = rate(lambda: optimize(g32, i32, cfg), LTV_B * LTV_ITERS)
    print(f"[throughput] {card}: LTV estimation (K1 / K2 at s = 2, plain "
          f"quadrature) {r:.1f} prob-iters/s (B={LTV_B}, N={h32.mu.shape[2]},"
          f" {LTV_ITERS} iters, f32, median of 3)", flush=True)
    return n


# ---- the planners' patch mode: the window functors in K3 and K6, the
# window prep on the local and factor-parallel engines ----
# The windows the JAX package runs: the point planner's patch_size=8
# (gaussianvi_tpu/examples/point3d_planning.py:70-74, "RECOMMENDED on
# TPU") and the planar planner's 16 (its tests, tests/test_sdf_lanes.py).
# Both planners at their own shapes (B = 1024 restarts, N = 20, 30
# iterations), the full-state rule of the patch mode (41 / 85 nodes).
PATCH = {"planar": 16, "point3d": 8}
# operations of one window-cost evaluation: the whole-field cost's, plus a
# subtraction, a clip and the corner clamps per axis
PATCH_COST_OPS = {"planar": PLANAR_COST_OPS + 12,
                  "point3d": SDF3D_COST_OPS + 18}


def patch_problem(name, dtype, dev, count=None):
    """``(graph, restarts, config, sdf)`` of a planner in the patch mode
    (:func:`restarts`)."""
    from functools import partial

    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )

    build = (build_planar_planning if name == "planar"
             else build_point3d_planning)
    return restarts(partial(build, patch_size=PATCH[name]), dtype, dev,
                    count or PLAN_B)


def patch_operands(name, dev):
    """Operands for K3 and K6 at a planner's shapes in the patch mode, per
    dtype (float64, cast to float32): ``(graph, mu, pd, po, cov_diag)``.
    The 1024 restarts' means, restart 1 on the field's last column (its
    windows end there: the centre node lands on a window's upper edge),
    restart 2 on its last row, restart 3 (3-D) on its last plane, restart
    4 off the field, restart 5 on its first column; the precision a
    sixteenth of the initial one, so that the covariances are 16 times
    wider and a share of the sigma points leaves its window."""
    from gaussianvi_tpu_torch.ops.blocktridiag import (
        BlockTridiag,
        gbp_covariance_logdet,
    )

    f32, f64 = torch.float32, torch.float64
    graph, inits, _, sdf = patch_problem(name, f64, dev)
    mu = inits.mu.clone()
    dims = 2 if name == "planar" else 3
    extent = sdf.origin + (torch.tensor(sdf.data.shape[::-1], dtype=f64,
                                        device=dev) - 1) * sdf.cell_size
    for r, axis in enumerate(range(dims), start=1):
        mu[r, :, axis] = extent[axis]
    mu[4, :, :dims] += torch.tensor([-15.0, 14.0, 3.0][:dims], dtype=f64,
                                    device=dev)
    mu[5, :, 0] = sdf.origin[0]
    pd, po = inits.precision.diag / 16, inits.precision.off / 16
    cd = gbp_covariance_logdet(BlockTridiag(pd, po))[0]
    out = {f64: (graph, mu, pd, po, cd)}
    out[f32] = (patch_problem(name, f32, dev, 1)[0],
                *(x.to(f32) for x in (mu, pd, po, cd)))
    return out


def window_coverage(name, fb, mu, cov):
    """Where the sigma points of factors at ``(mu, cov)`` fall against
    their windows (float64): the share outside, those exactly on a
    window's upper edge, and the windows flush with the field's first and
    last cells; fails where a kind is missing."""
    from gaussianvi_tpu_torch.factors.moments import sigma_points

    dims = 2 if fb.kernel_cost == "planar_patch" else 3
    patch, field = PATCH[name], fb.kernel_field
    origin = fb.kernel_params[0, 4:4 + dims]
    cell = fb.kernel_params[0, 4 + dims]
    first = fb.kernel_prep(mu)[..., -dims:]
    pts = sigma_points(fb.nodes, mu, cov)[..., :dims]
    q = (pts - origin) / cell - first
    outside = float(((q < 0) | (q > patch - 1)).any(-1).double().mean())
    upper = int((q == patch - 1).any(-1).sum())
    last = torch.tensor(field.shape[::-1], device=mu.device) - patch
    low, high = int((first == 0).sum()), int((first == last).sum())
    print(f"[patch kernels] {name}: {100 * outside:.2f}% of the sigma "
          f"points outside their window, {upper} exactly on its upper edge; "
          f"{low} / {high} window axes flush with the field's first / last "
          f"cell", flush=True)
    check(outside > 0.01 and upper > 0 and low > 0 and high > 0,
          f"patch {name}: the operands miss a case of the window clamp")


def patch_kernel_checks(dev):
    """K3 (both variants), K6 ``full`` and K6 ``accum`` (each half of the
    obstacle factors: one rank's shard at fp = 2) with the window functors
    (``PlanarPatchCost`` at s = 4, ``Sdf3dPatchCost`` at s = 6) against
    their plain versions at the planners' shapes: the trial batch [11,
    1024, 20] and the gradient batch [1024, 20] of :func:`patch_operands`,
    each factor's window formed by the batch's prep from its means.
    float64 by :func:`compare_conditioned`, float32 by
    :func:`compare_vs_f64`, K6's main solve by its backward error, each
    kernel twice for the same bits, exact zeros where the plain version
    has them.  Times each in float32 beside its plain version and bound:
    ``{(planner, name): row}``."""
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.inference.graph import take_states
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import quad
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f32, f64 = torch.float32, torch.float64
    rows = {}
    for name in PATCH:
        s = 4 if name == "planar" else 6
        ops_in = patch_operands(name, dev)
        graph64, mu64, _, _, cd64 = ops_in[f64]
        window_coverage(name, graph64.nonlinear[0], mu64, cd64)
        rng = np.random.default_rng(SEED + 3)
        jitter = torch.tensor(0.05 * rng.standard_normal(
            (TRIALS, PLAN_B, PLAN_N, s)), dtype=f64, device=dev)
        args3, args4, x6, ops, halves = {}, {}, {}, {}, {}
        for dt in (f64, f32):
            graph, mu, pd, po, cd = ops_in[dt]
            fb = graph.nonlinear[0]
            mu_t = (mu + jitter.to(dt)).contiguous()
            args3[dt] = (mu_t, cd.expand(TRIALS, *cd.shape).contiguous(),
                         fb.nodes, fb.weights, fb.kernel_cost,
                         fb.kernel_prep(mu_t))
            args4[dt] = (mu, cd, fb.nodes, fb.weights, fb.kernel_cost,
                         fb.kernel_prep(mu))
            nl_specs, lin_specs, nl_arrays, lin_arrays = fused_operands(
                _batch_graph(graph, PLAN_B), trials=False)
            start, nodes, weights, _, field = nl_arrays[0]
            params = fb.kernel_prep(take_states(mu, start, fb.slice_offset,
                                                1))
            ops[dt] = (nl_specs, lin_specs,
                       ((start, nodes, weights, params, field),), lin_arrays)
            x6[dt] = (mu, pd, po, torch.full((PLAN_B,), 0.1, dtype=dt,
                                             device=dev))
            sp, k = nl_specs[0], nl_specs[0].k // 2
            halves[dt] = [
                ((sp._replace(k=k, slice_offset=None),),
                 ((start[i * k:(i + 1) * k], nodes, weights,
                   params[:, i * k:(i + 1) * k], field),))
                for i in range(2)]

        def field_of(dt):
            return ops_in[dt][0].nonlinear[0].kernel_field

        # case -> (kernel, plain version), each of (dtype, part); K6 accum
        # runs on each half of the factors (parts 0 and 1)
        cases = {
            "quad_phi": (
                lambda dt, _: (quad.quad_lanes_phi(*args3[dt], nonneg=True,
                                                   field=field_of(dt)),),
                lambda dt, _: (quad.quad_phi_plain(*args3[dt], nonneg=True,
                                                   field=field_of(dt)),)),
            "quad_moments": (
                lambda dt, _: quad.quad_lanes_moments(*args4[dt],
                                                      field=field_of(dt)),
                lambda dt, _: quad.quad_moments_plain(*args4[dt],
                                                      field=field_of(dt))),
            "fused_gradient": (
                lambda dt, _: fg.gradient_lanes(*x6[dt], *ops[dt]),
                lambda dt, _: fg.gradient_plain(*x6[dt], *ops[dt])),
            "fused_gradient_accum": (
                lambda dt, i: fg.gradient_accum_lanes(*x6[dt],
                                                      *halves[dt][i]),
                lambda dt, i: fg.gradient_plain(
                    *x6[dt], halves[dt][i][0], (), halves[dt][i][1], (),
                    mode="accum")),
        }
        errs, solve = {}, {}
        for case, (kern, plain) in cases.items():
            for i in range(2 if case == "fused_gradient_accum" else 1):
                tag = f"patch {name} {case} part {i}"
                k = {dt: check_repeatable(f"{tag} {dt}",
                                          lambda dt=dt: kern(dt, i))
                     for dt in (f64, f32)}
                p = {dt: plain(dt, i) for dt in (f64, f32)}
                held64 = list(zip(k[f64], p[f64], p[f32]))
                held32 = list(zip(k[f32], p[f32], p[f64]))
                if case == "fused_gradient":
                    # output 5, dmu, by its backward error in the float64
                    # plain system Vddmu = dprec + Lambda
                    _, pd, po, _ = x6[f64]
                    vdd = (p[f64][3] + pd, p[f64][4] + po)
                    solve["backward"], _ = compare_backward(
                        f"{tag} dmu float64", k[f64][5], p[f64][5], *vdd)
                    solve["backward32"] = compare_backward_vs_f64(
                        f"{tag} dmu float32", k[f32][5], p[f32][5],
                        p[f64][5], *vdd)
                    held64 = held64[:5] + held64[6:]
                    held32 = held32[:5] + held32[6:]
                errs[case, f64] = max([errs.get((case, f64), 0.0)] + [
                    compare_conditioned(f"{tag}[{j}] float64", a, b_, c)
                    for j, (a, b_, c) in enumerate(held64)])
                errs[case, f32] = max([errs.get((case, f32), 0.0)] + [
                    compare_vs_f64(f"{tag}[{j}] float32", a, b_, c)
                    for j, (a, b_, c) in enumerate(held32)])
                if case.startswith("quad"):
                    got, want = k[f64][0], p[f64][0]
                    check(torch.equal(got == 0, want == 0)
                          and bool((want == 0).any())
                          and bool((want > 0).any()),
                          f"{tag}: exact zeros differ from the plain "
                          f"version's")
        print(f"[patch kernels] {name}: max abs err vs plain, f64 / f32 "
              "(two launches bit-identical each): " + "; ".join(
                  f"{c} {errs[c, f64]:.3e} / {errs[c, f32]:.3e}"
                  for c in cases)
              + f"; K6 dmu backward error f64 {solve['backward']:.3e}, f32 "
              f"{solve['backward32']:.3e}", flush=True)
        fb = ops_in[f32][0].nonlinear[0]
        m, cost = fb.nodes.shape[0], dict(cost=PATCH_COST_OPS[name])
        # the patch mode's rule is the full-state one: no marginal lift
        work = {
            "quad_phi": TRIALS * PLAN_B * PLAN_N * quad_flops(s, m, s, False,
                                                              **cost),
            "quad_moments": PLAN_B * PLAN_N * quad_flops(s, m, s, True,
                                                         **cost),
            "fused_gradient": PLAN_B * PLAN_N * (
                chain_flops(s) + quad_flops(s, m, s, True, **cost)
                + 12 * s**3 + 2 * solve_flops(s)),
            "fused_gradient_accum": PLAN_B * PLAN_N // 2 * (
                chain_flops(s) + quad_flops(s, m, s, True, **cost)
                + 12 * s**3),
        }
        inputs = {"quad_phi": args3[f32][:4] + args3[f32][5:]
                  + (fb.kernel_field,),
                  "quad_moments": args4[f32][:4] + args4[f32][5:]
                  + (fb.kernel_field,),
                  "fused_gradient": (x6[f32], ops[f32][2:]),
                  "fused_gradient_accum": (x6[f32], halves[f32][0][1])}
        for case, (kern, plain) in cases.items():
            rows[name, case] = dict(
                max_abs_err=errs[case, f64], err_dtype="float64",
                ms=cuda_ms(lambda: kern(f32, 0)),
                ms_flushed_l2=cuda_ms_flushed(lambda: kern(f32, 0)),
                plain_ms=cuda_ms(lambda: plain(f32, 0), reps=1),
                **bound(inputs[case], kern(f32, 0), work[case]))
    return rows


def nudge_horizon(run, state, rtol=1e-9):
    """How many leading iterations the float64 run ``run(state)`` keeps
    within ``rtol`` of itself, with the same steps, from means nudged by
    1e-15 of their size: the horizon over which two correct orders of the
    same sums can be held to ``rtol`` (PERF.md section 2's gate; a
    kernel's rounding departs less than such a nudge).  Returns
    ``(horizon, relative cost differences per iteration)``."""
    from gaussianvi_tpu_torch.inference.graph import GaussianState

    gen = torch.Generator(device=state.mu.device).manual_seed(SEED + 1)
    nudged = GaussianState(state.mu * (1 + 1e-15 * torch.randn(
        state.mu.shape, generator=gen, dtype=state.mu.dtype,
        device=state.mu.device)), state.precision)
    a, b_ = run(state), run(nudged)
    rel = ((a.cost - b_.cost).abs() / b_.cost.abs()).max(0).values
    apart = (rel > rtol) | (a.accepted_step != b_.accepted_step).any(0)
    horizon = int(apart.int().argmax()) if apart.any() else rel.numel()
    return horizon, rel


def held_over(name, got, want, horizon, dev, tag):
    """:func:`held_to_plain` over the first ``horizon`` iterations."""
    from types import SimpleNamespace

    def cut(h):
        return SimpleNamespace(cost=h.cost[:, :horizon],
                               accepted_step=h.accepted_step[:, :horizon])

    held_to_plain(f"{name} (first {horizon} iterations)", cut(got),
                  cut(want), dev, tag=tag)


def patch_runs(card, dev):
    """Both planners in the patch mode under the defaults on the card:
    the fused trial kernel off (K1 and K3 phi take the trials, each
    trial's windows formed from its means), K6 ``full`` once an iteration
    with the current means' windows; costs finite and non-increasing;
    float32 against float64 by the s = 6 gates; 8 restarts in float64
    against the same routes' plain versions on the CPU (rtol 1e-9, the
    same steps, over the iterations a 1e-15 nudge allows); the rate and
    busy share beside the default (whole-field, fused) path.  Returns
    ``{planner: launches}``."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.inference.engine import LocalEngine
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.inference.optimize import run_gvi
    from gaussianvi_tpu_torch.ops.blocktridiag import BlockTridiag
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    counts = {}
    for name in PATCH:
        graph32, inits32, cfg, sdf = patch_problem(name, f32, dev)
        graph64, inits64, _, _ = patch_problem(name, f64, dev)
        (state32, hist32), n = counted(optimize, graph32, inits32, cfg)
        counts[name] = n
        print(f"[patch {name}] launches {n}", flush=True)
        check(n["fused_trials"] == 0 and n["fused_gradient"] == PLAN_ITERS
              and n["quad_phi"] == PLAN_ITERS + 1
              and n["gbp_covariance_logdet"] > PLAN_ITERS
              and n["quad_moments"] == n["solve"] == 0,
              f"patch {name}: not K1 + K3 phi for the trials and K6 for the "
              f"gradient: {n}")
        check_costs(f"patch {name}", hist32, PLAN_B, PLAN_ITERS, nonneg=True)
        dims = 2 if name == "planar" else 3
        clear = int((sdf.signed_distance(state32.mu[..., :dims]).amin(-1)
                     > 0).sum())
        print(f"[patch {name}] {clear}/{PLAN_B} restarts end clear of the "
              f"obstacle; final cost median "
              f"{float(hist32.cost[:, -1].median()):.4f}", flush=True)
        f32_vs_f64(f"patch {name}", hist32, optimize(graph64, inits64,
                                                     cfg)[1], 1e-3)
        s8 = subset(inits64, 8)
        g8c = _batch_graph(patch_problem(name, f64, cpu, 1)[0], 8)
        s8c = GaussianState(s8.mu.cpu(), BlockTridiag(
            s8.precision.diag.cpu(), s8.precision.off.cpu()))
        hk = optimize(graph64, s8, cfg)[1]
        horizon, rel_n = nudge_horizon(
            lambda s: optimize(graph64, s, cfg)[1], s8)
        hp = run_gvi(LocalEngine(g8c, cfg, dev), s8c, cfg)[1]
        rel = ((hk.cost - hp.cost.to(dev)).abs() / hp.cost.to(dev).abs()
               ).max(0).values
        print(f"[patch end to end] {name}: kernels vs the same routes' plain "
              f"versions (CPU) max relative cost difference {rel.max():.1e} "
              f"over {PLAN_ITERS} iterations; a 1e-15 nudge of the means "
              f"moves the kernel run {rel_n.max():.1e} (within 1e-9 for "
              f"{horizon})", flush=True)
        check(horizon >= 6, f"patch {name}: rounding grows within "
              f"{horizon} iterations")
        held_over(f"patch {name} kernels vs plain versions (CPU)", hk, hp,
                  horizon, dev, "patch end to end")
        default = (planner_problem if name == "planar"
                   else point3d_problem)(f32, dev)
        runs = {"patch": lambda: optimize(graph32, inits32, cfg),
                "default": lambda: optimize(default[0], default[1],
                                            default[2])}
        line = []
        for path, run in runs.items():
            r = rate(run, PLAN_B * PLAN_ITERS)
            busy, wall, device, ops = busy_share(run)
            line.append(f"{path} {r:.1f} prob-iters/s, busy {100 * busy:.1f}%"
                        f" ({device * 1e3:.2f} ms of device time in a "
                        f"{wall * 1e3:.2f} ms call, {ops} device ops)")
        print(f"[throughput] {card}: {name} planner, patch mode "
              f"(patch_size={PATCH[name]}) vs default: " + "; ".join(line)
              + f" (B={PLAN_B}, N={PLAN_N}, {PLAN_ITERS} iters, f32, rate "
              f"median of 3)", flush=True)
    return counts


def patch_fp_rank(mesh, device, result):
    """The point planner in the patch mode at dp = 1 x fp = 2 (each rank
    forms its shard's windows; K3 phi for the trials, K6 accum / solve),
    8 restarts in float64, counted."""
    from gaussianvi_tpu_torch.parallel import optimize_sharded
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    g8, s8, cfg, _ = patch_problem("point3d", torch.float64, device, 8)
    (state, hist), n, inv, sec = _counted_run(
        lambda: optimize_sharded(_batch_graph(g8, 8), s8, cfg, mesh), mesh)
    return {"patch fp": dict(result(state, hist), launches=n, inventory=inv,
                             seconds=sec)}


def patch_fp_checks(ranks, dev, same):
    """The point planner's patch mode at fp = 2 against one process on the
    card (K6 ``full``): the ranks' bits equal, K6 accum / solve 30 times a
    rank and K5 never, 1e-9 and the same steps over the iterations a
    1e-15 nudge allows.  Returns rank 0's launches."""
    from types import SimpleNamespace

    from gaussianvi_tpu_torch import optimize

    got = ranks[0]["patch fp"]
    same(got, ranks[1]["patch fp"], "patch point3d fp=2")
    for r in (0, 1):
        n = ranks[r]["patch fp"]["launches"]
        print(f"[patch point3d fp=2] rank {r}: launches {n}", flush=True)
        check(n["fused_gradient_accum"] == n["fused_gradient_solve"]
              == P3_ITERS and n["fused_trials"] == n["fused_gradient"] == 0
              and n["quad_phi"] == P3_ITERS + 1,
              f"patch point3d fp=2 rank {r}: not K3 phi and the split pair "
              f"once an iteration: {n}")
    g8, s8, cfg, _ = patch_problem("point3d", torch.float64, dev, 8)
    horizon, rel_n = nudge_horizon(lambda s: optimize(g8, s, cfg)[1], s8)
    ref = optimize(g8, s8, cfg)[1]
    hist = SimpleNamespace(**{k: torch.as_tensor(got[k], device=dev)
                              for k in ("cost", "accepted_step")})
    rel = ((hist.cost - ref.cost).abs() / ref.cost.abs()).max().item()
    print(f"[patch point3d fp=2] vs one process: max relative cost "
          f"difference {rel:.1e} over {P3_ITERS} iterations (a 1e-15 nudge: "
          f"{rel_n.max():.1e}, within 1e-9 for {horizon})", flush=True)
    check(horizon >= 6, f"patch point3d: rounding grows within {horizon} "
          "iterations")
    held_over("patch point3d fp=2 vs one process", hist, ref, horizon, dev,
              "factor-parallel end to end")
    return got["launches"]


# ---- the samplers: HMC, NUTS and SMC with the chains batched on the card,
# at the flagship's width (N = 32 states of s = 4, D = 128) ----
SAMPLER_N = 32
# transitions cut to keep the phase near a minute: the host's launch pace
# sets it (1.7-4 ms a batched gradient evaluation or NUTS leaf on an H100,
# PERF.md section 6, the samplers' finding); first planned: 300 + 400
# (run_chains), 150 + 250 (nuts_chains), 500 + 1000 (validate_posterior),
# 100 + 100 (the flagship's NUTS)
HMC_C, HMC_WARMUP, HMC_SAMPLES, LEAPFROG = 512, 100, 150, 12
NUTS_C, NUTS_WARMUP, NUTS_SAMPLES, NUTS_DEPTH = 128, 50, 75, 6
FLAG_NUTS_WARMUP, FLAG_NUTS_SAMPLES = 30, 30
SMC_P, SMC_STAGES = 1024, 50
VALIDATE_WARMUP, VALIDATE_SAMPLES = 100, 200
RAW_WARMUP, RAW_SAMPLES = 30, 30
# JAX's posterior-validation thresholds, set for the N = 4 graph of
# tests/test_validation_harness.py: printed beside the report, not gated
# at D = 128 (a single chain's error there scales with the posterior)
JAX_MEAN_ABS, JAX_COV_REL = 0.1, 0.25
# step sizes the stiff GP prior takes (its precision's largest eigenvalue
# is ~4.8e4: the leapfrog is stable below 2 / sqrt(4.8e4) = 0.009)
SAMPLER_EPS0, SMC_EPS = 0.002, 0.003


def sampler_problems(dtype, dev):
    """``(linear, flagship, flagship_init)``: the flagship at N = 32,
    dim_x = 2, and its linear part with a second anchor at the last state
    (a linear-Gaussian chain, on which GVI is exact)."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
        simulate_trajectory,
    )
    from gaussianvi_tpu_torch.factors.priors import fixed_prior
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    flag, flag_init, _ = build_chain_estimation(
        num_states=SAMPLER_N, dim_x=DIM_X, gh_degree=DEGREE, dtype=dtype,
        device=dev)
    anchor, gp = flag.linear
    pos, v0, *_ = simulate_trajectory(SAMPLER_N, DIM_X, 0.1, SEED)
    tail = fixed_prior(SAMPLER_N - 1, np.concatenate([pos[-1], v0]),
                       0.01 * np.eye(2 * DIM_X), dtype=dtype, device=dev)
    linear = FactorGraph(num_states=SAMPLER_N, state_dim=2 * DIM_X,
                         linear=(anchor, tail, gp))
    return linear, flag, flag_init


def split_graph(graph):
    """(linear part, nonlinear part) of a one-problem graph."""
    from gaussianvi_tpu_torch.inference.graph import FactorGraph

    return (FactorGraph(num_states=graph.num_states,
                        state_dim=graph.state_dim, linear=graph.linear),
            FactorGraph(num_states=graph.num_states,
                        state_dim=graph.state_dim,
                        nonlinear=graph.nonlinear))


def gaussian_of(log_density, dim, dtype, dev):
    """Mean and precision of a Gaussian log density (its gradient is
    -H (x - m): at 0 it gives H m, at the unit vectors the columns of H),
    in float64."""
    from gaussianvi_tpu_torch.samplers.hmc import value_and_grad

    eye = torch.eye(dim, dtype=dtype, device=dev)
    _, g = value_and_grad(log_density, torch.cat([torch.zeros_like(eye[:1]),
                                                  eye]))
    g = g.double()
    prec = g[0] - g[1:]
    prec = 0.5 * (prec + prec.T)
    return torch.linalg.solve(prec, g[0]), prec


def exact_draws(mean, prec, count, seed):
    """``count`` draws of N(mean, prec^-1) through the Cholesky of prec."""
    gen = torch.Generator(device=mean.device).manual_seed(seed)
    z = torch.randn(count, mean.shape[0], generator=gen, dtype=mean.dtype,
                    device=mean.device)
    chol = torch.linalg.cholesky(prec)
    x = torch.linalg.solve_triangular(chol.T, z.T, upper=True).T
    return mean + x


class Whitened:
    """A log density in the coordinates a Gaussian ``(mean, prec)``
    whitens: ``x = mean + L^-T z`` with ``L L^T = prec`` (the dense mass
    matrix ``prec``; JAX's ``inv_mass`` spells only a diagonal one).  Counts
    its batched evaluations (one gradient of every chain each)."""

    def __init__(self, log_density, mean, prec, dtype):
        prec = prec.double()
        chol = torch.linalg.cholesky(0.5 * (prec + prec.T))
        self.a64 = torch.linalg.solve_triangular(
            chol.T, torch.eye(chol.shape[0], dtype=chol.dtype,
                              device=chol.device), upper=True)
        self.mean64 = mean.double()
        self.a, self.mean = self.a64.to(dtype), mean.to(dtype)
        self.log_density, self.calls = log_density, 0

    def __call__(self, z):
        self.calls += 1
        return self.log_density(self.mean + z @ self.a.T)

    def x64(self, z):
        """Samples ``z [..., D]`` in the graph's coordinates, float64."""
        return self.mean64 + z.double() @ self.a64.T


def pooled_gates(name, samples, mu, var):
    """The three gates on pooled chains ``samples [C, T, D]`` against the
    exact posterior ``(mu, var)``: every coordinate's mean within
    5 sd / sqrt(ESS), the variance's relative error (the repo's
    ``cov_rel_err``: max |error| over the largest variance) <= 10%, the
    rank-normalized R-hat <= 1.05.  Returns the ESS per coordinate."""
    from gaussianvi_tpu_torch.samplers import ess, rank_normalized_rhat

    s = samples.double().cpu().numpy()
    check(np.isfinite(s).all(), f"{name}: non-finite samples")
    flat = s.reshape(-1, s.shape[-1])
    n_eff = ess(s)
    rhat = rank_normalized_rhat(s)
    z = np.abs(flat.mean(0) - mu) / np.sqrt(var / n_eff)
    rel = np.abs(flat.var(0, ddof=1) - var).max() / var.max()
    print(f"[samplers] {name}: mean within {z.max():.2f} sd/sqrt(ESS) "
          f"(gate 5), variance relative error {rel:.4f} (gate 0.10), "
          f"rank R-hat max {rhat.max():.4f} (gate 1.05), ESS min "
          f"{n_eff.min():.0f} median {np.median(n_eff):.0f} of "
          f"{flat.shape[0]} draws", flush=True)
    check(z.max() <= 5.0, f"{name}: a mean off by {z.max():.2f} sd/sqrt(ESS)")
    check(rel <= 0.10, f"{name}: variance relative error {rel:.4f}")
    check(rhat.max() <= 1.05, f"{name}: rank R-hat {rhat.max():.4f}")
    return n_eff


def report_rates(card, name, seconds, transitions, evals, chains, n_eff):
    print(f"[samplers] {card}: {name}: {seconds:.2f} s, "
          f"{chains * transitions / seconds:.1f} chain-transitions/s, "
          f"{evals / seconds:.1f} batched gradient evaluations/s "
          f"({chains * evals / seconds:.1f} chain-gradients/s), ESS/s min "
          f"{n_eff.min() / seconds:.1f} median "
          f"{np.median(n_eff) / seconds:.1f}", flush=True)


class SharedDraws:
    """A draw source that serves the same draws on any device: each
    request is filled once from a CPU generator (float64), kept, and handed
    over on ``device``; the card's run and the CPU's thus take the same
    draws."""

    def __init__(self, chains, dim, seed):
        from gaussianvi_tpu_torch.samplers._draws import GeneratorDraws

        self.src = GeneratorDraws(torch.Generator().manual_seed(seed), chains,
                                  dim, torch.float64, torch.device("cpu"))
        self.kept, self.device = {}, torch.device("cpu")

    def _serve(self, key, make):
        if key not in self.kept:
            self.kept[key] = make()
        return tuple(x.to(self.device) for x in self.kept[key])

    def hmc(self, t):
        return self._serve(("hmc", t), lambda: self.src.hmc(t))

    def nuts_momentum(self, t):
        return self._serve(("p", t), lambda: (self.src.nuts_momentum(t),))[0]

    def nuts_depth(self, t, depth, count):
        return self._serve(("depth", t, depth),
                           lambda: self.src.nuts_depth(t, depth, count))

    def smc_stage(self, stage, moves):
        return self._serve(("smc", stage),
                           lambda: self.src.smc_stage(stage, moves))


def card_vs_cpu(dev):
    """The card's samplers against the CPU's on the same draws (float64):
    HMC 20 transitions, NUTS 10 at max_depth 4, SMC 2 stages, the samples
    within 1e-10 and the same accept decisions."""
    from gaussianvi_tpu_torch.samplers import make_log_density
    from gaussianvi_tpu_torch.samplers.hmc import _run_hmc
    from gaussianvi_tpu_torch.samplers.nuts import _run_nuts
    from gaussianvi_tpu_torch.samplers.smc import _run_smc

    cpu = torch.device("cpu")
    out = {}
    runs = {
        "HMC": lambda ld, x0, d: _run_hmc(ld, x0, d, 15, 5, LEAPFROG,
                                          SAMPLER_EPS0, 0.8, 1.0),
        "NUTS": lambda ld, x0, d: _run_nuts(ld, x0, d, 7, 3, 4, SAMPLER_EPS0,
                                            0.8, "iterative"),
    }
    # the chains' start, drawn once on the CPU
    linear, _, _ = sampler_problems(torch.float64, cpu)
    mean, prec = gaussian_of(make_log_density(linear, SAMPLER_N, 4),
                             4 * SAMPLER_N, torch.float64, cpu)
    init = exact_draws(mean, prec, 4, seed=3)
    for name, run in runs.items():
        draws = SharedDraws(4, 4 * SAMPLER_N, seed=7)
        res = {}
        for where in (cpu, dev):
            linear, _, _ = sampler_problems(torch.float64, where)
            draws.device = where
            res[where.type] = run(make_log_density(linear, SAMPLER_N, 4),
                                  init.to(where), draws)
        a, b = res["cpu"], res[dev.type]
        err = (a.samples - b.samples.cpu()).abs().max().item()
        moved = [torch.diff(r.samples.cpu(), dim=1).abs().amax(-1) > 0
                 for r in (a, b)]
        same = torch.equal(*moved)
        print(f"[samplers] card vs CPU, {name}, same draws (f64): samples "
              f"max abs difference {err:.3e}, the same accept decisions "
              f"{same}", flush=True)
        check(err <= 1e-10 and same, f"card vs CPU {name}: {err:.3e}, "
              f"decisions equal {same}")
        out[name] = err
    _, flag, _ = sampler_problems(torch.float64, cpu)
    ref, _ = split_graph(flag)
    mean, prec = gaussian_of(make_log_density(ref, SAMPLER_N, 4),
                             4 * SAMPLER_N, torch.float64, cpu)
    init = exact_draws(mean, prec, 256, seed=4)
    draws = SharedDraws(256, 4 * SAMPLER_N, seed=8)
    res = {}
    for where in (cpu, dev):
        _, flag, _ = sampler_problems(torch.float64, where)
        ref, delta = split_graph(flag)
        draws.device = where
        res[where.type] = _run_smc(
            make_log_density(ref, SAMPLER_N, 4),
            make_log_density(delta, SAMPLER_N, 4), init.to(where), draws,
            0.5, SMC_EPS, 8, 2, 2)
    a, b = res["cpu"], res[dev.type]
    err = (a.particles - b.particles.cpu()).abs().max().item()
    lz = abs(float(a.log_evidence) - float(b.log_evidence))
    print(f"[samplers] card vs CPU, SMC 2 stages, same draws (f64): particles "
          f"max abs difference {err:.3e}, log evidence {lz:.3e}", flush=True)
    check(err <= 1e-10 and lz <= 1e-10
          and int(a.num_stages) == int(b.num_stages) == 2,
          f"card vs CPU SMC: {err:.3e}, {lz:.3e}")
    out["SMC"] = err
    return out


def busy_share(run):
    """Profiler device time over the unprofiled wall of one call of
    ``run`` (after one warm call): ``(busy, wall s, device s, ops)``."""
    from torch.profiler import ProfilerActivity, profile

    def wall():
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall()
    seconds = wall()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.count > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.device_time_total for e in events) / 1e6
    return device / seconds, seconds, device, sum(e.count for e in events)


def samplers_runs(card, dev):
    """The samplers on the card (float32; the card-vs-CPU check float64).
    The linear-Gaussian chain, where GVI is exact: GVI on the card, then
    ``validate_posterior`` (one HMC chain in the graph's coordinates, as in
    JAX), ``run_chains`` (512 chains) and ``nuts_chains`` (128) in the
    coordinates GVI whitens, each held to the exact posterior, and a short
    unit-mass ``run_chains`` in the graph's own coordinates (reported: the
    GP prior's condition number ~2e5 keeps such chains near their starts).
    The flagship with its 32 range factors: ``nuts_chains`` (128 from the
    GVI mean, whitened by GVI) and ``smc_adaptive`` (1024 particles from
    the exact linear part).  The device's busy share over one short
    ``run_chains`` call; then the card against the CPU on the same
    draws."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.ops.blocktridiag import gbp_covariance
    from gaussianvi_tpu_torch.samplers import (
        ess,
        make_log_density,
        nuts_chains,
        rank_normalized_rhat,
        run_chains,
        smc_adaptive,
        validate_posterior,
    )
    from gaussianvi_tpu_torch.samplers import validate as sv

    dtype, dim = torch.float32, 4 * SAMPLER_N
    linear, flag, flag_init = sampler_problems(dtype, dev)
    # the exact posteriors from float64 copies (kappa ~ 2e5)
    linear64, flag64, _ = sampler_problems(torch.float64, dev)

    # GVI on the card, then the exact posterior it must equal
    from gaussianvi_tpu_torch.inference.graph import GaussianState
    from gaussianvi_tpu_torch.ops import BlockTridiag

    cfg = GVIConfig(niters=25, niters_lowtemp=25, step_size_base=0.9,
                    high_temperature=1.0)
    init = GaussianState(flag_init.mu.clone(), BlockTridiag.identity(
        (), SAMPLER_N, 4, 2.0, dtype, dev))
    (gvi, _), launches = counted(optimize, linear, init, cfg)
    ld = make_log_density(linear, SAMPLER_N, 4)
    mean, prec = gaussian_of(make_log_density(linear64, SAMPLER_N, 4), dim,
                             torch.float64, dev)
    cov_diag, _ = gbp_covariance(gvi.precision)
    gvi_mu = gvi.mu.reshape(-1).double()
    gvi_var = torch.diagonal(cov_diag, dim1=-2, dim2=-1).reshape(-1).double()
    exact_var = torch.diagonal(torch.linalg.inv(prec))
    mu_err = ((gvi_mu - mean).abs() / exact_var.sqrt()).max().item()
    var_err = ((gvi_var - exact_var).abs() / exact_var).max().item()
    print(f"[samplers] GVI on the linear chain (f32, launches {launches}): "
          f"mean within {mu_err:.3e} sd of the exact posterior, variances "
          f"within {var_err:.3e} (relative)", flush=True)
    check(mu_err < 0.05 and var_err < 0.05,
          f"GVI is not exact on the linear chain: {mu_err:.3e}, {var_err:.3e}")
    mu_np, var_np = gvi_mu.cpu().numpy(), gvi_var.cpu().numpy()

    # validate_posterior: one HMC chain, as in JAX
    gen = torch.Generator(device=dev).manual_seed(1)
    seen = {}
    hmc = sv.hmc
    sv.hmc = lambda *a, **k: seen.setdefault("result", hmc(*a, **k))
    try:
        t = time.perf_counter()
        report = validate_posterior(linear, gvi, gen, sampler="hmc",
                                    num_samples=VALIDATE_SAMPLES,
                                    num_warmup=VALIDATE_WARMUP,
                                    num_leapfrog=LEAPFROG,
                                    init_step_size=SAMPLER_EPS0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
    finally:
        sv.hmc = hmc
    one = seen["result"].samples.double().cpu().numpy()
    n_eff = ess(one[None])
    z = np.abs(report.sampler_mean - mu_np) / np.sqrt(var_np / n_eff)
    vz = (np.abs(report.sampler_cov_diag - var_np)
          / (var_np * np.sqrt(2.0 / n_eff)))
    print(f"[samplers] validate_posterior (one HMC chain, D = {dim}, "
          f"{VALIDATE_WARMUP} + {VALIDATE_SAMPLES}, {LEAPFROG} leapfrog "
          f"steps): mean_abs_err {report.mean_abs_err:.4f} (JAX's N = 4 "
          f"threshold {JAX_MEAN_ABS}), cov_rel_err {report.cov_rel_err:.4f} "
          f"(JAX's {JAX_COV_REL}); by ESS (min {n_eff.min():.1f}): means "
          f"within {z.max():.2f} sd/sqrt(ESS), variances within "
          f"{vz.max():.2f} of their sd sqrt(2/ESS) (gates 5 and 5)",
          flush=True)
    check(np.isfinite(one).all() and z.max() <= 5.0 and vz.max() <= 5.0,
          f"validate_posterior: {z.max():.2f}, {vz.max():.2f}")
    report_rates(card, "validate_posterior (1 chain)", sec,
                 VALIDATE_WARMUP + VALIDATE_SAMPLES,
                 1 + LEAPFROG * (VALIDATE_WARMUP + VALIDATE_SAMPLES), 1,
                 n_eff)
    took("samplers: GVI, validate_posterior")

    # run_chains and nuts_chains sample the chain in the coordinates GVI
    # whitens; in the graph's own coordinates the GP prior's condition
    # number (~2e5) keeps unit-mass chains near their starts (measured on
    # a short run after them)
    white = Whitened(ld, gvi.mu.reshape(-1), gvi.precision.to_dense(), dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    z0 = 2.0 * torch.randn(HMC_C, dim, generator=gen, dtype=dtype, device=dev)
    t = time.perf_counter()
    # 12 steps of size eps move each whitened mode by x cos T + p sin T,
    # T = 12 eps.  At the default 0.8 dual averaging settles near eps =
    # 0.5, T ~ 2 pi: trajectories end where they began (ESS 22k of 205k
    # draws at 300 + 400); at 0.9-0.95, T ~ pi maps x to -x and freezes
    # each chain's radius (the folded R-hat: 1.06-1.49 on the CPU at these
    # counts); 0.99 gives T ~ pi / 2, near-independent draws (R-hat 1.005)
    res = run_chains(white, z0, gen, num_samples=HMC_SAMPLES,
                     num_warmup=HMC_WARMUP, num_leapfrog=LEAPFROG,
                     target_accept=0.99)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    n_eff = pooled_gates(f"run_chains C={HMC_C}", white.x64(res.samples),
                         mu_np, var_np)
    print(f"[samplers] run_chains: step sizes {res.step_size.min().item():.4f}"
          f"-{res.step_size.max().item():.4f}, mean accept "
          f"{res.accept_prob.mean().item():.3f}", flush=True)
    report_rates(card, f"run_chains C={HMC_C}", sec, HMC_WARMUP + HMC_SAMPLES,
                 white.calls, HMC_C, n_eff)

    white.calls = 0
    z0 = 2.0 * torch.randn(NUTS_C, dim, generator=gen, dtype=dtype,
                           device=dev)
    t = time.perf_counter()
    res = nuts_chains(white, z0, gen, num_samples=NUTS_SAMPLES,
                      num_warmup=NUTS_WARMUP, max_depth=NUTS_DEPTH)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    n_eff = pooled_gates(f"nuts_chains C={NUTS_C}", white.x64(res.samples),
                         mu_np, var_np)
    report_rates(card, f"nuts_chains C={NUTS_C}", sec,
                 NUTS_WARMUP + NUTS_SAMPLES, white.calls, NUTS_C, n_eff)

    # the same chain in its own coordinates, unit mass, from exact draws
    res = run_chains(ld, exact_draws(mean, prec, HMC_C, seed=2).to(dtype),
                     gen, num_samples=RAW_SAMPLES, num_warmup=RAW_WARMUP,
                     num_leapfrog=LEAPFROG, init_step_size=SAMPLER_EPS0)
    s = res.samples.double().cpu().numpy()
    check(np.isfinite(s).all(), "run_chains, own coordinates: non-finite")
    n_eff, rhat = ess(s), rank_normalized_rhat(s)
    print(f"[samplers] run_chains C={HMC_C} in the chain's own coordinates "
          f"(unit mass, {RAW_WARMUP} + {RAW_SAMPLES}, not gated): rank R-hat "
          f"max {rhat.max():.3f}, ESS min {n_eff.min():.0f} median "
          f"{np.median(n_eff):.0f} of {s.shape[0] * s.shape[1]} draws, step "
          f"sizes {res.step_size.min().item():.5f}-"
          f"{res.step_size.max().item():.5f}", flush=True)

    took("samplers: the linear chain's run_chains and nuts_chains")

    # the flagship: NUTS from the GVI mean (whitened by GVI), SMC from the
    # exact linear part
    cfg_flag = GVIConfig(niters=30, niters_lowtemp=30, step_size_base=0.9)
    flag_gvi, _ = optimize(flag, flag_init, cfg_flag)
    fcov, _ = gbp_covariance(flag_gvi.precision)
    f_mu = flag_gvi.mu.reshape(-1).double().cpu().numpy()
    f_sd = torch.diagonal(fcov, dim1=-2, dim2=-1).reshape(-1).double().sqrt()
    f_sd = f_sd.cpu().numpy()
    white = Whitened(make_log_density(flag, SAMPLER_N, 4),
                     flag_gvi.mu.reshape(-1), flag_gvi.precision.to_dense(),
                     dtype)
    gen = torch.Generator(device=dev).manual_seed(4)
    t = time.perf_counter()
    res = nuts_chains(white, torch.zeros(NUTS_C, dim, dtype=dtype, device=dev),
                      gen, num_samples=FLAG_NUTS_SAMPLES,
                      num_warmup=FLAG_NUTS_WARMUP, max_depth=NUTS_DEPTH)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    s = white.x64(res.samples).cpu().numpy()
    check(np.isfinite(s).all(), "flagship NUTS: non-finite samples")
    n_eff, rhat = ess(s), rank_normalized_rhat(s)
    dist = np.abs(s.reshape(-1, dim).mean(0) - f_mu) / f_sd
    print(f"[samplers] flagship nuts_chains C={NUTS_C} ({FLAG_NUTS_WARMUP} "
          f"+ {FLAG_NUTS_SAMPLES}, max_depth {NUTS_DEPTH}): rank R-hat max "
          f"{rhat.max():.4f}, ESS min {n_eff.min():.0f} median "
          f"{np.median(n_eff):.0f}, the mean from GVI's by max "
          f"{dist.max():.3f} / median {np.median(dist):.3f} GVI sd, step "
          f"sizes {res.step_size.min().item():.4f}-"
          f"{res.step_size.max().item():.4f}", flush=True)
    report_rates(card, f"flagship nuts_chains C={NUTS_C}", sec,
                 FLAG_NUTS_WARMUP + FLAG_NUTS_SAMPLES, white.calls,
                 NUTS_C, n_eff)

    ref, delta = split_graph(flag)
    ld_ref = make_log_density(ref, SAMPLER_N, 4)
    r_mean, r_prec = gaussian_of(
        make_log_density(split_graph(flag64)[0], SAMPLER_N, 4), dim,
        torch.float64, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    t = time.perf_counter()
    res = smc_adaptive(ld_ref, make_log_density(delta, SAMPLER_N, 4),
                       exact_draws(r_mean, r_prec, SMC_P, seed=5).to(dtype),
                       gen, num_particles=SMC_P, mutation_step_size=SMC_EPS,
                       max_stages=SMC_STAGES)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    stages, log_z = int(res.num_stages), float(res.log_evidence)
    p_mean = res.particles.double().mean(0).cpu().numpy()
    print(f"[samplers] {card}: flagship smc_adaptive P={SMC_P}: {stages} "
          f"stages (lambda reaches 1 below {SMC_STAGES}: "
          f"{stages < SMC_STAGES}), log evidence {log_z:.4f}, the particles' "
          f"mean from GVI's by max {(np.abs(p_mean - f_mu) / f_sd).max():.3f} "
          f"GVI sd, {sec:.2f} s, "
          f"{stages / sec:.2f} stages/s", flush=True)
    check(stages < SMC_STAGES and np.isfinite(log_z)
          and bool(torch.isfinite(res.particles).all()),
          f"flagship SMC: {stages} stages, log evidence {log_z}")

    took("samplers: the flagship's NUTS and SMC")

    # the device's busy share over one short run_chains call (short: the
    # profiler's own cost grows with the events it records)
    busy, wall, device, ops = busy_share(lambda: run_chains(
        ld, exact_draws(mean, prec, HMC_C, seed=6).to(dtype),
        torch.Generator(device=dev).manual_seed(6), num_samples=3,
        num_warmup=2, num_leapfrog=LEAPFROG, init_step_size=SAMPLER_EPS0))
    print(f"[samplers] {card}: one run_chains call (C={HMC_C}, 5 "
          f"transitions x {LEAPFROG} leapfrog steps, f32): wall {wall:.3f} s, "
          f"{ops} device ops, device time {device:.4f} s, busy {busy:.1%}",
          flush=True)
    took("samplers: busy share")
    card_vs_cpu(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on "
              "the GPU", file=sys.stderr)
        return 1
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import WRAPPERS, _build
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    set_precision_policy()
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # registers / spill stores + loads (bytes) per instance of the six
    # redesigned kernels, by cost functor (range, planar_sdf) where the
    # kernel evaluates one; grad_kernel's modes: 0 full, 1 accum, 2 solve;
    # quad_kernel's variants: 0 phi, 1 moments (K3 and K4)
    def instance(r):
        if r["kernel"] in ("grad_kernel", "grad_s6_kernel", "quad_kernel"):
            return f" mode {r['ints'][-1]}"
        if r["kernel"] == "gbp_wide_kernel":   # 1: K1's trial form
            return f" trials {r['ints'][-1]}"
        return ""

    # (K4 builds its own instances of quad_kernel's moments variant: each
    # instance is listed once)
    print("[ptxas] " + "; ".join(dict.fromkeys(
        f"{r['kernel']}{' ' + r['cost'] if r['cost'] else ''} {r['dtype']} "
        f"s={r['ints'][0]}{instance(r)}"
        f": {r['registers']} regs, spill {r['spill_stores']}+"
        f"{r['spill_loads']} B"
        for r in _build.ptxas_report()
        if r["kernel"] in ("grad_kernel", "trials_kernel", "gbp_kernel",
                           "solve_kernel", "gbp_wide_kernel",
                           "solve_wide_kernel", "quad_kernel",
                           "trials_s6_kernel", "grad_s6_kernel"))),
        flush=True)

    t0 = time.perf_counter()
    graph_b, state_b = {}, {}
    for dtype in (torch.float32, torch.float64):
        graph_b[dtype], state_b[dtype] = build_batch(dtype, dev)
    graph_s, state_s = build_batch(torch.float32, dev, B_SEPARATE)
    print(f"[setup] {B} + {B_SEPARATE} problems built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    took("build and set-up")
    kern = kernel_checks(graph_b, state_b, dev)
    took("K1-K3 checks and times")
    iterate = flagship_iterate(graph_b, state_b)
    kern.update(fused_checks(graph_b, state_b, dev, iterate))
    took("K5 / K6 checks and times")
    kern.update(split_checks(graph_b, dev, iterate))
    took("K6 split pair checks and times")
    layout_checks(dev)
    took("K5 / K6 layouts")
    chain_layout_checks(dev)
    took("K1 / K2 layouts")
    quad_layout_checks(dev)
    took("K3 / K4 layouts")
    kern.update(moments_checks(graph_b, iterate, dev))
    sqrtm_ms = sqrtm_times(iterate, dev)
    took("K4 checks and times, sqrtm_product")

    # the default configuration: on the card, the fused kernels
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    cfg_sep = replace(cfg, fused_trials="off", fused_gradient="off")
    cfg_plain = replace(cfg, chain_impl="seq", quad_impl="xla")
    # block-form moments: K4 takes the gradient moments where K6 is off
    cfg_block = replace(cfg, use_pallas=True, fused_gradient="off")
    # the proximal optimizer at a step it accepts: at step_size_base=0.9
    # every trial of the JKO step is rejected on the flagship (in the JAX
    # package too) and the iterate never moves
    cfg_prox = replace(cfg, step_size_base=0.1)

    # ---- the main path (fused), counted ----
    (state32, hist32), fused_counts = counted(
        optimize, graph_b[torch.float32], state_b[torch.float32], cfg)
    print(f"[fused path] launches {fused_counts}", flush=True)
    check(fused_counts["fused_trials"] == NITERS
          and fused_counts["fused_gradient"] == NITERS,
          f"the fused kernels did not run once per iteration: {fused_counts}")
    check(fused_counts["gbp_covariance_logdet"] > 0
          and fused_counts["quad_phi"] > 0,
          f"the initial covariance / costs skipped their kernels: "
          f"{fused_counts}")
    check_costs("fused path", hist32, B)
    check(bool(torch.isfinite(state32.mu).all())
          and bool(torch.isfinite(state32.precision.diag).all()),
          "non-finite final state")

    # float32 against float64 on the card.  The line search makes discrete
    # accept / fallback decisions that float32 rounding can flip on some
    # problems, after which their trajectories differ by more than rounding
    # (the JAX package's own float32 path shows the same), so the gates are:
    # every problem's first recorded cost (no decision taken yet), the
    # whole history of seed 0 (the JAX package's float32-vs-float64 device
    # gate), and the batch median of the final-cost differences.
    _, hist64 = optimize(graph_b[torch.float64], state_b[torch.float64], cfg)
    cost32 = hist32.cost.double()
    rel = (cost32 - hist64.cost).abs() / hist64.cost.abs().clamp_min(1e-12)
    rel_first = rel[:, 0].max().item()
    rel_seed0 = rel[0].max().item()
    rel_final_median = rel[:, -1].median().item()
    print(f"[fused path] f32 vs f64 relative cost difference: first record "
          f"max {rel_first:.3e}, seed-0 history max {rel_seed0:.3e}, final "
          f"median {rel_final_median:.3e} (final max "
          f"{rel[:, -1].max().item():.3e}, history max {rel.max().item():.3e})",
          flush=True)
    check(rel_first < 1e-4, f"first-record f32 vs f64 {rel_first:.3e}")
    check(rel_seed0 < 1e-3, f"seed-0 f32 vs f64 {rel_seed0:.3e} >= 1e-3")
    check(rel_final_median < 1e-3,
          f"median final f32 vs f64 {rel_final_median:.3e} >= 1e-3")

    # ---- the separate-kernel path, counted ----
    (_, hist_s), sep_counts = counted(optimize, graph_s, state_s, cfg_sep)
    print(f"[separate path] launches {sep_counts}", flush=True)
    sep_names = ("gbp_covariance_logdet", "solve", "quad_phi", "quad_moments")
    check(all(sep_counts[k] > 0 for k in sep_names)
          and sep_counts["fused_trials"] == sep_counts["fused_gradient"] == 0,
          f"the separate path skipped a kernel: {sep_counts}")
    check_costs("separate path", hist_s, B_SEPARATE)

    # ---- block-form moments path (K4), counted ----
    (_, hist_a), block_counts = counted(
        optimize, graph_b[torch.float32], state_b[torch.float32], cfg_block)
    print(f"[block-moments path] launches {block_counts}", flush=True)
    check(block_counts["fused_moments"] == NITERS
          and block_counts["solve"] == NITERS
          and block_counts["fused_trials"] == NITERS
          and block_counts["fused_gradient"] == 0
          and block_counts["quad_moments"] == 0,
          f"the block-form moments path took other kernels: {block_counts}")
    check_costs("block-moments path", hist_a, B)

    # ---- proximal optimizer, counted ----
    (state_p, hist_p), prox_counts = counted(
        optimize, graph_b[torch.float32], state_b[torch.float32], cfg_prox,
        "prox")
    print(f"[prox path] launches {prox_counts}", flush=True)
    check(prox_counts["quad_moments"] == NITERS
          and prox_counts["fused_trials"] == NITERS
          and prox_counts["gbp_covariance_logdet"] == NITERS + 1
          and prox_counts["fused_gradient"] == prox_counts["solve"]
          == prox_counts["fused_moments"] == 0,
          f"the prox path took other kernels: {prox_counts}")
    check(hist_p.cost.shape == (B, NITERS)
          and bool(torch.isfinite(hist_p.cost).all())
          and bool(torch.isfinite(state_p.mu).all())
          and bool(torch.isfinite(state_p.precision.diag).all()),
          "prox path: non-finite cost or state")
    moved = int((hist_p.accepted_step > 0).any(1).sum())
    falls = int((hist_p.cost[:, -1] < hist_p.cost[:, 0]).sum())
    print(f"[prox path] {moved}/{B} problems accepted a step, {falls}/{B} "
          f"ended below their first cost", flush=True)
    check(moved > B // 2, f"prox path: only {moved}/{B} problems moved")

    took("flagship paths")
    # ---- factor-parallel path: rank processes on this card, counted ----
    shard_counts, shard_rate, shard_extra = sharded_path(cfg, dev, optimize)
    took("factor-parallel and sequence-parallel paths")
    assoc = assoc_checks(dev, cfg)
    took("log-depth chain")

    # ---- kernels against plain versions, end to end (float64) ----
    g8, s8 = build_batch(torch.float64, dev, num_problems=8)
    g8c, s8c = build_batch(torch.float64, torch.device("cpu"), num_problems=8)
    _, hk = optimize(g8, s8, cfg)
    _, hc = optimize(g8c, s8c, replace(cfg, fused_trials="on",
                                       fused_gradient="on"))
    _, hs = optimize(g8, s8, cfg_sep)
    _, hp = optimize(g8, s8, cfg_plain)
    _, ha = optimize(g8, s8, cfg_block)
    pairs = [("fused kernels vs fused plain versions (CPU)", hk, hc, 1e-9),
             ("fused kernels vs plain path", hk, hp, 1e-9),
             ("separate kernels vs plain path", hs, hp, 1e-9),
             ("block-form moments vs separate kernels", ha, hs, 1e-9)]
    # prox: kernels against the plain path with the root pinned to each
    # method, then the two methods against each other
    from gaussianvi_tpu_torch.ops import psd

    auto, prox_final = psd.AUTO_METHOD["cuda"], {}
    for method in ("eigh", "newton"):
        psd.AUTO_METHOD["cuda"] = method
        _, hpk = optimize(g8, s8, cfg_prox, "prox")
        _, hpp = optimize(g8, s8, replace(cfg_prox, chain_impl="seq",
                                          quad_impl="xla"), "prox")
        # Denman-Beavers works on B = A (A + 4 s I), kappa(B) ~ kappa(A)^2,
        # and the GP prior's edge marginals are stiff: the root amplifies
        # the kernels' 1e-13 differences to its conditioning floor (the JAX
        # package measured 1.9e-8 at kappa(A) = 1e8), hence 1e-6 for newton
        pairs.append((f"prox ({method}) kernels vs plain path", hpk, hpp,
                      1e-9 if method == "eigh" else 1e-6))
        prox_final[method] = hpk.cost[:, -1]
    psd.AUTO_METHOD["cuda"] = auto
    rel_root = ((prox_final["eigh"] - prox_final["newton"]).abs()
                / prox_final["eigh"].abs()).max().item()
    print(f"[end to end] prox final cost, eigh vs newton root (f64, 8 "
          f"problems): max relative difference {rel_root:.3e}", flush=True)
    # the same conditioning floor sets this gate
    check(rel_root < 1e-6, f"prox eigh vs newton differ: {rel_root:.3e}")
    for name, got, want, rtol in pairs:
        held_to_plain(name, got, want, dev, rtol)
    took("flagship end to end")

    # ---- throughput: fused, separate and plain paths (float32) ----
    def flagship(config, method="ngd", runs=3):
        return rate(lambda: optimize(graph_b[torch.float32],
                                     state_b[torch.float32], config, method),
                    B * NITERS, runs)

    rates = {"fused": flagship(cfg), "separate": flagship(cfg_sep),
             "plain": flagship(cfg_plain, runs=1), "block": flagship(cfg_block),
             "block_sep": flagship(replace(cfg_block, fused_trials="off")),
             "prox": flagship(cfg_prox, "prox")}
    print(f"[throughput] {card}: fused kernels {rates['fused']:.1f}, "
          f"separate kernels {rates['separate']:.1f}, plain PyTorch "
          f"{rates['plain']:.1f}, block-form moments {rates['block']:.1f} "
          f"(with separate trials {rates['block_sep']:.1f}), prox "
          f"{rates['prox']:.1f} prob-iters/s (B={B}, N={N}, {NITERS} iters, "
          f"f32, median of 3, plain one run)", flush=True)
    print(f"[throughput] {card}: factor-parallel dp=1 x fp=2 "
          f"{shard_rate:.1f} prob-iters/s: two ranks time-slicing one card "
          f"over gloo, no scaling number (B={B}, N={N}, {NITERS} iters, f32, "
          f"median of 3, the slower rank)", flush=True)
    for name, r in kern.items():
        flushed = (f" ({r['ms_flushed_l2']:.4f} ms with the L2 flushed "
                   f"before each call)" if "ms_flushed_l2" in r else "")
        library = (f", library {r['library_ms']:.4f} ms"
                   if "library_ms" in r else "")
        print(f"[kernel time] {card}: {name} {r['ms']:.4f} ms{flushed}, plain "
              f"{r['plain_ms']:.4f} ms{library}, bound {r['bound_ms']:.5f} ms "
              f"by {r['bound_by']} (f32, slice shapes)", flush=True)
    k4 = kern["fused_moments"]
    print(f"[kernel time] {card}: K4 {k4['ms']:.4f} ms vs K3 moments "
          f"{k4['k3_moments_ms']:.4f} ms on the same {B * N} factors (f32, 29 "
          f"nodes; one kernel body, quad.cuh)", flush=True)
    print(f"[sqrtm_product] {card}: " + ", ".join(
        f"{shape} {method} {ms:.3f} ms"
        for (shape, method), ms in sqrtm_ms.items()) + " (f32)", flush=True)

    took("flagship throughput")
    # ---- the planar planner: kernels at its shapes, its paths ----
    plan_kern = planner_kernel_checks(dev)
    took("planner kernel checks and times")
    plan_counts, _ = planner_runs(card, dev)
    took("planner paths")
    for name, r in plan_kern.items():
        print(f"[kernel time] {card}: planner {name} {r['ms']:.4f} ms "
              f"({r['ms_flushed_l2']:.4f} ms with the L2 flushed before each "
              f"call), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} (f32, planner "
              f"shapes: B={PLAN_B}, N={PLAN_N}, s=4; K3, K5, K6 with the "
              f"13-node rule and the planar SDF cost)", flush=True)

    # ---- s = 6: kernels at the models' shapes, their paths ----
    s6_kern = s6_kernel_checks(dev)
    took("s = 6 kernel checks and times")
    s6_counts, _ = s6_runs(card, dev)
    s6_counts["point3d fp=2"] = shard_extra["p3"]
    took("s = 6 paths")
    for (model, name), r in s6_kern.items():
        print(f"[kernel time] {card}: s=6 {model} {name} {r['ms']:.4f} ms "
              f"({r['ms_flushed_l2']:.4f} ms with the L2 flushed before each "
              f"call), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} (f32, B={S6_B}, "
              f"N={N if model == 'dim_x=3' else P3_N})", flush=True)

    # ---- s = 14 and s = 1: K1 / K2 at the arm's and Barfoot's shapes, the
    # arm planner and the Barfoot example ----
    wide_kern = wide_kernel_checks(dev)
    took("s = 14 / s = 1 kernel checks and times")
    arm_counts, _ = arm_runs(card, dev)
    took("arm planner path")
    barfoot_counts = barfoot_runs(dev)
    took("Barfoot 1-D")
    for (s, name), r in wide_kern.items():
        library = ("" if r["library_ms"] is None
                   else f", library {r['library_ms']:.4f} ms")
        shapes = ("11 x 1024 x 10 factors / 1024 x 10: the arm's K3"
                  if name.startswith("quad") else
                  "11 x 1024 chains of N = 10 / the pair of 1024: the arm's"
                  if s == 14 else "11 x 1024 chains of N = 1 / the pair of "
                  "1024: a batch of Barfoot problems")
        if "separate_ms" in r:
            library += (f", the separate route's K1 and glue "
                        f"{r['separate_ms']:.4f} ms")
        print(f"[kernel time] {card}: s={s} {name} {r['ms']:.4f} ms "
              f"({r['ms_flushed_l2']:.4f} ms with the L2 flushed before each "
              f"call), plain {r['plain_ms']:.4f} ms{library}, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} (f32, {shapes})",
              flush=True)

    # ---- bfloat16 offsets in K3, K5 and K6, their paths; resume; the
    # sequential line search and EMA; LTV estimation ----
    bf16_kern = {"flagship": bf16_flagship_checks(graph_b, dev, iterate),
                 "point3d": bf16_s6_checks(dev)}
    took("bf16 kernel checks and times")
    bf16_counts = bf16_runs(card, dev, graph_b, state_b, graph_s, state_s)
    took("bf16 paths")
    resume_counts = resume_runs(dev, graph_b, state_b)
    took("resume")
    option_counts = options_runs(dev, graph_s, state_s)
    took("seq and EMA paths")
    ltv_counts = ltv_runs(card, dev)
    took("LTV estimation")
    patch_kern = patch_kernel_checks(dev)
    took("patch_runs: window functors in K3 / K6")
    patch_counts = patch_runs(card, dev)
    took("patch_runs: the planners")
    for (planner, name), r in patch_kern.items():
        print(f"[kernel time] {card}: patch {planner} {name} {r['ms']:.4f} ms "
              f"({r['ms_flushed_l2']:.4f} ms with the L2 flushed), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']} (f32, B={PLAN_B}, N={PLAN_N}, patch_size="
              f"{PATCH[planner]}; accum: half the factors)", flush=True)
    samplers_runs(card, dev)
    took("samplers: card vs CPU")
    for model, rows_ in bf16_kern.items():
        for name, r in rows_.items():
            print(f"[kernel time] {card}: bf16 {model} {name} {r['ms']:.4f} ms "
                  f"({r['ms_flushed_l2']:.4f} ms with the L2 flushed), "
                  f"unquantized {r['unquantized_ms']:.4f} ms "
                  f"({r['unquantized_ms_flushed_l2']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms (f32)", flush=True)

    csrc, jk = "gaussianvi_tpu_torch/csrc/", "gaussianvi_tpu/kernels/"
    # the table's rows: the wrappers of the JAX package's kernels (the
    # arm's K3 wrappers, quad_arm_*, are K3's instance: the s14 entries of
    # quad_phi / quad_moments)
    sources = {
        "gbp_covariance_logdet": ("chain.cuh", "chain_lanes.py:131", "fused"),
        "solve": ("chain.cuh", "chain_lanes.py:418", "separate"),
        "quad_phi": ("quad.cu", "quad_lanes.py:99", "fused"),
        "quad_moments": ("quad.cu", "quad_lanes.py:99", "separate"),
        "fused_moments": ("fused_moments.cu", "fused_moments.py:35",
                          "block_moments"),
        "fused_trials": ("fused_trials.cu", "fused_trials.py:269", "fused"),
        "fused_gradient": ("fused_gradient.cu", "fused_gradient.py:185",
                           "fused"),
        "fused_gradient_accum": ("fused_gradient_accum.cu",
                                 "fused_gradient.py:185", "factor_parallel"),
        "fused_gradient_solve": ("fused_gradient_solve.cu",
                                 "fused_gradient.py:185", "factor_parallel"),
    }
    counts = {"fused": fused_counts, "separate": sep_counts,
              "block_moments": block_counts, "factor_parallel": shard_counts}
    # the planner's launches (fused path at B=1024, separate at B=256) and,
    # for the kernels with the planar SDF cost, their times and bounds at
    # the planner's shapes
    plan_path = {"gbp_covariance_logdet": "fused", "solve": "separate",
                 "quad_phi": "fused", "quad_moments": "separate",
                 "fused_trials": "fused", "fused_gradient": "fused"}
    planner_rows = {
        name: (dict(path=plan_path[name],
                    launches=plan_counts[plan_path[name]][name],
                    **plan_kern.get(name, {}))
               if name in plan_path else
               dict(path=None, launches=0,
                    note="not on the planar planner's paths"))
        for name in WRAPPERS}
    # library_ms: K2's is torch.linalg.solve_ex on the densified pair
    # (dense_solve_ms).  No single PyTorch call computes the others: K1's
    # selected covariance blocks and log det together (a dense inverse
    # gives the blocks, a Cholesky the log det), a block-Thomas pass inside
    # the fused kernels, or sigma-point moments of a cost given as code.
    # bound_ms counts every tensor the wrapper is handed, read once, and
    # every tensor it returns, written once; the redesigned kernels have no
    # scratch and no layout copy in device memory, so ms is the kernel
    # alone.  ms: the operands warm in L2 (back-to-back calls);
    # ms_flushed_l2: the L2 flushed before each call (the redesigned
    # kernels).
    no_library = ("no single PyTorch call computes this function: "
                  + ("selected blocks of the inverse and the log det "
                     "together" if name == "gbp_covariance_logdet" else
                     "a custom fused or quadrature function")
                  for name in sources)
    # the s = 6 instances: each model's launches (the point planner's
    # fused path at B = 1024, its separate path for K2 and K3 moments, the
    # quadrotor's K1 / K2, chain estimation at dim_x = 3 fused, and
    # block-form for K4) and, where measured, their times and bounds
    s6_path = {"gbp_covariance_logdet": ("point3d fused", "dim_x=3 fused",
                                         "quadrotor"),
               "solve": ("point3d separate", "quadrotor", "dim_x=3 block"),
               "quad_phi": ("point3d fused", "dim_x=3 fused"),
               "quad_moments": ("point3d separate",),
               "fused_moments": ("dim_x=3 block",),
               "fused_trials": ("point3d fused", "dim_x=3 fused"),
               "fused_gradient": ("point3d fused", "dim_x=3 fused"),
               # the split pair at s = 6: the point planner on a
               # dp = 1 x fp = 2 mesh, rank 0's launches; dim_x = 3's times
               # are printed with the [kernel time] lines
               "fused_gradient_accum": ("point3d fp=2",),
               "fused_gradient_solve": ("point3d fp=2",)}
    s6_sources = {"fused_trials": "fused_trials_s6.cu",
                  "fused_gradient": "fused_gradient_s6.cu",
                  "fused_gradient_accum": "fused_gradient_accum_s6.cu",
                  "fused_gradient_solve": "fused_gradient_solve_s6.cu"}

    def s6_row(name):
        row = {}
        for path in s6_path[name]:
            model = path.split(" ")[0]
            row[path] = dict(launches=s6_counts[path][name],
                             **s6_kern.get((model, name), {}))
            if name in s6_sources:
                row[path]["source"] = csrc + s6_sources[name]
        return row

    # the s = 14 and s = 1 instances (csrc/chain_wide.cu, and the arm's K3
    # in csrc/quad_arm.cu): their launches on the arm planner's path at
    # B = 1024 and on Barfoot's NGD run, their times and bounds at the
    # shapes of wide_kernel_checks
    wide_paths = {14: ("arm default", arm_counts),
                  1: ("barfoot ngd", barfoot_counts["ngd"])}
    arm_quad = {"quad_phi": "quad_arm_phi", "quad_moments": "quad_arm_moments"}

    def wide_row(s, name):
        if (s, name) not in wide_kern:
            return dict(note=f"not on the s = {s} model's path (K1 / K2 and "
                        + ("the arm's K3)" if s == 14
                           else "the plain quadrature)"))
        path, n = wide_paths[s]
        source = ("quad_arm.cu" if name in arm_quad else "chain_wide.cu"
                  if s == 14 else "chain.cuh via chain_wide.cu")
        row = dict(path=path, launches=n[arm_quad.get(name, name)],
                   source=csrc + source, **wide_kern[s, name])
        if (s, name) == (14, "gbp_covariance_logdet"):
            # K1's trial form: the line search's chains on the arm's path
            row["trial_form"] = dict(launches=n["gbp_trials"],
                                     **wide_kern[14, "gbp_trials"])
        return row

    # the bfloat16 instances: their launches on the bfloat16 paths (fused
    # at B = 1024, separate at B = 256), their times beside the
    # unquantized instances', the unquantized instances' bounds (the same
    # bytes and, within two operations an offset, the same work)
    bf16_path = {"gbp_covariance_logdet": "bf16 fused",
                 "quad_phi": "bf16 fused", "quad_moments": "bf16 separate",
                 "fused_trials": "bf16 fused", "fused_gradient": "bf16 fused",
                 "solve": "bf16 separate"}
    unquantized = {"flagship": lambda name: kern[name],
                   "point3d": lambda name: s6_kern["point3d", name]}

    def bf16_row(name):
        row = {}
        if name in bf16_path:
            row["launches"] = {bf16_path[name]:
                               bf16_counts[bf16_path[name]][name]}
        for model, rows_ in bf16_kern.items():
            if name not in rows_:
                continue
            ref = unquantized[model](name)
            row[model] = dict(rows_[name], bound_ms=ref["bound_ms"],
                              bound_by=ref["bound_by"])
        if name in ("fused_gradient_accum", "fused_gradient_solve"):
            row["launches"] = {"bf16 fp=2": fp_bf16[name]}
        return row

    # the factor-parallel path with the loop's options (8 problems, rank
    # 0) and the sequence-parallel path with K3 (rank 0)
    fp_bf16 = shard_extra["options"]["fp bf16"]

    check(all(bf16_counts[p][name] > 0 for name, p in bf16_path.items()),
          "a kernel was launched on none of the bf16 paths")

    # the patch mode's instances: launches on each planner's patch-mode
    # path at B = 1024 (and the point planner's at fp = 2, rank 0), times
    # and bounds of the window functors' instances at those shapes
    patch_sources = {
        "quad_phi": ("quad.cu", "quad.cu"),
        "quad_moments": ("quad.cu", "quad.cu"),
        "fused_gradient": ("fused_gradient.cu", "fused_gradient_s6.cu"),
        "fused_gradient_accum": ("fused_gradient_accum.cu",
                                 "fused_gradient_accum_s6.cu")}

    def patch_row(name):
        row = {}
        for planner, src in zip(PATCH, patch_sources.get(name, (None,) * 2)):
            row[planner] = dict(launches=patch_counts[planner][name],
                                **patch_kern.get((planner, name), {}))
            if src:
                row[planner]["source"] = csrc + src
        row["point3d fp=2"] = dict(launches=shard_extra["patch"][name])
        return row

    check(all(patch_counts[p][name] > 0 for p in PATCH
              for name in ("quad_phi", "fused_gradient"))
          and shard_extra["patch"]["fused_gradient_accum"] > 0,
          "a window functor's instance was launched on none of its paths")
    option_paths = {"resume": resume_counts, "seq": option_counts["seq"],
                    "ema": option_counts["ema"], "ltv": ltv_counts,
                    **shard_extra["options"], "sp lanes": shard_extra["sp"]}
    check(all(wide_row(s, name)["launches"] > 0 for s, name in wide_kern),
          "an s = 14 or s = 1 kernel was launched on none of its paths")
    rows = [dict(name=name, route="cuda", source=csrc + sources[name][0],
                 replaces=jk + sources[name][1], path=sources[name][2],
                 launches=counts[sources[name][2]][name],
                 max_abs_err=kern[name]["max_abs_err"],
                 err_dtype=kern[name]["err_dtype"], ms=kern[name]["ms"],
                 ms_flushed_l2=kern[name].get("ms_flushed_l2"),
                 plain_ms=kern[name]["plain_ms"],
                 bound_ms=kern[name]["bound_ms"],
                 bound_by=kern[name]["bound_by"],
                 library_ms=kern[name].get("library_ms"),
                 **({} if "library_ms" in kern[name]
                    else {"library_note": note}),
                 planner=planner_rows[name], s6=s6_row(name),
                 s14=wide_row(14, name), s1=wide_row(1, name),
                 bf16=bf16_row(name), patch=patch_row(name),
                 option_launches={p: c[name] for p, c in option_paths.items()},
                 assoc=({"note": "chain_impl='assoc' replaces K1 / K2 by "
                         "torch ops (the JAX package runs it on XLA); held "
                         "and timed against them", **assoc}
                        if name in ("gbp_covariance_logdet", "solve")
                        else None))
            for name, note in zip(sources, no_library)]
    check(all(v["launches"] > 0 for name in s6_path
              for v in s6_row(name).values()),
          "an s = 6 kernel was launched on none of its paths")
    check(all(r["launches"] > 0 for r in rows),
          f"a kernel was launched on no path: {rows}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
