"""GPU smoke run of the PyTorch port (``gaussianvi_tpu_torch``) on one card.

Builds the CUDA kernels from ``gaussianvi_tpu_torch/csrc``, holds each of
the four kernel entry points against its plain PyTorch version at the
flagship's shapes (float64 and float32, plus the pivot-trust and
nonneg-band guard cases), then drives the flagship NGD path
(``examples.chain_estimation`` -> ``optimize``) at B=1024 problems, N=32
states, dim_x=2, the 29-node degree-4 marginal rule, 10 iterations, and
checks the result: every launch counter moved, every cost finite,
non-increasing and positive, float32 close to float64 (see ``main``), and
the kernel path equal to the plain path on a small batch.  Prints the timings
with the card's name and power limit, one JSON line of per-kernel results,
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, N, DIM_X, DEGREE, NITERS = 1024, 32, 2, 4, 10
TRIALS = 11                     # niters_backtrack + 1 line-search trials
SEED = 0


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


def cuda_ms(fn, reps=10):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
        # K2 on the solve pair: 2 x 1024 chains
        d2, o2, rhs = spd_chains(2 * B, N, 4, rng, dtype, dev)
        shape2 = (2, B)
        d2, o2 = d2.reshape(*shape2, N, 4, 4), o2.reshape(*shape2, N - 1, 4, 4)
        rhs = rhs.reshape(*shape2, N, 4)
        err2 = compare(f"K2 x {dtype}", chain.solve_lanes(d2, o2, rhs),
                       chain.solve_plain(d2, o2, rhs), *tol_chain)
        # K3 on real marginal means and params, covariances from K1
        mu = state_b[dtype].mu + 0.05 * torch.tensor(
            rng.standard_normal((TRIALS, B, N, 4)), dtype=dtype, device=dev)
        cov = k1[0]
        args3 = (mu, cov, fb.nodes, fb.weights, "range", fb.kernel_params)
        err3 = compare(f"K3 phi {dtype}",
                       quad.quad_lanes_phi(*args3, nonneg=True),
                       quad.quad_phi_plain(*args3, nonneg=True), *tol_quad)
        args4 = (mu[0], cov[0], fb.nodes, fb.weights, "range",
                 fb.kernel_params)
        km = quad.quad_lanes_moments(*args4, rdim=fb.quad_rdim)
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
                        reps=3)),
            "solve": (cuda_ms(lambda: chain.solve_lanes(d2, o2, rhs)),
                      cuda_ms(lambda: chain.solve_plain(d2, o2, rhs), reps=3)),
            "quad_phi": (
                cuda_ms(lambda: quad.quad_lanes_phi(*args3, nonneg=True)),
                cuda_ms(lambda: quad.quad_phi_plain(*args3, nonneg=True))),
            "quad_moments": (
                cuda_ms(lambda: quad.quad_lanes_moments(*args4, rdim=2)),
                cuda_ms(lambda: quad.quad_moments_plain(*args4, rdim=2))),
        }
        errs = {"gbp_covariance_logdet": err1, "solve": err2,
                "quad_phi": err3, "quad_moments": err4}
        for name, (ms, plain_ms) in times.items():
            results[name] = dict(max_abs_err=errs[name], ms=ms,
                                 plain_ms=plain_ms)
    return results


def guard_cases(dtype, dev):
    """Pivot-trust and nonneg-band poisoning agree between kernel and plain."""
    from gaussianvi_tpu_torch.kernels import chain, quad

    eps = torch.finfo(dtype).eps
    eye = torch.eye(2, dtype=dtype, device=dev)
    # chain 0: Schur pivot D1 - B^T D0^-1 B cancels to ~1 ulp; chain 1 healthy
    diag = torch.stack([torch.stack([eye, (1 + 2 * eps) * eye]),
                        torch.stack([eye, 2 * eye])])
    off = torch.stack([eye[None], eye[None]])
    ld_k = chain.gbp_covariance_logdet_lanes(diag, off)[2]
    ld_p = chain.gbp_covariance_logdet_plain(diag, off)[2]
    check(bool(torch.isnan(ld_k[0])) and bool(torch.isnan(ld_p[0])),
          f"pivot-trust case not poisoned ({dtype})")
    check(bool(torch.isfinite(ld_k[1])), f"healthy chain poisoned ({dtype})")
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


def build_batch(dtype, dev, num_problems=None):
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    graphs, states = [], []
    for seed in range(num_problems or B):
        g, s, _ = build_chain_estimation(num_states=N, dim_x=DIM_X,
                                         gh_degree=DEGREE, seed=seed,
                                         dtype=dtype, device=dev)
        graphs.append(g)
        states.append(s)
    return stack_problems(graphs, states)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs only on "
              "the GPU", file=sys.stderr)
        return 1
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import (
        WRAPPERS, _build, launch_counts, reset_launch_counts,
    )
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

    t0 = time.perf_counter()
    graph_b, state_b = {}, {}
    for dtype in (torch.float32, torch.float64):
        graph_b[dtype], state_b[dtype] = build_batch(dtype, dev)
    print(f"[setup] {B} problems built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    kern = kernel_checks(graph_b, state_b, dev)

    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    cfg_plain = GVIConfig(niters=NITERS, niters_lowtemp=NITERS,
                          step_size_base=0.9, chain_impl="seq",
                          quad_impl="xla")

    # ---- the main path, counted ----
    torch.cuda.synchronize()
    reset_launch_counts()
    state32, hist32 = optimize(graph_b[torch.float32], state_b[torch.float32],
                               cfg)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[main path] launches {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path was never launched: {launches}")

    cost32 = hist32.cost.double()
    check(cost32.shape == (B, NITERS), f"history shape {cost32.shape}")
    check(bool(torch.isfinite(cost32).all()), "non-finite cost recorded")
    check(bool(torch.isfinite(state32.mu).all())
          and bool(torch.isfinite(state32.precision.diag).all()),
          "non-finite final state")
    rises = int((cost32[:, 1:] > cost32[:, :-1]).sum())
    check(rises == 0, f"{rises} recorded cost increases")
    check(bool((cost32[:, -1] > 0).all()),
          f"{int((cost32[:, -1] <= 0).sum())}/{B} final costs <= 0 "
          f"(min {float(cost32[:, -1].min()):.3e})")

    # float32 against float64 on the card.  The line search makes discrete
    # accept / fallback decisions that float32 rounding can flip on some
    # problems, after which their trajectories differ by more than rounding
    # (the JAX package's own float32 path shows the same), so the gates are:
    # every problem's first recorded cost (no decision taken yet), the
    # whole history of seed 0 (the JAX package's float32-vs-float64 device
    # gate), and the batch median of the final-cost differences.
    _, hist64 = optimize(graph_b[torch.float64], state_b[torch.float64], cfg)
    rel = (cost32 - hist64.cost).abs() / hist64.cost.abs().clamp_min(1e-12)
    rel_first = rel[:, 0].max().item()
    rel_seed0 = rel[0].max().item()
    rel_final_median = rel[:, -1].median().item()
    print(f"[main path] f32 vs f64 relative cost difference: first record "
          f"max {rel_first:.3e}, seed-0 history max {rel_seed0:.3e}, final "
          f"median {rel_final_median:.3e} (final max "
          f"{rel[:, -1].max().item():.3e}, history max {rel.max().item():.3e})",
          flush=True)
    check(rel_first < 1e-4, f"first-record f32 vs f64 {rel_first:.3e}")
    check(rel_seed0 < 1e-3, f"seed-0 f32 vs f64 {rel_seed0:.3e} >= 1e-3")
    check(rel_final_median < 1e-3,
          f"median final f32 vs f64 {rel_final_median:.3e} >= 1e-3")

    # kernel path vs plain path on a small batch, float64
    g8, s8 = build_batch(torch.float64, dev, num_problems=8)
    _, hk = optimize(g8, s8, cfg)
    _, hp = optimize(g8, s8, cfg_plain)
    rel_kp = ((hk.cost - hp.cost).abs() / hp.cost.abs()).max().item()
    print(f"[main path] kernels vs plain (f64, 8 problems) max relative cost "
          f"difference {rel_kp:.3e}", flush=True)
    check(rel_kp < 1e-9, f"kernel path vs plain path differ: {rel_kp:.3e}")
    check(torch.equal(hk.accepted_step, hp.accepted_step),
          "kernel and plain paths accepted different steps")

    # ---- throughput, kernel path vs plain path (float32) ----
    def rate(config):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            optimize(graph_b[torch.float32], state_b[torch.float32], config)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return B * NITERS / statistics.median(times)

    rate_kernel = rate(cfg)
    rate_plain = rate(cfg_plain)
    print(f"[throughput] {card}: kernels {rate_kernel:.1f} prob-iters/s, "
          f"plain PyTorch {rate_plain:.1f} prob-iters/s "
          f"(B={B}, N={N}, {NITERS} iters, f32, median of 3)", flush=True)
    for name, r in kern.items():
        print(f"[kernel time] {card}: {name} {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms (f32, slice shapes)", flush=True)

    sources = {
        "gbp_covariance_logdet": ("gaussianvi_tpu_torch/csrc/chain.cu",
                                  "gaussianvi_tpu/kernels/chain_lanes.py:131"),
        "solve": ("gaussianvi_tpu_torch/csrc/chain.cu",
                  "gaussianvi_tpu/kernels/chain_lanes.py:418"),
        "quad_phi": ("gaussianvi_tpu_torch/csrc/quad.cu",
                     "gaussianvi_tpu/kernels/quad_lanes.py:99"),
        "quad_moments": ("gaussianvi_tpu_torch/csrc/quad.cu",
                         "gaussianvi_tpu/kernels/quad_lanes.py:99"),
    }
    rows = [dict(name=name, route="cuda", source=sources[name][0],
                 replaces=sources[name][1], launches=launches[name],
                 max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
                 plain_ms=kern[name]["plain_ms"]) for name in WRAPPERS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
