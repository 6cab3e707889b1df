"""Where the time goes in the PyTorch port on one GPU, path by path.

For each path of ``gaussianvi_tpu_torch.optimize`` on the flagship
(B=1024 problems, N=32 states, dim_x=2, degree 4, 10 iterations, float32)
this prints, from one ``torch.profiler`` run after a warm-up run, the
number of device operations, their summed device time, the five device
operations that take most of it and the chain kernels K1 and K2 wherever
they rank.  Paths: the fused kernels (default), the separate kernels,
block-form moments (``use_pallas``), the proximal optimizer, and the
factor-parallel path (``parallel.optimize_sharded``, dp=1 x fp=2: two rank
processes sharing the card over gloo; rank 0 is profiled, so its numbers
are its own device operations only, while the other rank's kernels take
turns on the card).  Rates, latencies and the device's idle share are the
benchmark's (``benchmark/run.py``).

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_profile.py

Other modes (``--tree DIR`` measures the package of another checkout, say
the parent commit unpacked beside this one: to compare two trees,
alternate the two commands on one card, several times in a row):

    python3 scripts/torch_profile.py --parts [--tree DIR]

the device time of the fused kernels K5 and K6 ``full`` at the flagship's
shapes and at s = 6 (chain estimation at dim_x = 3, the point planner)
with all factors, the nonlinear or the linear ones only, none, K5 with a
single trial, and K6 ``accum`` and ``solve`` with none: what the chain
alone costs, what the solves cost and what the factors add (CUDA events
around 20 calls queued behind a matrix product).

    python3 scripts/torch_profile.py --quad-plans

the device time of the quadrature kernels K3 (phi only, on the line-search
batch of 11 x 1024 x 32 factors; moments, on 1024 x 32) and K4 (1024 x
32) for every lane group of ``kernels.quad.quad_plan``'s candidates (1 to
32 lanes per factor) and 128 or 256 threads a block, on the 29-node
marginal rule (d = 4), the 137-node full rule (d = 4), the 7-node rule
at d = 2 and the 69- and 25-node marginal rules at d = 6, float32 and
float64: the measurement that fixes the plan.

    python3 scripts/torch_profile.py --quad-times [--tree DIR]

K3 (both variants) and K4 at the flagship's shapes, warm and with the L2
flushed, through the wrappers of the package of ``--tree`` (say the
parent): alternate the two trees on one card to compare them.

    python3 scripts/torch_profile.py --chain-times [--tree DIR] [--save FILE]

the device time of the kernels that take each edge's covariance blocks
(K1 on 11 x 1024 chains, K5, K6 ``full``, ``accum`` and ``solve``) at the
flagship's shapes (s = 4) and at dim_x = 1 (s = 2), then K5 and K6 at
s = 6 at the shapes of chain estimation at dim_x = 3 (B = 1024, N = 32),
of the 3-D point planner (1024 restarts, N = 20) and of its patch mode
(K6 ``full`` and ``accum``), float32 and float64, warm and with the L2
flushed, at the initial iterate, and what ptxas says of their instances,
through the package of ``--tree``: alternate two trees on one card to
compare two forms of that step.  ``--save FILE`` keeps every instance's
outputs (one call each), and

    python3 scripts/torch_profile.py --compare-outputs FILE FILE

prints, instance by instance, whether two such files hold the same bits
(and the largest difference where not).

    python3 scripts/torch_profile.py --planner

the same profile for the planar planner (``examples.planar_planning``:
B=1024 restarts from ``parallel.perturb_inits`` with mean_scale 0.3, N=20,
build_planar_planning's 30 iterations, float32), fused and separate paths.

    python3 scripts/torch_profile.py --s6

the same profile for the s = 6 models: the 3-D point planner
(``examples.point3d_planning``, B=1024 restarts as above, N=20, 30
iterations; fused and separate), the planar quadrotor
(``examples.quadrotor_planning``, B=1024 restarts, N=12, 20 iterations;
the default path: K1 / K2 and the plain quadrature) and chain estimation
at dim_x=3 (B=1024, N=32, 10 iterations; fused).

    python3 scripts/torch_profile.py --arm

the same profile for the 7-DOF arm planner (``examples.arm_planning``,
s = 14: B=1024 restarts as above, N=10, 15 iterations; the default path:
K1 / K2 at s = 14 and the arm's K3 instance), then one line of the arm's
K3 device ms (phi on the line-search batch of 11 x 1024 x 10 factors,
the moments on 1024 x 10; float32, warm and with the L2 flushed).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, N, DIM_X, DEGREE, NITERS = 1024, 32, 2, 4, 10
PLAN_B = 1024   # the restarts of the planners


def build(dev, dim_x=DIM_X, dtype=torch.float32):
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    problems = [build_chain_estimation(num_states=N, dim_x=dim_x,
                                       gh_degree=DEGREE, seed=seed,
                                       dtype=dtype, device=dev)[:2]
                for seed in range(B)]
    return stack_problems(*map(list, zip(*problems)))


def profile_paths(paths):
    """``paths``: name -> callable running the path once.  Returns the
    report lines: per path one profiled run's device operations."""
    from torch.profiler import ProfilerActivity, profile

    def run(name):
        paths[name]()
        torch.cuda.synchronize()

    for name in paths:          # builds the kernels, warms every path up
        run(name)
    lines = []
    for name in paths:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(name)
        events = [e for e in prof.key_averages()
                  if e.device_time_total > 0 and e.count > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.device_time_total for e in events)
        ops = sum(e.count for e in events)
        lines.append(f"[{name}] {ops} device ops, "
                     f"{device_us / 1e3:.2f} ms device time")
        ranked = sorted(events, key=lambda e: -e.device_time_total)
        # the five largest, then the chain kernels K1 and K2 wherever they
        # rank
        shown = ranked[:5] + [e for e in ranked[5:] if any(
            k in e.key for k in ("gbp_kernel", "solve_kernel",
                                 "gbp_wide_kernel", "solve_wide_kernel",
                                 "quad_kernel", "quad_arm_kernel",
                                 "trials_kernel",
                                 "grad_kernel"))]
        for e in shown:
            lines.append(f"    {e.device_time_total / 1e3:8.2f} ms  "
                         f"{e.count:5d} x  {e.key[:70]}")
    return lines


def path_configs():
    from gaussianvi_tpu_torch import GVIConfig

    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    return cfg, {
        "fused": (cfg, "ngd"),
        "separate": (replace(cfg, fused_trials="off", fused_gradient="off"),
                     "ngd"),
        "block_moments": (replace(cfg, use_pallas=True, fused_gradient="off"),
                          "ngd"),
        "prox": (replace(cfg, step_size_base=0.1), "prox"),
    }


def planner_paths(dev):
    """The planar planner's fused and separate paths on PLAN_B restarts,
    float32: name -> callable running the path once."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.examples.planar_planning import (
        build_planar_planning,
    )
    from gaussianvi_tpu_torch.parallel import perturb_inits

    graph, init, cfg, _ = build_planar_planning(dtype=torch.float32,
                                                device=dev)
    inits = perturb_inits(init, torch.Generator(device=dev).manual_seed(0),
                          PLAN_B, mean_scale=0.3)
    sep = replace(cfg, fused_trials="off", fused_gradient="off")
    return {f"planner {name}": (lambda c=c: optimize(graph, inits, c))
            for name, c in (("fused", cfg), ("separate", sep))}


def s6_paths(dev):
    """The s = 6 models' paths, float32: ``[name -> callable running
    the path once]``, one entry per model."""
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.examples.quadrotor_planning import (
        build_quadrotor_planning,
    )
    from gaussianvi_tpu_torch.parallel import perturb_inits

    out = []
    for label, builder, names in (
            ("point3d", build_point3d_planning, ("fused", "separate")),
            ("quadrotor", build_quadrotor_planning, ("default",))):
        graph, init, cfg, _ = builder(dtype=torch.float32, device=dev)
        inits = perturb_inits(init, torch.Generator(device=dev).manual_seed(
            0), PLAN_B, mean_scale=0.3)
        configs = {"fused": cfg, "default": cfg,
                   "separate": replace(cfg, fused_trials="off",
                                       fused_gradient="off")}
        out.append({f"{label} {name}": (
            lambda c=configs[name], g=graph, i=inits: optimize(g, i, c))
            for name in names})
    graph, state = build(dev, dim_x=3)
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    out.append({"dim_x=3 fused": lambda: optimize(graph, state, cfg)})
    return out


def arm_paths(dev):
    """The arm planner's default path on PLAN_B restarts, float32:
    name -> callable running the path once."""
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.examples.arm_planning import build_arm_planning
    from gaussianvi_tpu_torch.parallel import perturb_inits

    graph, init, cfg, _ = build_arm_planning(dtype=torch.float32, device=dev)
    inits = perturb_inits(init, torch.Generator(device=dev).manual_seed(0),
                          PLAN_B, mean_scale=0.3)
    return {"arm default": lambda: optimize(graph, inits, cfg)}


def arm_quad_times(dev):
    """One line: the arm's K3 (``csrc/quad_arm.cu``) device ms, float32,
    warm / L2 flushed: phi on the line-search batch (11 x PLAN_B x 10
    factors) and the moments on PLAN_B x 10, at marginals near the
    straight line with covariances of an iterate's size."""
    from gaussianvi_tpu_torch.examples.arm_planning import build_arm_planning
    from gaussianvi_tpu_torch.kernels import quad

    f32 = torch.float32
    graph, init, _, _ = build_arm_planning(dtype=f32, device=dev)
    fb = graph.nonlinear[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def marginals(*lead):
        mu = init.mu + 0.3 * torch.randn(*lead, 10, 14, generator=gen,
                                         device=dev, dtype=f32)
        a = 0.1 * torch.randn(*lead, 10, 14, 14, generator=gen, device=dev,
                              dtype=f32)
        eye = torch.eye(14, device=dev, dtype=f32)
        return mu, a @ a.transpose(-1, -2) + 0.02 * eye

    trial, batch = marginals(11, PLAN_B), marginals(PLAN_B)
    par = fb.kernel_params
    calls = {
        "phi": lambda: quad.quad_lanes_phi(
            *trial, fb.nodes, fb.weights, "arm_sdf", par, nonneg=True,
            field=fb.kernel_field),
        "moments": lambda: quad.quad_lanes_moments(
            *batch, fb.nodes, fb.weights, "arm_sdf", par, rdim=7,
            field=fb.kernel_field)}
    return "[kernel time] arm K3 " + ", ".join(
        f"{name} {device_ms(fn):.4f} ({device_ms(fn, flushed=True):.4f}) ms"
        for name, fn in calls.items())


def kernel_parts(dev, tree="."):
    """Lines: device ms of K5 and K6 by what they are given, at the
    flagship's shapes and at s = 6 (chain estimation at dim_x = 3, the
    point planner), float32, through the package of ``tree``: K5 and K6
    ``full`` with all factors, the nonlinear or the linear ones only and
    none, K5 with a single trial, K6 ``accum`` (phases A and B: no solves)
    and ``solve`` (no quadrature) with none."""
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    lines = []
    for (shape, s), case in chain_cases(dev, torch.float32).items():
        if shape not in ("chain dim_x=2", "chain dim_x=3", "point3d"):
            continue
        mu, pd, po, temp, ops, seeds, (dmu, dpd, dpo), trials, _ = case
        nl_specs, lin_specs, nl, lin = ops
        subsets = {"all factors": ops,
                   "nonlinear only": (nl_specs, (), nl, ()),
                   "linear only": ((), lin_specs, (), lin),
                   "no factor": ((), (), (), ())}
        parts = []
        for name, sub in subsets.items():
            k5 = device_ms(lambda: ft.trial_costs_lanes(
                mu, dmu, pd, po, dpd, dpo, trials, *sub))
            k6 = device_ms(lambda: fg.gradient_lanes(mu, pd, po, temp, *sub))
            parts.append(f"{name}: K5 {k5:.4f}, K6 full {k6:.4f}")
        one = device_ms(lambda: ft.trial_costs_lanes(
            mu, dmu, pd, po, dpd, dpo, trials[:1], (), (), (), ()))
        acc = device_ms(lambda: fg.gradient_accum_lanes(
            mu, pd, po, temp, (), ()))
        zero = fg.Partials(mu.shape[0], mu.shape[1], s, mu.dtype, dev,
                           zero=True)
        sol = device_ms(lambda: fg.gradient_solve_lanes(
            mu, pd, po, temp, zero, (), ()))
        parts.append(f"no factor, one trial: K5 {one:.4f}; no factor: K6 "
                     f"accum {acc:.4f}, K6 solve {sol:.4f}")
        lines.append(f"[parts {tree}] {shape} s={s}: " + "; ".join(parts)
                     + f" ms (B={mu.shape[0]}, N={mu.shape[1]}, 11 trials, "
                       f"f32, at the initial iterate)")
    return lines


def chain_cases(dev, dt):
    """``{(shape, block size): (K5 / K6 operands)}`` at the initial
    iterate of each model whose K5 and K6 ``--chain-times`` measures:
    ``(mu, pd, po, temp, ops, seeds, direction, trials, modes)``."""
    from gaussianvi_tpu_torch.examples.point3d_planning import (
        build_point3d_planning,
    )
    from gaussianvi_tpu_torch.inference.engine import fused_operands
    from gaussianvi_tpu_torch.inference.graph import take_states
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.parallel import perturb_inits
    from gaussianvi_tpu_torch.parallel.restarts import _batch_graph

    cases = {}
    for dim_x in (2, 1, 3):
        graph, state = build(dev, dim_x, dt)
        cases[f"chain dim_x={dim_x}", 2 * dim_x] = (
            graph, state.mu, state.precision.diag, state.precision.off,
            fused_operands(graph))
    for patch in (None, 8):
        graph, init, _, _ = build_point3d_planning(
            dtype=torch.float64, device=dev, patch_size=patch)
        inits = perturb_inits(init, torch.Generator(device=dev).manual_seed(
            0), PLAN_B, mean_scale=0.3)
        graph = _batch_graph(build_point3d_planning(
            dtype=dt, device=dev, patch_size=patch)[0], PLAN_B)
        mu = inits.mu.to(dt)
        ops = fused_operands(graph, trials=patch is None)
        if patch is not None:   # the windows of this iterate, as the loop
            fb = graph.nonlinear[0]
            nl_specs, lin_specs, nl, lin = ops
            start, nodes, weights, _, field = nl[0]
            params = fb.kernel_prep(take_states(mu, start, fb.slice_offset,
                                                1))
            ops = (nl_specs, lin_specs,
                   ((start, nodes, weights, params, field),), lin)
        cases["point3d" + (" patch" if patch else ""), 6] = (
            graph, mu, inits.precision.diag.to(dt),
            inits.precision.off.to(dt), ops)
    out = {}
    for key, (graph, mu, pd, po, ops) in cases.items():
        nl_specs, lin_specs, nl, lin = ops
        temp = torch.ones(mu.shape[0], dtype=dt, device=dev)
        full = fg.gradient_lanes(mu, pd, po, temp, *ops)
        seeds = fg.gradient_accum_lanes(mu, pd, po, temp, nl_specs, nl)
        trials = 0.9 * 0.75 ** torch.arange(1, 12, dtype=dt, device=dev)
        modes = (("full", "accum") if "patch" in key[0]
                 else ("K1", "K5", "full", "accum", "solve") if key[1] < 6
                 else ("K5", "full", "accum", "solve"))
        out[key] = (mu, pd, po, temp, ops, seeds,
                    (full[6], full[3], full[4]), trials, modes)
    return out


def chain_times(dev, tree, save=None):
    """Lines: device ms (warm / L2 flushed) of K1, K5 and K6 in its three
    modes by shape, block size and dtype, then their instances' registers
    and spills; ``save``: a file for every instance's outputs."""
    from gaussianvi_tpu_torch.kernels import _build, chain
    from gaussianvi_tpu_torch.kernels import fused_gradient as fg
    from gaussianvi_tpu_torch.kernels import fused_trials as ft

    lines, kept = [], {}
    for dt in (torch.float32, torch.float64):
        for (shape, s), case in chain_cases(dev, dt).items():
            mu, pd, po, temp, ops, seeds, (dmu, dpd, dpo), trials, modes = (
                case)
            nl_specs, lin_specs, nl, lin = ops
            diag = pd.expand(11, *pd.shape).contiguous()
            off = po.expand(11, *po.shape).contiguous()
            calls = {
                "K1": lambda: chain.gbp_covariance_logdet_lanes(diag, off),
                "K5": lambda: ft.trial_costs_lanes(
                    mu, dmu, pd, po, dpd, dpo, trials, *ops),
                "full": lambda: fg.gradient_lanes(mu, pd, po, temp, *ops),
                "accum": lambda: fg.gradient_accum_lanes(
                    mu, pd, po, temp, nl_specs, nl),
                "solve": lambda: fg.gradient_solve_lanes(
                    mu, pd, po, temp, seeds, lin_specs, lin),
            }
            times = []
            for name in modes:
                fn = calls[name]
                times.append(f"{name if name in ('K1', 'K5') else 'K6 ' + name}"
                             f" {device_ms(fn):.4f} / "
                             f"{device_ms(fn, flushed=True):.4f}")
                if save is not None:
                    got = fn()
                    got = (got[0], *got[1]) if name == "K5" else tuple(got)
                    kept[f"{shape} s={s} {str(dt)[6:]} {name}"] = tuple(
                        t.cpu() for t in got)
            lines.append(f"[chain times {tree}] {shape} s={s} "
                         f"{str(dt)[6:]}: " + ", ".join(times)
                         + f" ms warm / flushed (B={mu.shape[0]}, "
                           f"N={mu.shape[1]})")
    lines.append(f"[chain ptxas {tree}] " + "; ".join(
        f"{r['kernel']}{' ' + r['cost'] if r['cost'] else ''} {r['dtype']} "
        f"s={r['ints'][0]}"
        + (f" mode {r['ints'][-1]}" if "grad" in r["kernel"] else "")
        + f": {r['registers']} regs, spill {r['spill_stores']}+"
        f"{r['spill_loads']} B"
        for r in _build.ptxas_report()
        if r["kernel"] in ("gbp_kernel", "trials_kernel", "grad_kernel",
                           "trials_s6_kernel", "grad_s6_kernel")
        and r["ints"][0] in (2, 4, 6)))
    if save is not None:
        torch.save(kept, save)
    return lines


def compare_outputs(path_a, path_b):
    """Lines: per instance, whether the two files' outputs have the same
    bits (NaNs where the other has them), else the largest difference."""
    a, b = torch.load(path_a), torch.load(path_b)
    lines = []
    for key in a:
        if key not in b:
            lines.append(f"[compare] {key}: only in {path_a}")
            continue
        same = all(x.shape == y.shape and torch.equal(
            x.nan_to_num(7.0, 8.0, -8.0), y.nan_to_num(7.0, 8.0, -8.0))
            and torch.equal(x.isnan(), y.isnan())
            for x, y in zip(a[key], b[key]))
        worst = max(float((x.double() - y.double()).nan_to_num(0.0).abs().max())
                    for x, y in zip(a[key], b[key]))
        lines.append(f"[compare] {key}: "
                     + ("same bits" if same else f"differ, max {worst:.3e}"))
    return lines


_BLOCKER = {}


def device_ms(fn, reps=20, flushed=False):
    """Mean device milliseconds per call of ``fn`` after one warm-up: CUDA
    events around ``reps`` calls queued behind a matrix product (the host
    queues them while the card works), or, ``flushed``, each call between
    its own events after a 256 MB write that evicts the 50 MB L2."""
    if not _BLOCKER:
        _BLOCKER["a"] = torch.ones(6144, 6144, device="cuda")
        _BLOCKER["flush"] = torch.empty(256 << 20, dtype=torch.uint8,
                                        device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.mm(_BLOCKER["a"], _BLOCKER["a"])
    pairs = []
    for _ in range(reps if flushed else 1):
        if flushed:
            _BLOCKER["flush"].zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if flushed else reps):
            fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def quad_inputs(dev, dim_x=2, degree=4, marginal=True, dtype=torch.float32):
    """The rule of the flagship's range batch (or another), random range
    params [B, N, P], and random well-conditioned marginals on the
    line-search batch [11, B, N] and on [B, N]."""
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    fb = build_chain_estimation(num_states=2, dim_x=dim_x, gh_degree=degree,
                                marginal_quad=marginal, dtype=dtype,
                                device=dev)[0].nonlinear[0]
    d = 2 * dim_x

    def marginals(*lead):
        mu = torch.randn(*lead, d, generator=gen, device=dev, dtype=dtype)
        a = 0.3 * torch.randn(*lead, d, d, generator=gen, device=dev,
                              dtype=dtype)
        eye = torch.eye(d, device=dev, dtype=dtype)
        return mu, a @ a.transpose(-1, -2) + 0.5 * eye

    par = torch.rand(B, N, fb.kernel_params.shape[-1], generator=gen,
                     device=dev, dtype=dtype) + 0.5
    return fb, par, marginals(11, B, N), marginals(B, N)


def quad_calls(fb, par, trial, batch):
    """K3 phi on the line-search batch, K3 moments and K4 on [B, N]."""
    from gaussianvi_tpu_torch.kernels import fused_moments as fm
    from gaussianvi_tpu_torch.kernels import quad

    return {
        "K3 phi": lambda: quad.quad_lanes_phi(
            *trial, fb.nodes, fb.weights, "range", par, nonneg=True),
        "K3 moments": lambda: quad.quad_lanes_moments(
            *batch, fb.nodes, fb.weights, "range", par, rdim=fb.quad_rdim),
        "K4": lambda: fm.fused_moments(
            fb.nodes, fb.weights, *batch, "range", par, rdim=fb.quad_rdim),
    }


def quad_times(dev, tree):
    """One line: K3 and K4's device ms at the flagship's shapes, warm and
    with the L2 flushed, for the package of ``tree``."""
    calls = quad_calls(*quad_inputs(dev))
    return f"[quad times {tree}] " + ", ".join(
        f"{name} {device_ms(call):.4f} (flushed "
        f"{device_ms(call, flushed=True):.4f})"
        for name, call in calls.items()) + (
            f" ms (B={B}, N={N}, 29-node rule, f32)")


def quad_plans(dev):
    """Lines of device ms of K3 and K4 per lane group and block size."""
    from gaussianvi_tpu_torch.kernels import quad

    plain = quad.quad_plan
    lines = []
    for dim_x, degree, marginal in ((2, 4, True), (2, 4, False),
                                    (1, 7, True), (3, 4, True),
                                    (3, 3, True)):
        for dtype in (torch.float32, torch.float64):
            fb, par, trial, batch = quad_inputs(dev, dim_x, degree, marginal,
                                                dtype)
            d, m = 2 * dim_x, fb.nodes.shape[0]
            for name, call in quad_calls(fb, par, trial, batch).items():
                chosen = plain(m, d, name != "K3 phi", dtype)
                cells = []
                for group in (1, 2, 4, 8, 16, 32):
                    for threads in (128, 256):
                        staged = (threads // group * (1 + d + d * d)
                                  if name != "K3 phi" else 0)
                        if ((m * (d + 1) + staged) * dtype.itemsize
                                > quad._MAX_SMEM):
                            # more than a block may take without asking
                            cells.append(f"{group}/{threads} -")
                            continue
                        quad.quad_plan = (
                            lambda *a, g=group, t=threads:
                            plain(*a)._replace(group=g, threads=t))
                        cells.append(f"{group}/{threads} "
                                     f"{device_ms(call):.4f}")
                quad.quad_plan = plain
                lines.append(
                    f"[quad plans] {name}, M={m}, d={d}, {str(dtype)[6:]}, "
                    f"plan {chosen.group}/{chosen.threads}: "
                    + ", ".join(cells) + " ms (group/threads)")
    return lines


def sharded_rank(rank, world, device, cfg):
    """One of the two ranks of the factor-parallel path; both run the same
    sequence, each profiles itself, rank 0's report is printed."""
    from gaussianvi_tpu_torch.parallel import make_mesh, optimize_sharded

    mesh = make_mesh(1, world)
    graph, state = build(device)
    return profile_paths(
        {"factor_parallel": lambda: optimize_sharded(graph, state, cfg,
                                                     mesh)})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", action="store_true",
                        help="print K5 / K6 times by the factors given")
    parser.add_argument("--quad-plans", action="store_true",
                        help="print K3 / K4 times by lane group")
    parser.add_argument("--quad-times", action="store_true",
                        help="print K3 / K4 times at the flagship's shapes")
    parser.add_argument("--chain-times", action="store_true",
                        help="print K1 / K5 / K6 times at s = 2, 4 and 6")
    parser.add_argument("--save", default=None,
                        help="with --chain-times: keep the outputs here")
    parser.add_argument("--compare-outputs", nargs=2, default=None,
                        help="compare two files --save wrote")
    parser.add_argument("--planner", action="store_true",
                        help="profile the planar planner's paths")
    parser.add_argument("--s6", action="store_true",
                        help="profile the s = 6 models' paths")
    parser.add_argument("--arm", action="store_true",
                        help="profile the arm planner's default path")
    parser.add_argument("--tree", default=None,
                        help="measure the package of this checkout instead")
    args = parser.parse_args()
    if args.compare_outputs:
        print("\n".join(compare_outputs(*args.compare_outputs)))
        return 0
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    if args.tree is not None:
        sys.path.insert(0, os.path.abspath(args.tree))
    from gaussianvi_tpu_torch import optimize
    from gaussianvi_tpu_torch.kernels import _build
    from gaussianvi_tpu_torch.ops.precision import set_precision_policy
    from gaussianvi_tpu_torch.parallel.multiprocess import spawn_ranks

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    set_precision_policy()
    dev = torch.device("cuda", 0)
    if args.parts:
        print(card)
        print("\n".join(kernel_parts(dev, args.tree or ".")), flush=True)
        return 0
    if args.quad_plans:
        print(card)
        print("\n".join(quad_plans(dev)))
        return 0
    if args.chain_times:
        print(card)
        print("\n".join(chain_times(dev, args.tree or ".", args.save)),
              flush=True)
        return 0
    if args.quad_times:
        print(card + " " + quad_times(dev, args.tree or "."))
        return 0
    print(card)
    if args.planner:
        print("\n".join(profile_paths(planner_paths(dev))))
        return 0
    if args.arm:
        print("\n".join(profile_paths(arm_paths(dev))), flush=True)
        print(arm_quad_times(dev), flush=True)
        return 0
    if args.s6:
        for paths in s6_paths(dev):
            print("\n".join(profile_paths(paths)), flush=True)
        return 0
    graph, state = build(dev)
    cfg, paths = path_configs()
    print("\n".join(profile_paths(
        {name: (lambda c=c, m=m: optimize(graph, state, c, m))
         for name, (c, m) in paths.items()})))
    # the ranks load the library this process has built
    _build.load()
    ranks = spawn_ranks(sharded_rank, 2, (cfg,), backend="gloo",
                        device=str(dev), timeout_s=600.0)
    print("\n".join(ranks[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
