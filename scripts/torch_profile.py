"""Where the time goes in the PyTorch port on one GPU, path by path.

For each path of ``gaussianvi_tpu_torch.optimize`` on the flagship
(B=1024 problems, N=32 states, dim_x=2, degree 4, 10 iterations, float32)
this prints the median wall time of interleaved unprofiled runs, then, from
one ``torch.profiler`` run, the number of device operations, their summed
device time, the busy share (summed device time over the unprofiled wall
time) and the five device operations that take most of it.  Paths: the
fused kernels (default), the separate kernels, block-form moments
(``use_pallas``), the proximal optimizer, and the factor-parallel path
(``parallel.optimize_sharded``, dp=1 x fp=2: two rank processes sharing the
card over gloo; rank 0 is profiled, so its busy share counts its own device
operations only, while the other rank's kernels take turns on the card).

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_profile.py [--runs 5]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, N, DIM_X, DEGREE, NITERS = 1024, 32, 2, 4, 10


def build(dev):
    from gaussianvi_tpu_torch import stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    problems = [build_chain_estimation(num_states=N, dim_x=DIM_X,
                                       gh_degree=DEGREE, seed=seed,
                                       dtype=torch.float32, device=dev)[:2]
                for seed in range(B)]
    return stack_problems(*map(list, zip(*problems)))


def profile_paths(paths, runs):
    """``paths``: name -> callable running the path once.  Returns the
    report lines: per path the median wall time of ``runs`` interleaved
    unprofiled runs, then one profiled run's device operations."""
    from torch.profiler import ProfilerActivity, profile

    def run(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths[name]()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for name in paths:          # builds the kernels, warms every path up
        run(name)
    walls = {name: [] for name in paths}
    for _ in range(runs):
        for name in paths:
            walls[name].append(run(name))
    lines = []
    for name in paths:
        wall = statistics.median(walls[name])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(name)
        events = [e for e in prof.key_averages()
                  if e.device_time_total > 0 and e.count > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.device_time_total for e in events)
        ops = sum(e.count for e in events)
        lines.append(
            f"[{name}] wall {1e3 * wall:.2f} ms (median of {runs}), "
            f"{B * NITERS / wall:.1f} prob-iters/s; {ops} device ops, "
            f"{device_us / 1e3:.2f} ms device time, busy "
            f"{device_us / 1e6 / wall:.0%}")
        for e in sorted(events, key=lambda e: -e.device_time_total)[:5]:
            lines.append(f"    {e.device_time_total / 1e3:8.2f} ms  "
                         f"{e.count:5d} x  {e.key[:70]}")
    return lines


def sharded_rank(rank, world, device, cfg, runs):
    """One of the two ranks of the factor-parallel path; both run the same
    sequence, each profiles itself, rank 0's report is printed."""
    from gaussianvi_tpu_torch.parallel import make_mesh, optimize_sharded

    mesh = make_mesh(1, world)
    graph, state = build(device)
    return profile_paths(
        {"factor_parallel": lambda: optimize_sharded(graph, state, cfg,
                                                     mesh)}, runs)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5,
                        help="unprofiled runs per path (interleaved)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from gaussianvi_tpu_torch import GVIConfig, optimize
    from gaussianvi_tpu_torch.kernels import _build
    from gaussianvi_tpu_torch.parallel.multiprocess import spawn_ranks

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    graph, state = build(dev)
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    paths = {
        "fused": (cfg, "ngd"),
        "separate": (replace(cfg, fused_trials="off", fused_gradient="off"),
                     "ngd"),
        "block_moments": (replace(cfg, use_pallas=True, fused_gradient="off"),
                          "ngd"),
        "prox": (replace(cfg, step_size_base=0.1), "prox"),
    }
    print("\n".join(profile_paths(
        {name: (lambda c=c, m=m: optimize(graph, state, c, m))
         for name, (c, m) in paths.items()}, args.runs)))
    # the ranks load the library this process has built
    _build.load()
    ranks = spawn_ranks(sharded_rank, 2, (cfg, args.runs), backend="gloo",
                        device=str(dev), timeout_s=600.0)
    print("\n".join(ranks[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
