"""Where the time goes in the PyTorch port on one GPU, path by path.

For each path of ``gaussianvi_tpu_torch.optimize`` on the flagship
(B=1024 problems, N=32 states, dim_x=2, degree 4, 10 iterations, float32)
this prints the median wall time of interleaved unprofiled runs, then, from
one ``torch.profiler`` run, the number of device operations, their summed
device time, the busy share (summed device time over the unprofiled wall
time) and the five device operations that take most of it.  Paths: the
fused kernels (default), the separate kernels, block-form moments
(``use_pallas``), and the proximal optimizer.

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5,
                        help="unprofiled runs per path (interleaved)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from gaussianvi_tpu_torch import GVIConfig, optimize, stack_problems
    from gaussianvi_tpu_torch.examples.chain_estimation import (
        build_chain_estimation,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    problems = [build_chain_estimation(num_states=N, dim_x=DIM_X,
                                       gh_degree=DEGREE, seed=seed,
                                       dtype=torch.float32, device=dev)[:2]
                for seed in range(B)]
    graph, state = stack_problems(*map(list, zip(*problems)))
    cfg = GVIConfig(niters=NITERS, niters_lowtemp=NITERS, step_size_base=0.9)
    paths = {
        "fused": (cfg, "ngd"),
        "separate": (replace(cfg, fused_trials="off", fused_gradient="off"),
                     "ngd"),
        "block_moments": (replace(cfg, use_pallas=True, fused_gradient="off"),
                          "ngd"),
        "prox": (replace(cfg, step_size_base=0.1), "prox"),
    }

    def run(name):
        config, method = paths[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        optimize(graph, state, config, method)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for name in paths:          # builds the kernels, warms every path up
        run(name)
    walls = {name: [] for name in paths}
    for _ in range(args.runs):
        for name in paths:
            walls[name].append(run(name))
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
        print(f"[{name}] wall {1e3 * wall:.2f} ms (median of {args.runs}), "
              f"{B * NITERS / wall:.1f} prob-iters/s; {ops} device ops, "
              f"{device_us / 1e3:.2f} ms device time, busy "
              f"{device_us / 1e6 / wall:.0%}")
        for e in sorted(events, key=lambda e: -e.device_time_total)[:5]:
            print(f"    {e.device_time_total / 1e3:8.2f} ms  {e.count:5d} x  "
                  f"{e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
