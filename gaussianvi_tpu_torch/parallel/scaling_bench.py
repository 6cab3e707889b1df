"""Factor-parallel scaling-efficiency harness.

Counterpart of ``gaussianvi_tpu/parallel/scaling_bench.py``: sharded
NGD-step throughput across (dp, fp) mesh shapes, each shape a group of
rank processes (:func:`.multiprocess.spawn_ranks`), one per card.  With
ranks sharing one device (``--device cuda:0``, or ``cpu``), the runs time
the plumbing only: the ranks time-slice that device, and the efficiency
figure then says nothing about scaling.

Usage:
    python -m gaussianvi_tpu_torch.parallel.scaling_bench [max_ranks]
        [--device cuda | cuda:i | cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def measure_mesh(dp, fp, num_states=64, dim_x=2, niters=5, repeats=3,
                 device=None):
    """Problem-iterations per second of ``optimize_sharded`` on the
    ``dp x fp`` mesh of the initialised process group (one problem per dp
    row, the best of ``repeats`` timed runs after one warm-up).
    Collective: every rank of the group calls it."""
    from ..batching import stack_problems
    from ..examples.chain_estimation import build_chain_estimation
    from ..inference import GVIConfig
    from .collective import make_mesh
    from .sharding import optimize_sharded

    mesh = make_mesh(dp=dp, fp=fp)
    graphs, states = [], []
    for seed in range(dp):
        graph, init, _ = build_chain_estimation(
            num_states=num_states, dim_x=dim_x, gh_degree=4, seed=seed,
            device=device)
        graphs.append(graph)
        states.append(init)
    graph_b, state_b = stack_problems(graphs, states)
    config = GVIConfig(niters=niters, step_size_base=0.9)
    if not mesh.member:
        return None

    def run():
        out, _ = optimize_sharded(graph_b, state_b, config, mesh)
        return float(out.mu.sum())     # host sync

    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return dp * niters / best


def _measure_rank(rank, world, device, dp, fp):
    return measure_mesh(dp, fp, device=device)


def mesh_shapes(n):
    """All power-of-2 (dp, fp) splits of up to n ranks."""
    shapes = [(1, 1)]
    d = 2
    while d <= n:
        shapes.extend(
            (dp, d // dp)
            for dp in (2 ** k for k in range(d.bit_length()))
            if dp <= d and d % dp == 0
        )
        d *= 2
    return sorted(set(shapes))


def main(max_ranks=None, device="cuda"):
    """Measure every mesh shape of up to ``max_ranks`` ranks (with
    ``device="cuda"`` at most one per card, the default all cards; else
    default 1) and print each rate beside its efficiency against
    (1, 1)."""
    from .multiprocess import spawn_ranks

    per_card = device == "cuda"
    n = torch.cuda.device_count() if per_card else int(max_ranks or 1)
    if per_card and max_ranks:
        n = min(n, int(max_ranks))
    if not per_card:
        print(f"ranks share {device}: the efficiency figure says nothing "
              "about scaling (the ranks time-slice one device)", flush=True)
    results = {}
    for dp, fp in mesh_shapes(n):
        rates = spawn_ranks(_measure_rank, dp * fp, (dp, fp), device=device)
        results[dp, fp] = rates[0]
        eff = rates[0] / (results[1, 1] * dp * fp)
        print(f"mesh dp={dp} fp={fp}: {rates[0]:.2f} prob-iters/s, "
              f"scaling efficiency {eff:.2f}", flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("max_ranks", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank), cuda:i or cpu (ranks "
                         "share one device)")
    args = ap.parse_args()
    main(args.max_ranks, args.device)
    sys.exit(0)
