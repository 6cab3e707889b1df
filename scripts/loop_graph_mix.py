"""Calls whose batch size varies from call to call, through ``optimize``:
what the loop graph (``inference/loop_graph.py``) costs and gains where a
call signature repeats less often than in the benchmark's cells, which
repeat one signature.

    python3 scripts/loop_graph_mix.py --seconds 10 --seed 5 --max-graphs 4,8

The problems are ``chain_est``'s (``benchmark/configs/chain_est.json``,
float32, drawn from the seed by ``benchmark/families/range_chain.py``),
two problem sets a batch size, taken in turn.  For each mix (the batch
size drawn per call from its sizes) and each bound on the kept
signatures, one JSON line: the calls' median / p95 (nearest rank) / mean
ms on the host clock around ``synchronize``, and the calls by how their
loop ran.  Then, per size of the first mixed set, a signature's first
three calls: eager, capture (with its replay), replay, in ms.  On a tree
without the loop graph every call runs eager and the counts are absent.
Runs on the card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MIXES = {
    "fixed64": (64,),
    "sizes4": (32, 48, 64, 96),
    "sizes8": (16, 32, 48, 64, 80, 96, 112, 128),
    "distinct": tuple(range(16, 129)),
}


def loop_graph():
    """The loop graph's module, or None on a tree without it."""
    try:
        from gaussianvi_tpu_torch.inference import loop_graph as lg
    except ImportError:
        return None
    return lg


def counts():
    try:
        from gaussianvi_tpu_torch.kernels import loop_graph_counts
    except ImportError:
        return None
    return loop_graph_counts()


def make_sets(sizes, seed, dev):
    """Two problem sets of each size: ``{b: [(graph, state), ...]}``."""
    from benchmark.families import range_chain
    from gaussianvi_tpu_torch.convert import state_from_arrays

    cfg = json.loads((ROOT / "benchmark/configs/chain_est.json").read_text())
    dtype = {"float32": torch.float32,
             "float64": torch.float64}[cfg["dtype"]]
    rng = np.random.default_rng(seed)
    sets = {}
    for b in sizes:
        sets[b] = []
        for _ in range(2):
            inputs = range_chain.make_inputs(cfg, rng, b, 1)
            graph = range_chain.build_program(cfg, inputs, dtype, dev)
            mu = inputs["init_mu"]
            _, n, s = mu.shape
            eye = np.eye(s) * cfg["init_prec_scale"]
            state = state_from_arrays(
                {"mu": mu, "prec_diag": np.broadcast_to(eye, (b, n, s, s)),
                 "prec_off": np.zeros((b, n - 1, s, s))}, dtype, dev)
            sets[b].append((graph, state))
    return cfg, sets


def timed(call, dev):
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    call()
    torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t)


def run_mix(name, sizes, sets, gcfg, seconds, rng, dev):
    from gaussianvi_tpu_torch import optimize

    lg = loop_graph()
    if lg is not None:
        lg.clear()
    before = counts()
    ms, turn = [], {b: 0 for b in sizes}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b = sizes[rng.integers(len(sizes))]
        graph, state = sets[b][turn[b] % 2]
        turn[b] += 1
        ms.append(timed(lambda: optimize(graph, state, gcfg), dev))
    after = counts()
    ranked = sorted(ms)
    out = {"mix": name, "calls": len(ms),
           "median_ms": statistics.median(ms),
           "p95_ms": ranked[math.ceil(0.95 * len(ms)) - 1],
           "mean_ms": statistics.fmean(ms)}
    if after is not None:
        out["loop"] = {k: after[k] - before[k] for k in after}
        out["max_graphs"] = lg.MAX_GRAPHS
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--max-graphs", default="4",
                    help="comma-separated bounds on the kept signatures")
    ap.add_argument("--mixes", default=",".join(MIXES))
    args = ap.parse_args()

    from gaussianvi_tpu_torch import GVIConfig, optimize

    dev = torch.device("cuda", torch.cuda.current_device())
    sizes = sorted({b for m in args.mixes.split(",") for b in MIXES[m]})
    cfg, sets = make_sets(sizes, args.seed, dev)
    gcfg = GVIConfig(**{k: cfg["gvi"][k] for k in (
        "niters", "niters_lowtemp", "niters_backtrack", "temperature",
        "high_temperature", "step_size_base", "step_decay", "stop_err",
        "ema_alpha")})
    # builds the kernels (per block size, not per batch size)
    optimize(*sets[sizes[0]][0], gcfg)
    torch.cuda.synchronize(dev)
    lg = loop_graph()
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__,
                      "loop_graph": lg is not None}), flush=True)
    bounds = ([int(m) for m in args.max_graphs.split(",")]
              if lg is not None else [None])
    for m in bounds:
        if lg is not None:
            lg.MAX_GRAPHS = m
        for name in args.mixes.split(","):
            rng = np.random.default_rng(args.seed + 1)
            print(json.dumps(run_mix(name, MIXES[name], sets, gcfg,
                                     args.seconds, rng, dev)), flush=True)
    if lg is not None:
        for b in MIXES["sizes4"]:
            lg.clear()
            graph, state = sets[b][0]
            first = [timed(lambda: optimize(graph, state, gcfg), dev)
                     for _ in range(3)]
            print(json.dumps({"size": b, "eager_ms": first[0],
                              "capture_ms": first[1],
                              "replay_ms": first[2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
