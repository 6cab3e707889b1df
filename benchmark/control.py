"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in the precision below
the configuration's (float32 with TF32 matrix products, where the
configuration states float32 with TF32 off: ``dense_gvi.Problems.products``),
on a call's problems as the window's first call draws them, judged as a
run judges the program.  A control reading is the upper end of a limit
(``PERF.md``).

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints each seed's readings beside the configuration's limits, on the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def control_readings(root, workload: str, seed: int, device,
                     problems: int | None = None) -> dict:
    """The control's readings (``judge.readings``, with the
    configuration's limits) for one seed, on the first ``problems``
    problems (all) of the window's first call."""
    import torch

    from benchmark import judge
    from benchmark.harness import Cell
    from benchmark.reference import dense_gvi
    from benchmark.traffic import seed_seq

    cell = Cell.find(root, workload)
    cfg, tr, fam = cell.cfg, cell.traffic, cell.family
    shared = fam.make_shared(cfg)
    inputs = fam.make_inputs(cfg, seed_seq(seed, 0, 0),
                             tr["requests_per_call"], tr["per_request"])
    if problems is not None:
        inputs = {k: v[:problems] for k, v in inputs.items()}
    f32 = torch.float32
    eps = torch.finfo(f32).eps
    mu = torch.as_tensor(inputs["init_mu"], dtype=f32, device=device)
    count, n, s = mu.shape
    pd = (torch.eye(s, dtype=f32, device=device) * cfg["init_prec_scale"]
          ).expand(count, n, s, s).clone()
    po = torch.zeros(count, n - 1, s, s, dtype=f32, device=device)
    sched = dense_gvi.Schedule.from_config(cfg["gvi"])
    prob = fam.build_reference(cfg, inputs, eps, device, shared, dtype=f32)
    prob.products = "tf32"
    with torch.no_grad():
        rec, fin = dense_gvi.run(prob, mu, pd, po, sched)
    pick = np.sort(seed_seq(seed, 2).permutation(count)[:tr["checked"]])
    idx = torch.as_tensor(pick, device=device)
    out = {k: v.index_select(0, idx) for k, v in rec.items()}
    out.update({"final_" + k: v.index_select(0, idx) for k, v in fin.items()})
    raw = {k: v[pick] for k, v in inputs.items()}
    ref = fam.build_reference(cfg, raw, eps, device, shared)
    return judge.readings(ref, out, raw["init_mu"], cfg["init_prec_scale"],
                          sched, f32, device, cfg["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark.harness import Cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cfg = Cell.find(root, args.workload).cfg
    limits = cfg["limits"]
    for seed in args.seeds:
        t = time.perf_counter()
        read = control_readings(root, args.workload, seed,
                                torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "max": {k: float(np.max(v)) for k, v in read.items()
                                  if not k.startswith("void_")},
                          "median": {k: float(np.median(v))
                                     for k, v in read.items()
                                     if not k.startswith("void_")},
                          "void": {k[5:]: int(np.sum(v))
                                   for k, v in read.items()
                                   if k.startswith("void_")},
                          "iterates": int(read["start"].size
                                          * cfg["gvi"]["niters"]),
                          "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
