"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root: the cell
(``workloads``), its configuration (``configs``, whose ``file`` names its
family, ``families/<family>.py``), its traffic (``workloads/<cell>.json``)
and the readers of its metrics (``metrics/<metric>.py``, each a
``read(run)`` returning the value or None).

A run:

1. set-up: draws a pool of calls' inputs from the seed (``traffic.py``),
   builds each call's problems through the program's public constructors,
   and makes two warm-up calls (the first builds the kernels);
2. the window: one caller, closed loop.  Each call is
   ``optimize(graph, state, config, method="ngd")`` on the next call of
   the pool, timed on the host's clock from the call to the
   ``torch.cuda.synchronize()`` after it; calls start until ``seconds``
   have passed since the first.  After each call a few of its problems'
   outputs, drawn from the seed, are kept;
3. with ``--trace 1``, a fixed number of calls from the middle of the
   window run under ``torch.profiler`` (``trace.py``);
4. after the window: the peak of device memory is read, the program's
   state freed, and the kept outputs are judged against the plain
   reference (``judge.py``);
5. the result: the numbers compared and their limits on standard error
   and last in the result, then one JSON line on standard output.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BANNED = ("jax", "jaxlib", "flax", "gaussianvi_tpu")
GVI_FIELDS = ("niters", "niters_lowtemp", "niters_backtrack", "temperature",
              "high_temperature", "step_size_base", "step_decay", "stop_err",
              "ema_alpha")
OUTPUTS = ("mu", "prec_diag", "prec_off", "cost", "accepted_step",
           "final_mu", "final_prec_diag", "final_prec_off")


def note(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is a banned one, compared
    whole (the program's own name begins with one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` and its files give it."""

    root: Path
    spec: dict
    entry: dict
    cfg: dict
    traffic: dict
    family: object

    @classmethod
    def find(cls, root: Path, name: str) -> "Cell":
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
        cfg = json.loads((root / conf["file"]).read_text())
        home = root / spec["paths"][0]
        traffic = json.loads((home / "workloads" / f"{name}.json").read_text())
        sys.path.insert(0, str(root))
        import benchmark.families  # noqa: F401  (the package of the modules)
        family = load_module(home / "families" / f"{cfg['family']}.py",
                             f"benchmark.families.{cfg['family']}")
        return cls(root, spec, entry, cfg, traffic, family)

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's metrics: end-to-end, or per-layer with a trace."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.entry["name"] in m.get("workloads", [self.entry["name"]])]

    def reader(self, name: str):
        path = self.root / self.spec["paths"][0] / "metrics" / f"{name}.py"
        return load_module(path, "benchmark_metric_" + name.replace(".", "_"))


@dataclass
class Run:
    """What a run measured; the metrics' readers take it."""

    cell: Cell
    device_name: str
    problems_per_call: int
    setup_s: float
    calls: list = field(default_factory=list)        # (start, end) seconds
    trace: object = None                              # trace.Trace
    traced_calls: int = 0
    elt: int = 4

    @property
    def iters(self) -> int:
        return self.cell.cfg["gvi"]["niters"]

    def shapes(self) -> dict:
        return self.cell.family.shapes(self.cell.cfg)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _export(prof) -> tempfile.TemporaryDirectory:
    """Stop the profiler and write its trace (``trace.json``) into a new
    temporary directory."""
    prof.stop()
    tmp = tempfile.TemporaryDirectory()
    prof.export_chrome_trace(os.path.join(tmp.name, "trace.json"))
    return tmp


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             wrap=None):
    """One run of ``workload``: ``(result dict, exit code)``.

    ``device="cpu"`` and ``wrap`` are for tests: ``wrap(optimize)``
    returns the function the window calls in its place."""
    import torch

    from . import judge, traffic as traffic_mod
    from .reference import dense_gvi
    from .trace import ANNOTATION, load
    from .traffic import seed_seq

    t_process = time.perf_counter() if t_process is None else t_process
    cell = Cell.find(root, workload)
    cfg, tr = cell.cfg, cell.traffic
    dtype = {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    from gaussianvi_tpu_torch.inference.config import GVIConfig
    from gaussianvi_tpu_torch.inference.optimize import optimize

    gcfg = GVIConfig(**{k: cfg["gvi"][k] for k in GVI_FIELDS})
    call_fn = optimize if wrap is None else wrap(optimize)
    pool = traffic_mod.make_pool(cell, seed, dtype, dev)
    per_call = pool[0].problems

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for i in range(2):                       # warm-up: builds the kernels
        call_fn(pool[i % len(pool)].graph, pool[i % len(pool)].state, gcfg)
        sync()
    # the set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    run = Run(cell, torch.cuda.get_device_name(dev) if cuda else "cpu",
              per_call, 0.0, elt=torch.finfo(dtype).bits // 8)

    kept, prof, tmp = [], None, None
    n_traced = tr["traced_calls"] if trace else 0
    run.setup_s = time.perf_counter() - t_process
    w0 = time.perf_counter()
    c = 0
    while True:
        elapsed = time.perf_counter() - w0
        # a traced run profiles at least one call, after the window if
        # none started in its second half
        untraced = n_traced and run.traced_calls == 0
        if c and elapsed >= seconds and not untraced:
            break
        entry = pool[c % len(pool)]
        if untraced and prof is None and elapsed >= seconds / 2:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        with (torch.profiler.record_function(ANNOTATION) if prof is not None
              else contextlib.nullcontext()):
            final, hist = call_fn(entry.graph, entry.state, gcfg)
            sync()
        t1 = time.perf_counter()
        run.calls.append((t0, t1))
        if prof is not None:
            run.traced_calls += 1
            if run.traced_calls == n_traced:
                tmp = _export(prof)
                prof = None
        rows = seed_seq(seed, 1, c).choice(per_call, tr["kept_per_call"],
                                           replace=False)
        idx = torch.as_tensor(rows, device=dev)
        out = dict(zip(OUTPUTS[:5], (hist.mu, hist.prec_diag, hist.prec_off,
                                      hist.cost, hist.accepted_step)))
        out.update(final_mu=final.mu, final_prec_diag=final.precision.diag,
                   final_prec_off=final.precision.off)
        kept.append((c % len(pool), rows,
                     {k: v.index_select(0, idx) for k, v in out.items()}))
        del final, hist, out
        c += 1
    if prof is not None:                     # the window ended first
        tmp = _export(prof)

    gc.unfreeze()
    found = banned_modules()
    if found:
        note("loaded in the run's process: " + ", ".join(found))
        return None, 3
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if tmp is not None:
        run.trace = load(os.path.join(tmp.name, "trace.json"))
        tmp.cleanup()

    # the check: a sample of the kept outputs, drawn from the seed
    sample = seed_seq(seed, 2).permutation(len(kept) * tr["kept_per_call"])
    sample = sorted(sample[:tr["checked"]])
    inputs, rows_out, calls_of = [], {k: [] for k in OUTPUTS}, []
    for j in sample:
        c_i, r_i = divmod(int(j), tr["kept_per_call"])
        p_i, rows, out = kept[c_i]
        calls_of.append(c_i)
        inputs.append((p_i, int(rows[r_i])))
        for k in OUTPUTS:
            rows_out[k].append(out[k][r_i].cpu())
    raw = traffic_mod.rows(pool, inputs)
    del kept, pool
    if cuda:
        torch.cuda.empty_cache()
    out = {k: torch.stack(v) for k, v in rows_out.items()}
    guard = torch.finfo(dtype).eps
    problems = cell.family.build_reference(cfg, raw, guard, dev,
                                           cell.shared)
    sched = dense_gvi.Schedule.from_config(cfg["gvi"])
    t_ref = time.perf_counter()
    read = judge.readings(problems, out, raw["init_mu"],
                          cfg["init_prec_scale"], sched, dtype, dev,
                          cfg["limits"])
    bad, checks = judge.verdict(read, cfg["limits"])
    note(f"[check] {len(sample)} problems of {len(run.calls)} calls against "
         f"the reference in {time.perf_counter() - t_ref:.1f} s; "
         f"{int(bad.sum())} outside a limit")

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    durations = [b - a for a, b in run.calls]
    note(f"[window] {len(run.calls)} calls of {per_call} problems in "
         f"{run.calls[-1][1] - run.calls[0][0]:.3f} s, median call "
         f"{1e3 * statistics.median(durations):.3f} ms; set-up "
         f"{run.setup_s:.3f} s; device {run.device_name}"
         + (f" ({power_limit()})" if cuda else ""))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": run.device_name, "count": 1,
                   "memory_peak_bytes": int(memory)}
    result = {"correct": not bool(bad.any()), "attempted": len(run.calls),
              "failed": len({calls_of[i] for i in np.flatnonzero(bad)}),
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    note("[readings] " + "; ".join(
        f"{k} max {np.max(v):.6e}" for k, v in read.items()
        if not k.startswith("void_")))
    note(f"[readings] of {out['cost'].numel()} iterates, where a limit "
         "admits an error as large as the quantity: " + "; ".join(
             f"{k[5:]} {int(np.sum(v))}" for k, v in read.items()
             if k.startswith("void_")))
    for name, v in checks.items():       # the last lines: each number
        note(f"[check] {name} {v['value']:.6e} limit {v['limit']:.6e}")
    result["checks"] = checks
    return result, 0


def main(argv=None, t_process: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent

    import torch

    cell = Cell.find(root, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"{args.workload} needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " visible")
        return 2
    result, code = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_process)
    if result is None:
        return code
    print(json.dumps(result), flush=True)
    return 0
