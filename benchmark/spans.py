"""The program's spans in the profiler trace, read beside ``trace.py``.

The port marks its phases with ``torch.profiler.record_function`` spans
named ``gvi.*`` (``gaussianvi_tpu_torch/utils/profiling.py``): a call's
``gvi.optimize`` holds ``gvi.engine``, ``gvi.init``, a ``gvi.iter`` an
iteration (``gvi.gradient``, ``gvi.trials``, ``gvi.select``) and
``gvi.finish``; ``gvi.kernel.<name>`` marks each launch of a hand-written
kernel.  The profiler writes them as ``user_annotation`` events on the
host's clock, the clock of the device's operations.  :class:`SpanTrace` is
a :class:`trace.Trace` that keeps them, with the CUDA runtime's launch
events, and so can say:

* which span launched each device operation: the operation's
  ``args.correlation`` names its launch, and the innermost span that
  covers the launch is its span;
* what the host was doing in an idle gap that no operator covers: the
  innermost span at the gap's middle (an operator that covers it still
  names it, as in :meth:`trace.Trace.idle_gaps`);
* by span name: count, host time, self time (less its direct children),
  the device operations it launched and their device time, and the idle
  time named after it.

Every number the base class returns for the same events is unchanged
except the names of the idle gaps that no operator covers.  The harness
loads a plain ``Trace``; this module's command runs one cell's traced run
through the harness with a ``SpanTrace`` in its place:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

and prints, on standard error, the harness's lines and one ``[spans]``
line (per span name: count, host ms, self ms, device operations launched,
device ms launched, idle ms), then one JSON line: the result, the span
metrics, the table, and the median traced and untraced call.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark.trace import DEVICE_CATS, Trace  # noqa: E402

PREFIX = "gvi."
KERNEL = "gvi.kernel."
ROOT = "gvi.optimize"
ITER = "gvi.iter"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
NO_OP = "host: no operator"
OUTSIDE = "(outside spans)"


class SpanTrace(Trace):
    """A profiled window with the program's spans.  Times in seconds."""

    def __init__(self, events: list):
        super().__init__(events)
        # (start, end, name), by start, outer before inner; each span's
        # direct parent (-1: none)
        self.spans, self.parent = [], []
        # per device operation (as ``self.device``): its launch's innermost
        # span, -1 outside every span, None where no launch was seen
        self.op_span = [None] * len(self.device)
        if not self.calls:
            return
        launches, corr = {}, []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            cat = str(e.get("cat", "")).lower()
            args = e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = a
                continue
            # the base class's filter, so ``corr`` follows ``self.device``
            if b <= self.start or a >= self.end:
                continue
            if cat in DEVICE_CATS:
                corr.append(args.get("correlation"))
            elif (cat == "user_annotation"
                  and str(e.get("name", "")).startswith(PREFIX)):
                self.spans.append((a, b, e["name"]))
        self.spans.sort(key=lambda s: (s[0], -s[1]))
        self._starts = [s[0] for s in self.spans]
        stack = []
        for i, (a, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.op_span = [None if c not in launches
                        else self.innermost(launches[c]) for c in corr]

    def innermost(self, t: float) -> int:
        """The index of the innermost span covering ``t``, -1 if none."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i

    def _ancestors(self, i: int):
        while i >= 0:
            yield i
            i = self.parent[i]

    def named_gaps(self):
        """``[(start, end, name), ...]``: each idle gap of the window named
        as :meth:`trace.Trace.idle_gaps` names it, or after the innermost
        span at its middle where no operator covers it."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, i - 256):i] if h[1] >= mid]
            if inner:
                name = min(inner, key=lambda h: h[1] - h[0])[2]
            else:
                j = self.innermost(mid) if self.spans else -1
                name = self.spans[j][2] if j >= 0 else NO_OP
            out.append((a, b, name))
        return out

    def idle_gaps(self, count: int = 10):
        """``[[name, seconds], ...]``: the idle time by :meth:`named_gaps`'
        names, largest first."""
        by = defaultdict(float)
        for a, b, name in self.named_gaps():
            by[name[:160]] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:count]]

    def span_table(self) -> dict:
        """``{name: {count, host_ms, self_ms, device_ops, device_ms,
        idle_ms}}`` over the window; a device operation counts for the
        innermost span at its launch.  The row ``(outside spans)`` holds
        the operations launched outside every span or whose launch was not
        seen, and the idle that nothing names."""
        rows = defaultdict(lambda: dict(count=0, host_ms=0.0, self_ms=0.0,
                                        device_ops=0, device_ms=0.0,
                                        idle_ms=0.0))
        children = [0.0] * len(self.spans)
        for i, p in enumerate(self.parent):
            if p >= 0:
                children[p] += self.spans[i][1] - self.spans[i][0]
        for i, (a, b, name) in enumerate(self.spans):
            r = rows[name]
            r["count"] += 1
            r["host_ms"] += 1e3 * (b - a)
            r["self_ms"] += 1e3 * (b - a - children[i])
        for (a, b, _), j in zip(self.device, self.op_span):
            r = rows[self.spans[j][2] if j is not None and j >= 0
                     else OUTSIDE]
            r["device_ops"] += 1
            r["device_ms"] += 1e3 * (b - a)
        for a, b, name in self.named_gaps():
            name = OUTSIDE if name == NO_OP else name
            if name in rows:
                rows[name]["idle_ms"] += 1e3 * (b - a)
        return dict(rows)

    def loop_host_ms_per_iter(self, iters: int):
        """Summed host time of the ``gvi.iter`` spans / (profiled calls x
        ``iters``), in ms; None without such spans."""
        total = sum(b - a for a, b, n in self.spans if n == ITER)
        if not self.calls or not total:
            return None
        return 1e3 * total / (self.calls * iters)

    def call_host_ms(self):
        """The mean over the ``gvi.optimize`` spans of their host time less
        that of the ``gvi.iter`` spans inside them, in ms: what a call
        spends outside its iterations (engine, init, finish)."""
        roots = {i: b - a for i, (a, b, n) in enumerate(self.spans)
                 if n == ROOT}
        if not roots:
            return None
        for i, (a, b, n) in enumerate(self.spans):
            if n == ITER:
                root = next((j for j in self._ancestors(self.parent[i])
                             if j in roots), None)
                if root is not None:
                    roots[root] -= b - a
        return 1e3 * statistics.fmean(roots.values())

    def glue_device_pct(self):
        """100 x the device time of the operations launched outside every
        ``gvi.kernel.*`` span / that of all operations; None without the
        program's spans or without a launch seen."""
        if not self.spans or not self.device or all(
                j is None for j in self.op_span):
            return None
        total = glue = 0.0
        for (a, b, _), j in zip(self.device, self.op_span):
            total += b - a
            if j is None or not any(
                    self.spans[k][2].startswith(KERNEL)
                    for k in self._ancestors(j)):
                glue += b - a
        return 100.0 * glue / total if total > 0 else None

    def no_operator_idle_share(self):
        """The share of the window's idle time that neither an operator
        nor a span names."""
        gaps = self.named_gaps()
        idle = sum(b - a for a, b, _ in gaps)
        return (sum(b - a for a, b, n in gaps if n == NO_OP) / idle
                if idle > 0 else None)


def load(path) -> SpanTrace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return SpanTrace(events)


def spans_line(table: dict) -> str:
    return "[spans] " + "; ".join(
        f"{n} {r['count']} x, host {r['host_ms']:.6f} ms, self "
        f"{r['self_ms']:.6f} ms, {r['device_ops']} ops, "
        f"{r['device_ms']:.6f} device ms, {r['idle_ms']:.6f} idle ms"
        for n, r in sorted(table.items(), key=lambda x: -x[1]["host_ms"]))


def run(root, workload: str, seed: int, seconds: float,
        device: str = "cuda") -> dict:
    """One traced run of ``workload`` through the harness, its trace read
    as a :class:`SpanTrace`: the harness's result, the span metrics and
    table, and each timed call's host time, traced or not."""
    import torch

    from benchmark import harness, trace

    kept, calls = {}, []

    def keep(path):
        kept["trace"] = load(path)
        return kept["trace"]

    def wrap(optimize):
        def call(graph, state, config):
            traced = torch._C._autograd._profiler_enabled()
            t0 = time.perf_counter()
            out = optimize(graph, state, config)
            if device == "cuda":
                torch.cuda.synchronize()
            calls.append((traced, time.perf_counter() - t0))
            return out
        return call

    # the harness reads the trace through ``trace.load`` when the traced
    # calls end and deletes the file after: the span reader takes its place
    # for this run only
    plain_load, trace.load = trace.load, keep
    try:
        result, code = harness.run_cell(root, workload, seed, seconds, True,
                                        device, wrap=wrap)
    finally:
        trace.load = plain_load
    if result is None:
        raise SystemExit(code)
    tr, iters = kept["trace"], harness.Cell.find(
        root, workload).cfg["gvi"]["niters"]
    timed = calls[2:]                        # after the two warm-up calls
    traced = [1e3 * s for on, s in timed if on]
    untraced = [1e3 * s for on, s in timed if not on]
    return {
        "result": result,
        "spans": {
            "loop_host_ms_per_iter": tr.loop_host_ms_per_iter(iters),
            "call_host_ms": tr.call_host_ms(),
            "glue_device_pct": tr.glue_device_pct(),
            "no_operator_idle_share": tr.no_operator_idle_share(),
            "idle_s": tr.window_s - tr.busy_s,
            "launches_seen": sum(j is not None for j in tr.op_span),
            "device_ops": tr.device_ops,
        },
        "table": tr.span_table(),
        "calls_ms": {"traced_median": statistics.median(traced),
                     "untraced_median": statistics.median(untraced),
                     "traced": len(traced), "untraced": len(untraced)},
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = run(root, args.workload, args.seed, args.seconds)
    print(spans_line(out["table"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
