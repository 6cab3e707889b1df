"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

The harness profiles a fixed number of timed calls, each inside a
``bench.call`` annotation that ends after the ``synchronize()`` that
closes it, and exports a Chrome trace.  Here the trace becomes:

* the profiled window: from the first annotation's start to the last
  one's end, in seconds;
* the device operations inside it (kernels, copies, fills), each an
  interval with its name;
* the host's operator events, to say what the host was doing while the
  device was idle.

Busy time is the length of the union of the device intervals inside the
window (overlapping operations count once); idle is the rest.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

ANNOTATION = "bench.call"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_FUNC = re.compile(r"^(?:void\s+)?(?:[\w]+::)*([A-Za-z_]\w*)")


def function_name(name: str) -> str:
    """The function a kernel's demangled name calls: ``void
    trials_kernel<float, 4, RangeCost>(...)`` -> ``trials_kernel``."""
    m = _FUNC.match(name.strip())
    return m.group(1) if m else name


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A profiled window.  Times in seconds."""

    def __init__(self, events: list):
        calls = [e for e in events if e.get("name") == ANNOTATION
                 and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        self.calls = len(calls)
        if not calls:
            self.start = self.end = 0.0
            self.device, self.host = [], []
            return
        self.start = min(e["ts"] for e in calls) * 1e-6
        self.end = max(e["ts"] + e["dur"] for e in calls) * 1e-6
        self.device = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            if b <= self.start or a >= self.end:
                continue
            cat = str(e.get("cat", "")).lower()
            if cat in DEVICE_CATS:
                self.device.append((max(a, self.start), min(b, self.end),
                                    e.get("name", "")))
            elif cat == "cpu_op":
                self.host.append((a, b, e.get("name", "")))

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self):
        return _merge([(a, b) for a, b, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @property
    def device_ops(self) -> int:
        return len(self.device)

    def seconds_of(self, functions) -> float:
        """Summed device time of the operations whose function is one of
        ``functions`` or starts with one of them."""
        return sum(b - a for a, b, n in self.device
                   if function_name(n).startswith(tuple(functions)))

    def top_device_ops(self, count: int = 10):
        """``[[name, seconds], ...]``: the device operations that took the
        most time, summed by name."""
        by = defaultdict(float)
        for a, b, n in self.device:
            by[n[:160]] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:count]]

    def idle_gaps(self, count: int = 10):
        """``[[host operation, seconds], ...]``: the device's idle time in
        the window summed by the innermost host operator running at the
        middle of each gap (``"host: no operator"`` where none is)."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            # the operators that started last before the middle hold the
            # innermost one that covers it
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, i - 256):i] if h[1] >= mid]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "host: no operator")
            by[name[:160]] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:count]]


def load(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return Trace(events)
