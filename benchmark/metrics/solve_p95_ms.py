"""The 95th percentile (nearest rank) over every call in the window of
the host-clock time from the call to the synchronize() after it, in ms."""

import math
import sys


def read(run):
    ms = sorted(1e3 * (b - a) for a, b in run.calls)
    rank = math.ceil(0.95 * len(ms))
    print(f"[solve_p95_ms] rank {rank} of {len(ms)} calls; median "
          f"{ms[len(ms) // 2]:.4f} ms, {len(ms) - rank} calls above",
          file=sys.stderr)
    return ms[rank - 1]
