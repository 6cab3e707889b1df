"""Readers shared by the device's per-layer metrics (traced runs)."""

import sys


def idle_pct(run):
    """100 (1 - busy / window) over the profiled calls: busy is the
    union of the device operations' intervals."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_iter(run):
    """Device operations (kernels, copies, fills) over the profiled calls
    x configured iterations."""
    tr = run.trace
    if tr is None or not tr.calls or not tr.device:
        return None
    return tr.device_ops / (tr.calls * run.iters)


def roofline_pct(run, label, kernels, work):
    """100 x the least time of ``work`` (operations, bytes) over the
    profiled calls / the device time of the operations whose function is
    in ``kernels`` (None where none ran)."""
    from benchmark import work as w

    tr = run.trace
    if tr is None or not tr.calls:
        return None
    seconds = tr.seconds_of(kernels)
    least = w.least_seconds(*(tr.calls * x for x in work), run.device_name)
    if seconds <= 0 or least is None:
        return None
    print(f"[{label}] bound by {least[1]}: {tr.calls * work[0]:.6e} "
          f"operations, {tr.calls * work[1]:.6e} bytes over {tr.calls} calls;"
          f" least {1e3 * least[0]:.6f} ms of {1e3 * seconds:.6f} ms of "
          f"{', '.join(kernels)}", file=sys.stderr)
    return 100.0 * least[0] / seconds
