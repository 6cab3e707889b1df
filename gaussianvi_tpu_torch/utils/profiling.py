"""Timing and tracing.

Counterpart of ``gaussianvi_tpu/utils/profiling.py``: a wall-clock timer
and a best-of-N timing that wait for the card (``torch.cuda.synchronize``)
so that queued kernels are counted, a ``torch.profiler`` trace
exported for Perfetto / ``chrome://tracing``, and the program's named
spans in that trace.

Spans.  The loop, its entry points and the kernel wrappers mark their
phases with :func:`span`; under :func:`trace` (or any ``torch.profiler``
recording) each is a ``user_annotation`` event named ``gvi.<phase>`` on the
host's timeline, on the same clock as the device's kernels.  A call's
spans nest under its ``gvi.optimize``:

* ``gvi.engine``: the engine's construction (routes, fused operands);
* ``gvi.init``: the initial iterate's covariance, log det and factor costs;
* ``gvi.iter``, one per iteration, holding ``gvi.gradient`` (the step
  direction), ``gvi.trials`` (the line search's trial costs up to the
  pick) and ``gvi.select`` (accept, escalate, freeze, the new carry);
  its own time is the head: temper, the iterate's cost, the trial
  schedule;
* ``gvi.finish``: the final covariance refresh and the stacked history;
* ``gvi.kernel.<name>``: one hand-written kernel's launch with its host
  prep, ``<name>`` its wrapper's key in ``kernels.WRAPPERS``; these sit
  where the wrappers count ``launches``, so a profiled call holds as many
  as ``kernels.launch_counts()`` grows by.

With no profiler recording a span is one shared null context.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync():
    """Wait for the card's queued work (none on a host without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock stopwatch that waits for the card before reading."""

    def __init__(self):
        self.start()

    def start(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def elapsed_ms(self, result=None) -> float:
        """Milliseconds since :meth:`start`, once the card has finished
        its queued work (``result``, the JAX package's argument, is not
        needed for that)."""
        del result
        _sync()
        return (time.perf_counter() - self._t0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir):`` profiles the block (CPU, and CUDA where there
    is a card) and writes ``dir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """``with span("gvi.<phase>"):`` names the block in a profiler trace
    (``torch.profiler.record_function``) while a profiler records, and
    costs one flag check otherwise."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def time_fn(fn, *args, repeats: int = 5, warmup: int = 1) -> float:
    """Best-of-``repeats`` wall time (seconds) of ``fn(*args)``, after
    ``warmup`` calls, each waited for on the card."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best
