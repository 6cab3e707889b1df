"""Timing and tracing.

Counterpart of ``gaussianvi_tpu/utils/profiling.py``: a wall-clock timer
and a best-of-N timing that wait for the card (``torch.cuda.synchronize``)
so that queued kernels are counted, and a ``torch.profiler`` trace
exported for Perfetto / ``chrome://tracing``.
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
