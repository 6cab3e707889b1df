"""The device's idle share of the profiled calls, in a bulk cell."""

from benchmark.metrics._device import idle_pct as read  # noqa: F401
