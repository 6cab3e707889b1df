"""Device operations per call and iteration, in an interactive cell."""

from benchmark.metrics._device import launches_per_iter as read  # noqa: F401
