"""The readers of the metrics, one file a metric, found by name."""
