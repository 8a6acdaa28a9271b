"""Per-layer metric readers, one per metric, found by the metric's name."""
