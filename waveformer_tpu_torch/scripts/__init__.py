"""Command-line entry points: predict and compute_metrics."""
