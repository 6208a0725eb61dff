"""Command-line entry points: the five-step pipeline (rename_data,
convert_split, preprocess, train, predict, compute_metrics)."""
