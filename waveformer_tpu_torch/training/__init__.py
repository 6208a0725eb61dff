"""Checkpoints (the params-only part used by the serving entry points)."""
