"""Preprocessed-case datasets and split factories."""
