"""Entry points of the port that mirror the repository's `tools/` scripts."""
