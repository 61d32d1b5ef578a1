"""Neighbour gather: table (B, N, D), idx (B, N, k) -> (B, N, k, D), the
row gather's count."""

from portbench.opwork.gather_rows import work  # noqa: F401
