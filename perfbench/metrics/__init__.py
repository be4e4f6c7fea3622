"""Metric readers: one module per metric, each with ``read(rec)``."""
