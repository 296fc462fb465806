"""Observability of the port: per-query span trees (`tracing.py`)."""
