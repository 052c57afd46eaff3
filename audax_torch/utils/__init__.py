"""Utilities of the port: ``profiling`` (tracing, slope timing, H100
peaks)."""
