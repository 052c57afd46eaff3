"""Utilities of the port: ``profiling`` (tracing, slope timing, H100
peaks) and ``flops`` (analytic Whisper train-step FLOPs)."""
