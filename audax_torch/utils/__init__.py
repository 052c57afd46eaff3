"""Utilities of the port: ``profiling`` (tracing, slope timing, H100
peaks), ``flops`` (analytic Whisper train-step FLOPs) and ``reports``
(parameter and memory breakdowns)."""
