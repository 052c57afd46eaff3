"""Helpers the per-layer readers (``metrics/*.py``) share."""

from __future__ import annotations

import importlib
from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else None


def roofline(name: str):
    return importlib.import_module(f"benchmark.rooflines.{name}")


def roofline_pct(ctx, name: str) -> Optional[float]:
    """Least time of the window's calls over the device time of the
    kernel's launches, in percent; nothing when the kernel did not run or
    its launches do not match the calls recorded (the calls then went
    elsewhere, and their shapes say nothing of these launches)."""
    if ctx.trace is None:
        return None
    mod = roofline(name)
    calls = ctx.calls.get(name, [])
    spent, launches = ctx.trace.time_of(mod.NAMES)
    expected = len(calls) * mod.LAUNCHES_PER_CALL
    if not calls or spent <= 0 or launches != expected:
        return None
    return 100.0 * mod.least_seconds(calls, ctx.peaks) / spent
