"""Shared helpers of the kernel wrappers (port of ``audax/ops/common.py``).

The JAX module also held the TPU-platform predicate; the port decides per
tensor instead (``is_cuda``), in each wrapper.
"""

from __future__ import annotations

__all__ = ["pad_to"]


def pad_to(n: int, m: int) -> int:
    """Round ``n`` up to the next multiple of ``m``."""
    return ((n + m - 1) // m) * m
