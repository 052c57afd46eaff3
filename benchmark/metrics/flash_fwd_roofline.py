"""Kernels: the least time of the window's flash_fwd calls
(``rooflines/flash_fwd.py``) over the device time of their launches, in
percent."""

from benchmark.lib.readers import roofline_pct

ROOFLINE = "flash_fwd"


def read(ctx):
    return roofline_pct(ctx, ROOFLINE)
