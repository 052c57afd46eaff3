"""Kernels: the least time of the window's flash_bwd calls
(``rooflines/flash_bwd.py``) over the device time of their launches, in
percent."""

from benchmark.lib.readers import roofline_pct

ROOFLINE = "flash_bwd"


def read(ctx):
    return roofline_pct(ctx, ROOFLINE)
