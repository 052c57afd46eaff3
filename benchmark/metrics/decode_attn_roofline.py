"""Kernels: the least time of the window's decode_attn calls
(``rooflines/decode_attn.py``) over the device time of their launches, in
percent."""

from benchmark.lib.readers import roofline_pct

ROOFLINE = "decode_attn"


def read(ctx):
    return roofline_pct(ctx, ROOFLINE)
