"""Flash-attention tile sweep, forward and backward: port of
``tools/attn_block_probe.py``.

The JAX tool swept ``flash_attention(block_q=, block_k=)`` over TPU VMEM
tiles (2048, 1024, ...) at Whisper-small's encoder shape. On the card the
tiles are those the kernels are built at (``ops/attention.py:TILES``, every
pair of 32, 64 and 128 at head_dim 64): ``block_q`` is the query rows per
block of K2 and K7 and the query tile K8 loops over, ``block_k`` the keys
per tile of K2 and K7 and the keys per block of K8. The sweep runs the
defaults (``None``: bf16 K2 at ``WGMMA_TILE``, K7/K8 at
``BWD_WGMMA_TILE``) and then every tile of that set, each through the real
``flash_attention``: the forward alone, and the gradient of q, k and v of
``sum(flash_attention(q, k, v))`` (K2 then K7 + K8); ``grad_only_us`` is
the difference, the backward's share. Each row also holds the largest
difference of its output and gradients from the default's.

Times are slopes over eager calls between CUDA events
(``utils/profiling.py:slope_timed_eager``, 5 and 25 calls, best of 2).
FLOPs: 4*B*S^2*(H*hd) forward, 2.5x that backward (the JAX tool's
convention). Verdict: ``keep`` when a tile's forward + backward beats the
default's by ``tools.KEEP_RATIO``, else ``reject``; ``best`` names the
fastest tile (forward + backward; null: the defaults), ``best_fwd`` the
fastest forward and ``best_bwd`` the fastest backward share, each with the
defaults' row read as the default tile of its kernels.

    python -m audax_torch.tools.attn_block_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops.attention import (BWD_WGMMA_TILE, TILES, WGMMA_TILE,
                                       flash_attention)
from audax_torch.tools import cli, report, verdict
from audax_torch.utils.profiling import slope_timed_eager

__all__ = ["GRID", "main"]

#: the defaults, then every tile the kernels are built at
GRID = ((None, None),) + TILES
_CUDA_TIMING = ((5, 25), 2)
_CPU_TIMING = ((1, 4), 2)


def main(device=None, out=None, b=8, heads=12, seq=1500, hd=64) -> dict:
    """The sweep at bf16 [b, heads, seq, hd] (CPU: [2, 2, 64, 64])."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        b, heads, seq = 2, 2, 64
    iters, repeats = _CUDA_TIMING if cuda else _CPU_TIMING
    rng = np.random.default_rng(0)
    shp = (b, heads, seq, hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    flops = 4.0 * b * seq ** 2 * (heads * hd)

    def timed(fn):
        return slope_timed_eager(fn, iters=iters, repeats=repeats,
                                 device=dev if cuda else None)

    rows, ref = [], None
    for bq, bk in GRID:
        def fwd(bq=bq, bk=bk):
            return flash_attention(q, k, v, block_q=bq, block_k=bk)

        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def bwd(bq=bq, bk=bk):
            out_ = flash_attention(qg, kg, vg, block_q=bq, block_k=bk)
            return torch.autograd.grad(out_.float().sum(), (qg, kg, vg))

        got = [fwd().float()] + [g.float() for g in bwd()]
        ref = got if ref is None else ref
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        s_f, s_b = timed(fwd), timed(bwd)
        rows.append({"block_q": bq, "block_k": bk, "fwd_us": 1e6 * s_f,
                     "fwd_tflops": flops / s_f / 1e12, "bwd_us": 1e6 * s_b,
                     "bwd_tflops": 2.5 * flops / s_b / 1e12,
                     "grad_only_us": 1e6 * (s_b - s_f),
                     "max_abs_err_vs_default": err})
    total = [r["fwd_us"] + r["bwd_us"] for r in rows]
    best = rows[int(np.argmin(total))]

    def fastest(key, default):
        row = rows[int(np.argmin([r[key] for r in rows]))]
        return {"block_q": row["block_q"] or default[0],
                "block_k": row["block_k"] or default[1]}
    return report("attn_block_probe", dev, rows,
                  verdict(min(total[1:]), total[0]), out, shape=list(shp),
                  best={"block_q": best["block_q"],
                        "block_k": best["block_k"]},
                  best_fwd=fastest("fwd_us", WGMMA_TILE),
                  best_bwd=fastest("grad_only_us", BWD_WGMMA_TILE),
                  timing="eager calls between CUDA events, slope of "
                         f"{iters[0]} and {iters[1]} calls, best of "
                         f"{repeats}" if cuda else "host clock (CPU)")


if __name__ == "__main__":
    cli(main)
