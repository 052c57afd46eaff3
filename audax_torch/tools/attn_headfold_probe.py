"""Head folding in the flash forward, P1 against K2: port of
``tools/attn_headfold_probe.py``.

The TPU probe gave each grid step of the flash forward ``fold``
independent heads of the fused B*H axis, so that one head's softmax could
overlap another's matrix products. On the card the same fold is a template
parameter of K2's tensor-core bodies (``csrc/flash_fwd_sm90.cu``, wgmma,
in bf16; ``csrc/flash_fwd_tf32x3.cu``, 3xTF32 on mma.sync, in float32):
one block takes the same 64 query rows of ``fold`` consecutive heads,
each head one warp group with its own Q tile and K/V ring, and each head's
warps meet their own barrier once per key tile. ``fold_fwd`` is P1: K2 on
q3 [BH, Tq, D] and k3/v3 [BH, Tk_p, D] with keys at or past ``kv_len``
masked (no GQA, no causal mask), returning O in q's dtype and lse [BH, Tq,
1] float32, on the body ``ops/attention.py:FWD_BODIES`` gives (fold, tile,
dtype) -- the tensor-core body of the dtype at every fold, fold 1
included at the arms' tiles. Its plain version is K2's plain math on the
first ``kv_len`` keys of every head. The CUDA-core body
(``csrc/flash_fwd.cu``) keeps its folds for an A/B only
(``fold_fwd_cuda(..., body="cuda_core")``).

``main`` times four kernel arms at bf16 [96, 1536, 64] (Whisper-small's
encoder, B = 8 x 12 heads), all on the wgmma body, so the A/B is the
fold's alone: fold 1 at the 64 x 64 tile ("base_bq64", the reference of
``speedup_vs_default``), fold 1 with 128 query rows per block
("base_bq128"), and folding 2 and 4 heads at the 64 x 64 tile
("fold2_bq64", "fold4_bq64"). fold2_bq64 and base_bq128 each take 128
query rows per block, of two heads or of one. Then the product A/B: the
real ``flash_attention`` at [8, 12, 1500, 64] with ``fold=2`` and
``fold=1`` (JAX: ``AUDAX_ATTN_FOLD``), each on the body the product gives
it: in bf16 both on the wgmma body, fold 2 at the 64 x 64 tile against
fold 1 at ``WGMMA_TILE`` (64 x 128). Each arm is slope-timed over eager calls
between CUDA events (``utils/profiling.py:slope_timed_eager``, 5 and 25
calls, best of 2). Verdict: ``keep`` when the product call folded is at
least 1.05x faster, as in JAX.

    python -m audax_torch.tools.attn_headfold_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops import attention as att
from audax_torch.tools import cli, report
from audax_torch.utils.profiling import slope_timed_eager

__all__ = ["fold_fwd", "fold_fwd_cuda", "fold_fwd_plain", "main"]

#: (arm, fold, block_q) of the kernel arms; block_k 64 throughout
ARMS = (("base_bq64", 1, 64), ("base_bq128", 1, 128), ("fold2_bq64", 2, 64),
        ("fold4_bq64", 4, 64))
BLOCK_K = 64
#: the product call keeps folding when it wins by this much (JAX's rule)
KEEP_SPEEDUP = 1.05
#: slope lengths and repeats on the card; a short rehearsal on the CPU
_CUDA_TIMING = ((5, 25), 2)
_CPU_TIMING = ((1, 4), 2)


def _check_3d(who, q3, k3, v3):
    if (q3.dim() != 3 or k3.shape != v3.shape or k3.dim() != 3
            or k3.shape[0] != q3.shape[0] or k3.shape[2] != q3.shape[2]):
        raise ValueError(f"{who}: q3 [BH, Tq, D] and k3 = v3 [BH, Tk_p, D] "
                         f"expected, got {tuple(q3.shape)}, "
                         f"{tuple(k3.shape)}, {tuple(v3.shape)}")


def fold_fwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, *,
                   scale: float, kv_len: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """P1's arithmetic in PyTorch: K2's plain math (softmax in float32,
    probabilities in q's dtype before PV) on the first ``kv_len`` keys of
    each head, whatever the fold. Returns (o [BH, Tq, D], lse [BH, Tq, 1]
    float32)."""
    _check_3d("fold_fwd_plain", q3, k3, v3)
    fold_fwd_plain.launches += 1
    o, lse = att._forward_math(q3[None], k3[None, :, :kv_len],
                               v3[None, :, :kv_len], False, float(scale))
    return o[0], lse.reshape(*q3.shape[:2], 1)


fold_fwd_plain.launches = 0


def fold_fwd_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, *,
                  scale: float, kv_len: int, fold: int,
                  block_q: Optional[int] = None,
                  block_k: Optional[int] = None,
                  body: Optional[str] = None):
    """P1: K2 folding ``fold`` heads per block on the body ``FWD_BODIES``
    gives (``fold`` 1 is K2 unfolded), counted by that body's launcher as
    well; ``body="cuda_core"`` forces K2's CUDA-core body for an A/B. Same
    contract as ``fold_fwd_plain``."""
    _check_3d("fold_fwd", q3, k3, v3)
    o, lse = att.launch_flash_forward(
        q3[None], k3[None], v3[None], scale=scale, block_q=block_q,
        block_k=block_k, fold=fold, kv_len=kv_len, name="fold_fwd",
        body=body)
    fold_fwd_cuda.launches += 1
    return o[0], lse.reshape(*q3.shape[:2], 1)


fold_fwd_cuda.launches = 0


def fold_fwd(q3, k3, v3, *, scale, kv_len, fold, block_q=None, block_k=None):
    """(o [BH, Tq, D], lse [BH, Tq, 1]): P1 for CUDA tensors, its plain
    version for CPU tensors; the fold and tiles are checked first, on
    either device."""
    att.resolve_tile("fwd", q3.shape[-1], block_q, block_k, fold,
                     dtype=q3.dtype)
    if not q3.is_cuda:
        return fold_fwd_plain(q3, k3, v3, scale=scale, kv_len=kv_len)
    return fold_fwd_cuda(q3, k3, v3, scale=scale, kv_len=kv_len, fold=fold,
                         block_q=block_q, block_k=block_k)


def main(device=None, out=None) -> dict:
    """The four kernel arms at bf16 [96, 1536, 64] and the product A/B at
    [8, 12, 1500, 64] (CPU: [8, 64, 64] and [2, 4, 60, 64])."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    bh, t, d = (96, 1536, 64) if cuda else (8, 64, 64)
    pshape = (8, 12, 1500, 64) if cuda else (2, 4, 60, 64)
    iters, repeats = _CUDA_TIMING if cuda else _CPU_TIMING
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    flops = 4 * bh * t * t * d

    def timed(fn):
        return slope_timed_eager(fn, iters=iters, repeats=repeats,
                                 device=dev if cuda else None)

    rows, t_ref, o_base = [], None, None
    for arm, fold, bq in ARMS:
        def fn(fold=fold, bq=bq):
            return fold_fwd(q, k, v, scale=scale, kv_len=t, fold=fold,
                            block_q=bq, block_k=BLOCK_K)[0]
        o = fn().float()
        o_base = o if o_base is None else o_base
        err = float((o - o_base).abs().max())
        if not err <= 2e-2 * float(o_base.abs().max()):
            raise AssertionError(f"{arm} differs from base by {err}")
        sec = timed(fn)
        t_ref = sec if t_ref is None else t_ref
        rows.append({"arm": arm, "fold": fold, "block_q": bq,
                     "block_k": BLOCK_K, "us": 1e6 * sec,
                     "tflops": flops / sec / 1e12,
                     "max_abs_err_vs_base": err,
                     "speedup_vs_default": t_ref / sec})

    # product-level A/B: the real flash_attention call, fold 2 then 1
    prng = np.random.default_rng(1)
    qp, kp, vp = (torch.from_numpy(prng.standard_normal(pshape).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    b_, h_, s_, d_ = pshape
    pflops = 4 * b_ * h_ * s_ * s_ * d_
    prod = {}
    for fold in (2, 1):
        sec = timed(lambda fold=fold: att.flash_attention(qp, kp, vp,
                                                          fold=fold))
        prod[fold] = sec
        rows.append({"arm": f"product_fold{fold}", "fold": fold,
                     "us": 1e6 * sec, "tflops": pflops / sec / 1e12})
    best = max(r["speedup_vs_default"] for r in rows
               if r["arm"].startswith("fold"))
    win = prod[1] / prod[2]
    return report("attn_headfold_probe", dev, rows,
                  "keep" if win >= KEEP_SPEEDUP else "reject", out,
                  shape=[bh, t, d], product_shape=list(pshape),
                  block_k=BLOCK_K, best_speedup=best,
                  product_speedup_fold2=win,
                  timing="eager calls between CUDA events, slope of "
                         f"{iters[0]} and {iters[1]} calls, best of "
                         f"{repeats}" if cuda else "host clock (CPU)")


if __name__ == "__main__":
    cli(main)
