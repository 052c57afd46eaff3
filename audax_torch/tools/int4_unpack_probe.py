"""Two ways to unpack K9's int4 nibbles, against kernel K9: port of
``tools/int4_unpack_probe.py``.

Both variants compute K9's function over K9's split-half layout
(``ops/int4_matmul.py``) and live in ``csrc/int4_unpack_variants.cu``:

  v1  K9's kernel with the integer-to-float conversion of each nibble
      replaced by bit operations: the nibble written under the exponent of
      2^23, then one subtraction of 2^23 + 8 (exact). Per-group partials,
      as K9.
  v2  dequantize a tile of weights in x's dtype (``(nib - 8)`` and ``s``
      cast to x's dtype, the product rounded there: the JAX body's
      rounding), then one contraction over the whole K with float32 sums;
      bf16 x on the tensor cores (``mma.sync``), float32 x on CUDA cores.

``run_variant(variant, x, packed, scales, block_n=)`` launches one of them
on a CUDA tensor and takes its plain version on a CPU tensor. ``block_n``
is the kernel's columns per block, the counterpart of the JAX tool's
``block_n`` sweep: v1 takes 128, 256 or 512 (32, 64 or 128 threads of four
columns), v2 32, 64 or 128 (one warp per 8 columns) -- ``BLOCK_N``.

``main`` checks both against ``x @ dequantize_int4`` (NRMSE) and times K9
("v0 current") and every variant at every ``block_n``, bf16 x, with the
weights from device memory and warm in L2. Verdict: ``keep`` when the best
variant beats K9 by ``tools.KEEP_RATIO``.

    python -m audax_torch.tools.int4_unpack_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops import int4_matmul as i4
from audax_torch.ops import native
from audax_torch.tools import (arm_row, arm_times, cli, current_arm,
                               kernel_operands, report, split_half_shape)
from audax_torch.tools import verdict as rule

__all__ = ["BLOCK_N", "DEFAULT_BLOCK_N", "run_variant", "unpack_v1_plain",
           "unpack_v1_cuda", "unpack_v2_plain", "unpack_v2_cuda", "main"]

#: columns per block each variant's kernel takes, and its default
BLOCK_N = {"v1": (128, 256, 512), "v2": (32, 64, 128)}
DEFAULT_BLOCK_N = {"v1": 256, "v2": 64}


def unpack_v1_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """K9's function: dequantize in float32, a float32 product."""
    unpack_v1_plain.launches += 1
    return (x.float() @ i4.dequantize_int4(packed, scales)).to(x.dtype)


unpack_v1_plain.launches = 0


def unpack_v2_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """Dequantize in x's dtype (each product rounded there), then one
    product with float32 sums."""
    unpack_v2_plain.launches += 1
    w = i4.dequantize_int4(packed, scales, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


unpack_v2_plain.launches = 0


def _launch(who, variant, x, packed, scales, block_n):
    dtype = kernel_operands(who, x, packed, scales, torch.uint8)
    if block_n not in BLOCK_N[variant]:
        raise ValueError(f"{who}: block_n {block_n} not in "
                         f"{BLOCK_N[variant]}")
    k_dim, n, group = split_half_shape(who, x, packed, scales)
    x2 = x.reshape(-1, k_dim).contiguous()
    m = x2.shape[0]
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    lib = native.library("int4_unpack_variants")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if variant == "v1":
        splits = lib.int4_unpack_v1_splits(m, k_dim // 2, n, block_n)
        ws = (torch.empty(splits * m * n, device=x.device,
                          dtype=torch.float32) if splits > 1 else y)
        status = lib.int4_unpack_v1(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), ws.data_ptr(), m, k_dim, n, group, splits,
            block_n, dtype, stream)
    else:
        status = lib.int4_unpack_v2(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), m, k_dim, n, group, block_n, dtype, stream)
    native.check(status, who)
    return y.reshape(*x.shape[:-1], n)


def unpack_v1_cuda(x, packed, scales, *, block_n=DEFAULT_BLOCK_N["v1"]):
    """Variant 1's kernel on CUDA tensors."""
    y = _launch("unpack_v1_cuda", "v1", x, packed, scales, block_n)
    unpack_v1_cuda.launches += 1
    return y


unpack_v1_cuda.launches = 0


def unpack_v2_cuda(x, packed, scales, *, block_n=DEFAULT_BLOCK_N["v2"]):
    """Variant 2's kernel on CUDA tensors."""
    y = _launch("unpack_v2_cuda", "v2", x, packed, scales, block_n)
    unpack_v2_cuda.launches += 1
    return y


unpack_v2_cuda.launches = 0


def run_variant(variant: str, x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, *, block_n=None) -> torch.Tensor:
    """x [..., K] @ K9-packed int4 through variant ``"v1"`` or ``"v2"``:
    its kernel for a CUDA tensor (at ``block_n`` columns per block, one of
    ``BLOCK_N[variant]``, by default ``DEFAULT_BLOCK_N[variant]``), its
    plain version for a CPU tensor."""
    if variant not in BLOCK_N:
        raise ValueError(f"unknown variant {variant!r}: 'v1' or 'v2'")
    block_n = DEFAULT_BLOCK_N[variant] if block_n is None else block_n
    if block_n not in BLOCK_N[variant]:
        raise ValueError(f"{variant}: block_n {block_n} not in "
                         f"{BLOCK_N[variant]}")
    if variant == "v1":
        if x.is_cuda:
            return unpack_v1_cuda(x, packed, scales, block_n=block_n)
        return unpack_v1_plain(x, packed, scales)
    if x.is_cuda:
        return unpack_v2_cuda(x, packed, scales, block_n=block_n)
    return unpack_v2_plain(x, packed, scales)


def main(device=None, out=None) -> dict:
    """The unpack variants vs K9 at [8, 1280] x [1280, 5120] (CPU: [8, 256]
    x [256, 512]), bf16 x, over each variant's columns per block."""
    dev = resolve_device(device)
    m, k_dim, n = (8, 1280, 5120) if dev.type == "cuda" else (8, 256, 512)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((k_dim, n)).astype(np.float32)
                         ).to(dev)
    xbf = torch.from_numpy(rng.standard_normal((m, k_dim))
                           .astype(np.float32)).to(dev).bfloat16()
    packed, sc = i4.quantize_int4(w)
    ref = xbf.float() @ i4.dequantize_int4(packed, sc)
    nrmse = {}
    for variant in BLOCK_N:
        got = run_variant(variant, xbf, packed, sc).float()
        nrmse[variant] = float(((got - ref) ** 2).mean().sqrt() / ref.std())
        if not nrmse[variant] < 2e-2:
            raise AssertionError(f"{variant}: NRMSE {nrmse[variant]} vs the "
                                 "exact dequantized product")

    arms = [("v0 current", None, i4.int4_matmul)]
    arms += [(f"{v} {'bitcast' if v == 'v1' else 'one-dot'} block_n={bn}", bn,
              functools.partial(run_variant, v, block_n=bn))
             for v in BLOCK_N for bn in BLOCK_N[v]]
    nbytes = packed.numel() + 4 * sc.numel()
    rows, t = [], {}
    for arm, bn, fn in arms:
        t[arm], warm = arm_times(fn, xbf, (packed, sc))
        rows.append(arm_row(arm, (m, k_dim, n), t[arm], warm, nbytes,
                            block_n=bn))
    best = min(v for a, v in t.items() if a != "v0 current")
    return report("int4_unpack_probe", dev, rows,
                  rule(best, t["v0 current"]), out, nrmse=nrmse,
                  current=current_arm(dev, k_dim))


if __name__ == "__main__":
    cli(main)
