"""Two ways to unpack K9's int4 nibbles, against kernel K9: port of
``tools/int4_unpack_probe.py``.

Both variants compute K9's function over K9's split-half layout
(``ops/int4_matmul.py``):

  v1  K9's kernel with the integer-to-float conversion of each nibble
      replaced by bit operations: the nibble written under the exponent of
      2^23, then one subtraction of 2^23 + 8 (exact). Per-group partials,
      as K9 (``csrc/int4_unpack_variants.cu``).
  v2  dequantize the weights in x's dtype (``(nib - 8)`` and ``s`` cast to
      x's dtype, the product rounded there: the JAX body's rounding), then
      one contraction over the whole K with float32 sums. Two bodies, one
      table, ``V2_BODIES``: the tensor-core body on K9's skeleton
      (``csrc/int4_matmul_mma.cu``, library ``int4_unpack_v2_mma``; bf16 x
      on bf16 ``mma.sync``, float32 x in 3xTF32) wherever it takes the
      call -- K9's rule: a group of whole 16-row products, K/2 <= 8192 --
      and the first body (``int4_unpack_variants.cu``, 64 columns a block)
      for the rest.

``run_variant(variant, x, packed, scales, block_n=)`` launches one of them
on a CUDA tensor and takes its plain version on a CPU tensor. ``block_n``
is the kernel's columns per block, the counterpart of the JAX tool's
``block_n`` sweep: v1 takes 128, 256 or 512 (32, 64 or 128 threads of four
columns), v2 64, 128 or 256 (64 nt columns: nt A tiles a warp of the
tensor-core body; by default the plan's ``pick_nt``) -- ``BLOCK_N``.

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

__all__ = ["BLOCK_N", "DEFAULT_BLOCK_N", "V2_BODIES", "v2_body",
           "run_variant", "unpack_v1_plain", "unpack_v1_cuda",
           "unpack_v2_plain", "unpack_v2_cuda", "unpack_v2_mma_cuda", "main"]

#: columns per block each variant's kernel takes, and its default (v2: the
#: tensor-core body's 64 nt, by default the plan's pick_nt)
BLOCK_N = {"v1": (128, 256, 512), "v2": (64, 128, 256)}
DEFAULT_BLOCK_N = {"v1": 256, "v2": None}

#: v2's bodies on a CUDA tensor, in the order ``v2_body`` tries them: name ->
#: (the counter of its launches in ``tools.probe_kernels``, whether it takes
#: a call's (K/2, group)). The tensor-core body's rule is the source's
#: ``int4mma::takes`` (K9's); the first body takes every call.
V2_BODIES = {
    "mma": ("int4_unpack_v2_mma",
            lambda kh, group: group % 16 == 0 and kh <= 16 * 512),
    "blocked": ("int4_unpack_v2", lambda kh, group: True),
}


def v2_body(k_dim: int, group: int) -> str:
    """The v2 body ``V2_BODIES`` gives a [.., K] x [K/2, N] call at
    ``group``."""
    return next(name for name, (_, takes) in V2_BODIES.items()
                if takes(k_dim // 2, group))


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
    k_dim, n, group = split_half_shape(who, x, packed, scales)
    x2 = x.reshape(-1, k_dim).contiguous()
    m = x2.shape[0]
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if variant == "v1":
        lib = native.library("int4_unpack_variants")
        splits = lib.int4_unpack_v1_splits(m, k_dim // 2, n, block_n)
        ws = (torch.empty(splits * m * n, device=x.device,
                          dtype=torch.float32) if splits > 1 else y)
        status = lib.int4_unpack_v1(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), ws.data_ptr(), m, k_dim, n, group, splits,
            block_n, dtype, stream)
    elif variant == "v2":
        status = native.library("int4_unpack_variants").int4_unpack_v2(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), m, k_dim, n, group, dtype, stream)
    else:
        if v2_body(k_dim, group) != "mma":
            raise ValueError(f"{who}: no tensor-core body at K={k_dim}, "
                             f"group {group}")
        nt = 0 if block_n is None else block_n // 64
        if nt and k_dim // 2 > 16 * 512 // nt:
            raise ValueError(f"{who}: block_n {block_n} takes K/2 up to "
                             f"{16 * 512 // nt}, got {k_dim // 2}")
        if x2.data_ptr() % (2 * x2.element_size()):  # it loads pairs of x
            x2 = x2.clone()
        status = native.library("int4_unpack_v2_mma").int4_unpack_v2_mma(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), m, k_dim, n, group, nt, dtype, stream)
    native.check(status, who)
    return y.reshape(*x.shape[:-1], n)


def _block_n(variant, block_n):
    if block_n is not None and block_n not in BLOCK_N[variant]:
        raise ValueError(f"{variant}: block_n {block_n} not in "
                         f"{BLOCK_N[variant]}")
    return block_n


def unpack_v1_cuda(x, packed, scales, *, block_n=DEFAULT_BLOCK_N["v1"]):
    """Variant 1's kernel on CUDA tensors."""
    y = _launch("unpack_v1_cuda", "v1", x, packed, scales,
                _block_n("v1", block_n))
    unpack_v1_cuda.launches += 1
    return y


unpack_v1_cuda.launches = 0


def unpack_v2_cuda(x, packed, scales):
    """Variant 2's first body (``csrc/int4_unpack_variants.cu``, 64 columns
    a block) on CUDA tensors, at any group."""
    y = _launch("unpack_v2_cuda", "v2", x, packed, scales, None)
    unpack_v2_cuda.launches += 1
    return y


unpack_v2_cuda.launches = 0


def unpack_v2_mma_cuda(x, packed, scales, *, block_n=None):
    """Variant 2's tensor-core body (``csrc/int4_matmul_mma.cu``,
    ``ROUTE_V2``), one counted launch, at a (K/2, group) that
    ``V2_BODIES`` gives it (raises ``ValueError`` otherwise); ``block_n``
    one of ``BLOCK_N["v2"]`` or None for the plan's pick_nt."""
    y = _launch("unpack_v2_mma_cuda", "v2_mma", x, packed, scales,
                _block_n("v2", block_n))
    unpack_v2_mma_cuda.launches += 1
    return y


unpack_v2_mma_cuda.launches = 0


def run_variant(variant: str, x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, *, block_n=None) -> torch.Tensor:
    """x [..., K] @ K9-packed int4 through variant ``"v1"`` or ``"v2"``:
    its kernel for a CUDA tensor (at ``block_n`` columns per block, one of
    ``BLOCK_N[variant]``, by default ``DEFAULT_BLOCK_N[variant]``; v2 on
    the body ``V2_BODIES`` gives, where the first body takes no
    ``block_n``), its plain version for a CPU tensor."""
    if variant not in BLOCK_N:
        raise ValueError(f"unknown variant {variant!r}: 'v1' or 'v2'")
    block_n = _block_n(variant, block_n)
    if variant == "v1":
        if x.is_cuda:
            return unpack_v1_cuda(x, packed, scales,
                                  block_n=block_n or DEFAULT_BLOCK_N["v1"])
        return unpack_v1_plain(x, packed, scales)
    if not x.is_cuda:
        return unpack_v2_plain(x, packed, scales)
    k_dim = x.shape[-1]
    group = k_dim // max(scales.shape[-2], 1)
    if v2_body(k_dim, group) == "mma":
        return unpack_v2_mma_cuda(x, packed, scales, block_n=block_n)
    if block_n is not None:
        raise ValueError(f"v2: block_n {block_n} is the tensor-core body's; "
                         f"K={k_dim}, group {group} takes the first body "
                         "(64 columns a block)")
    return unpack_v2_cuda(x, packed, scales)


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
    v2 = (V2_BODIES[v2_body(k_dim, k_dim // sc.shape[0])][0]
          if dev.type == "cuda" else "unpack_v2_plain")
    return report("int4_unpack_probe", dev, rows,
                  rule(best, t["v0 current"]), out, nrmse=nrmse,
                  current=current_arm(dev, k_dim), v2_body=v2)


if __name__ == "__main__":
    cli(main)
