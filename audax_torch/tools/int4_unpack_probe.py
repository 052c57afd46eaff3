"""Two ways to unpack K9's int4 nibbles, against kernel K9: port of
``tools/int4_unpack_probe.py``.

Both variants compute K9's function over K9's split-half layout
(``ops/int4_matmul.py``):

  v1  K9's function, layout and per-group partials, the nibbles unpacked
      by mask and shift with no widen. Two bodies, one table,
      ``V1_BODIES``: the tensor-core body on K9's skeleton
      (``csrc/int4_matmul_mma.cu``, library ``int4_unpack_v1_mma``: K9 with
      each bf16 pair made by one mask and magic, no byte permute) wherever
      it takes the call -- K9's rule: a group of whole 16-row products, K/2
      <= 8192 -- and the first body (``csrc/int4_unpack_variants.cu``, K9's
      split-half template, each nibble written under the exponent of 2^23
      less 2^23 + 8 on the CUDA cores) for the rest.
  v2  dequantize the weights in x's dtype (``(nib - 8)`` and ``s`` cast to
      x's dtype, the product rounded there: the JAX body's rounding), then
      one contraction over the whole K with float32 sums. Two bodies, one
      table, ``V2_BODIES``: the tensor-core body on K9's skeleton
      (``csrc/int4_matmul_mma.cu``, library ``int4_unpack_v2_mma``; bf16 x
      on bf16 ``mma.sync``, float32 x in 3xTF32) wherever it takes the
      call -- K9's rule: a group of whole 16-row products, K/2 <= 8192 --
      and the first body (``int4_unpack_variants.cu``, 64 columns a block)
      for the rest.

``run_variant(variant, x, packed, scales, block_n=)`` launches the body
its table gives on a CUDA tensor and takes its plain version on a CPU
tensor. ``block_n`` is the tensor-core body's columns per block, the
counterpart of the JAX tool's ``block_n`` sweep: 64, 128 or 256 (64 nt: nt
A tiles a warp; by default the plan's ``pick_nt``) -- ``BLOCK_N``. The
first bodies take no ``block_n``: v1's owns 256 columns a block, v2's 64.

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

__all__ = ["BLOCK_N", "V1_BODIES", "V2_BODIES",
           "v1_body", "v2_body", "run_variant", "unpack_v1_plain",
           "unpack_v1_cuda", "unpack_v1_mma_cuda", "unpack_v2_plain",
           "unpack_v2_cuda", "unpack_v2_mma_cuda", "main"]

#: columns per block the tensor-core bodies take (64 nt; None: the plan's
#: pick_nt)
BLOCK_N = {"v1": (64, 128, 256), "v2": (64, 128, 256)}


def _mma_takes(kh: int, group: int) -> bool:
    """The source's ``int4mma::takes`` (K9's rule) at K/2 = ``kh``."""
    return group % 16 == 0 and kh <= 16 * 512


#: each variant's bodies on a CUDA tensor, in the order ``v1_body`` /
#: ``v2_body`` try them: name -> (the counter of its launches in
#: ``tools.probe_kernels``, whether it takes a call's (K/2, group)). The
#: tensor-core bodies take K9's calls; the first bodies every call.
V1_BODIES = {
    "mma": ("int4_unpack_v1_mma", _mma_takes),
    "split_half": ("int4_unpack_v1", lambda kh, group: True),
}
V2_BODIES = {
    "mma": ("int4_unpack_v2_mma", _mma_takes),
    "blocked": ("int4_unpack_v2", lambda kh, group: True),
}


def _body(bodies, k_dim, group):
    return next(name for name, (_, takes) in bodies.items()
                if takes(k_dim // 2, group))


def v1_body(k_dim: int, group: int) -> str:
    """The v1 body ``V1_BODIES`` gives a [.., K] x [K/2, N] call at
    ``group``."""
    return _body(V1_BODIES, k_dim, group)


def v2_body(k_dim: int, group: int) -> str:
    """The v2 body ``V2_BODIES`` gives a [.., K] x [K/2, N] call at
    ``group``."""
    return _body(V2_BODIES, k_dim, group)


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
    if variant == "v1":                  # the first body
        lib = native.library("int4_unpack_variants")
        splits = lib.int4_unpack_v1_splits(m, k_dim // 2, n)
        ws = (torch.empty(splits * m * n, device=x.device,
                          dtype=torch.float32) if splits > 1 else y)
        status = lib.int4_unpack_v1(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), ws.data_ptr(), m, k_dim, n, group, splits,
            dtype, stream)
    elif variant == "v2":
        status = native.library("int4_unpack_variants").int4_unpack_v2(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), m, k_dim, n, group, dtype, stream)
    else:                                # "v1_mma", "v2_mma"
        if not _mma_takes(k_dim // 2, group):
            raise ValueError(f"{who}: no tensor-core body at K={k_dim}, "
                             f"group {group}")
        nt = 0 if block_n is None else block_n // 64
        if nt and k_dim // 2 > 16 * 512 // nt:
            raise ValueError(f"{who}: block_n {block_n} takes K/2 up to "
                             f"{16 * 512 // nt}, got {k_dim // 2}")
        if x2.data_ptr() % (2 * x2.element_size()):  # it loads pairs of x
            x2 = x2.clone()
        name = f"int4_unpack_{variant}"
        status = getattr(native.library(name), name)(
            x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            y.data_ptr(), m, k_dim, n, group, nt, dtype, stream)
    native.check(status, who)
    return y.reshape(*x.shape[:-1], n)


def _block_n(variant, block_n):
    if block_n is not None and block_n not in BLOCK_N[variant]:
        raise ValueError(f"{variant}: block_n {block_n} not in "
                         f"{BLOCK_N[variant]}")
    return block_n


def unpack_v1_cuda(x, packed, scales):
    """Variant 1's first body (``csrc/int4_unpack_variants.cu``, 256
    columns a block) on CUDA tensors, at any group."""
    y = _launch("unpack_v1_cuda", "v1", x, packed, scales, None)
    unpack_v1_cuda.launches += 1
    return y


unpack_v1_cuda.launches = 0


def unpack_v1_mma_cuda(x, packed, scales, *, block_n=None):
    """Variant 1's tensor-core body (``csrc/int4_matmul_mma.cu``,
    ``ROUTE_V1``), one counted launch, at a (K/2, group) that
    ``V1_BODIES`` gives it (raises ``ValueError`` otherwise); ``block_n``
    one of ``BLOCK_N["v1"]`` or None for the plan's pick_nt."""
    y = _launch("unpack_v1_mma_cuda", "v1_mma", x, packed, scales,
                _block_n("v1", block_n))
    unpack_v1_mma_cuda.launches += 1
    return y


unpack_v1_mma_cuda.launches = 0


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
    for a CUDA tensor the body its table (``V1_BODIES``, ``V2_BODIES``)
    gives -- the tensor-core body at ``block_n`` columns per block (one of
    ``BLOCK_N[variant]``; None: the plan's pick_nt), or the first body,
    which takes no ``block_n`` here -- for a CPU tensor its plain
    version."""
    if variant not in BLOCK_N:
        raise ValueError(f"unknown variant {variant!r}: 'v1' or 'v2'")
    block_n = _block_n(variant, block_n)
    v1 = variant == "v1"
    if not x.is_cuda:
        return (unpack_v1_plain if v1 else unpack_v2_plain)(x, packed,
                                                            scales)
    k_dim = x.shape[-1]
    group = k_dim // max(scales.shape[-2], 1)
    if (v1_body if v1 else v2_body)(k_dim, group) == "mma":
        return (unpack_v1_mma_cuda if v1 else unpack_v2_mma_cuda)(
            x, packed, scales, block_n=block_n)
    if block_n is not None:
        raise ValueError(f"{variant}: block_n {block_n} is the tensor-core "
                         f"body's; K={k_dim}, group {group} takes the first "
                         "body")
    if v1:
        return unpack_v1_cuda(x, packed, scales)
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
    arms += [(f"{v} {'mask-shift' if v == 'v1' else 'one-dot'} block_n={bn}",
              bn,
              functools.partial(run_variant, v, block_n=bn))
             for v in BLOCK_N for bn in BLOCK_N[v]]
    nbytes = packed.numel() + 4 * sc.numel()
    rows, t = [], {}
    for arm, bn, fn in arms:
        t[arm], warm = arm_times(fn, xbf, (packed, sc))
        rows.append(arm_row(arm, (m, k_dim, n), t[arm], warm, nbytes,
                            block_n=bn))
    best = min(v for a, v in t.items() if a != "v0 current")
    group = k_dim // sc.shape[0]
    bodies = ({f"{v}_body": tab[body(k_dim, group)][0]
               for v, tab, body in (("v1", V1_BODIES, v1_body),
                                    ("v2", V2_BODIES, v2_body))}
              if dev.type == "cuda" else
              {"v1_body": "unpack_v1_plain", "v2_body": "unpack_v2_plain"})
    return report("int4_unpack_probe", dev, rows,
                  rule(best, t["v0 current"]), out, nrmse=nrmse,
                  current=current_arm(dev, k_dim), **bodies)


if __name__ == "__main__":
    cli(main)
