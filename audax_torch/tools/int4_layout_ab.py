"""Int4 matmul over int32 words of eight nibbles (split-eighth layout)
against kernel K9's uint8 split-half layout: port of
``tools/int4_layout_ab.py`` and ``tools/int4_layout_ab_bench.py``.

Layout (``K`` = contraction dim, ``N`` = output dim):

  words   int32 [K//8, N]   nibble i (bits 4i..4i+3) of word (c, n) holds
                            K-row i*K/8 + c, stored as q + 8, q in [-7, 7]
  scales  f32   [G, N]      G = K // group; ``quantize_int4_v2`` halves
                            the group (128 by default) until it divides
                            the plane length K/8 (32 at K = 1280)

``int4_matmul_v2`` dispatches on the tensor it is given: a CPU tensor
takes ``int4_matmul_v2_plain`` (dequantize, a float32 product); a CUDA
tensor launches the body the table ``WORD_BODIES`` gives. Both bodies
compute P2 and P3 (``int4_plane_probe``: the same function at a group that
may straddle planes), and the table is shared with that tool:

  * the tensor-core body on K9's skeleton (``csrc/int4_matmul_mma.cu``,
    library ``int4_word_matmul_mma``): a warp's columns of each word row
    copied whole by 16-byte ``cp.async``, each word read once for all its
    eight planes, one bf16 ``mma.sync`` a plane (float32 x in three bf16
    parts), every plane's partial scaled by its own group, the K splits
    one thread block cluster -- wherever it takes the call: groups and
    the plane K/8 whole k16 steps, K/8 <= 4096;
  * the first body (``csrc/int4_word_matmul.cu``: a word per thread and
    row, float32 FMAs, splits summed by a second launch) for the rest.

``launch_word_matmul`` and ``launch_word_mma`` are the launches
themselves, shared with ``int4_plane_probe``; each caller counts its own.

The question on this card: do native words of 8 K-rows beat K9's 4 columns
x 2 rows per 32-bit load? ``bench`` times K9 ("v1-u8": on the card its
tensor-core body, ``csrc/int4_matmul_mma.cu``, which the report's
``current`` names), ``int4_matmul_v2`` ("v2-i32", on the body its table
gives; the report's ``word_body``) and a bf16 ``torch.matmul`` at
the decode shapes of Whisper-large-v3 ([8, 1280] x [1280, 5120], [8, 5120]
x [5120, 1280], [8, 1280] x [1280, 1280]), each with its weights from
device memory and warm in L2; its bytes count the finer scales of this
layout. Verdict: ``keep`` when v2 beats K9 by the common margin
(``tools.KEEP_RATIO``) at every shape.

    python -m audax_torch.tools.int4_layout_ab check   # numerics
    python -m audax_torch.tools.int4_layout_ab bench [--out PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops import int4_matmul as i4
from audax_torch.ops import native
from audax_torch.tools import (arm_row, arm_times, cli, current_arm,
                               kernel_operands, report)
from audax_torch.tools import verdict as rule

__all__ = ["fit_group_v2", "quantize_words", "quantize_int4_v2",
           "dequantize_int4_v2", "WORD_BODIES", "word_body",
           "int4_matmul_v2", "int4_matmul_v2_plain", "int4_matmul_v2_cuda",
           "int4_matmul_v2_mma_cuda", "launch_word_matmul",
           "launch_word_mma", "check", "bench", "main"]

#: the bench's shapes (M, K, N) on the card and, for a CPU rehearsal, small
BENCH_SHAPES = ((8, 1280, 5120), (8, 5120, 1280), (8, 1280, 1280))
CPU_BENCH_SHAPES = ((8, 256, 512), (8, 512, 256), (8, 256, 256))


def _word_mma_takes(kw: int, group: int) -> bool:
    """The source's ``int4mma::takes_word`` at K/8 = ``kw`` word rows."""
    return (group % 16 == 0 and kw % 16 == 0 and 8 * kw % group == 0
            and kw <= 16 * 256)


#: the word kernel's bodies on a CUDA tensor, in the order ``word_body``
#: tries them: name -> (the counter of P2's launches in
#: ``tools.probe_kernels``, whether it takes a call's (K/8, group)).
#: ``int4_plane_probe.PLANE_BODIES`` takes the same rules with P3's
#: counters. The tensor-core body's rule is the source's
#: ``int4mma::takes_word``; the first body takes every group dividing K.
WORD_BODIES = {
    "mma": ("int4_word_matmul_mma", _word_mma_takes),
    "cuda_core": ("int4_word_matmul", lambda kw, group: True),
}


def word_body(k_dim: int, group: int) -> str:
    """The body ``WORD_BODIES`` gives a [.., K] x words [K/8, N] call at
    ``group``."""
    return next(name for name, (_, takes) in WORD_BODIES.items()
                if takes(k_dim // 8, group))


def fit_group_v2(k_dim: int, group=None) -> int:
    """The group (128 by default) halved until it divides the plane K/8."""
    if k_dim % 8:
        raise ValueError(f"word packing needs K % 8 == 0, got {k_dim}")
    slab = k_dim // 8
    g = min(group or 128, slab)
    while slab % g:
        g //= 2
    return g


def quantize_words(w: torch.Tensor, group: int):
    """w [K, N] -> (words int32 [K//8, N], scales float32 [K//group, N]) at
    exactly ``group``, round-to-nearest with the JAX tools' arithmetic."""
    w = w.float().contiguous()
    k_dim, n = w.shape
    if k_dim % 8 or k_dim % group:
        raise ValueError(f"K = {k_dim} must be a multiple of 8 and of the "
                         f"group {group}")
    grouped = w.reshape(k_dim // group, group, n)
    s = torch.clamp_min(grouped.abs().amax(dim=1) / 7.0, 1e-12)
    q = torch.clamp(torch.round(grouped / s[:, None, :]), -7, 7)
    q = (q.reshape(k_dim, n) + 8).to(torch.int32)        # [K, N] in [1, 15]
    slab = k_dim // 8
    word = torch.zeros(slab, n, dtype=torch.int32, device=w.device)
    for i in range(8):
        word |= q[i * slab:(i + 1) * slab] << (4 * i)
    return word, s


def quantize_int4_v2(w: torch.Tensor, *, group=None):
    """w [K, N] -> (words int32 [K//8, N], scales float32 [G, N]); the group
    divides K/8, so no group straddles a plane."""
    return quantize_words(w, fit_group_v2(w.shape[0], group))


def dequantize_int4_v2(word: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of the word packing -> [K, N] in ``dtype``, for any group
    that divides K (``int4_plane_probe``'s straddling groups too)."""
    slab = word.shape[0]
    g = 8 * slab // scales.shape[0]
    q = torch.cat([((word >> (4 * i)) & 0xF) - 8 for i in range(8)])
    return q.to(dtype) * torch.repeat_interleave(scales.to(dtype), g, dim=0)


def int4_matmul_v2_plain(x: torch.Tensor, word: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(words, scales)`` in float32, cast to x's dtype."""
    int4_matmul_v2_plain.launches += 1
    return (x.float() @ dequantize_int4_v2(word, scales)).to(x.dtype)


int4_matmul_v2_plain.launches = 0


def _word_operands(who, x, word, scales, group):
    """(dtype code, x as [M, K] contiguous, an empty y [M, N]) of a word
    kernel's call; raises on operands it does not take."""
    dtype = kernel_operands(who, x, word, scales, torch.int32)
    plane, n = word.shape
    k_dim = 8 * plane
    if (x.shape[-1] != k_dim or group < 1 or k_dim % group
            or tuple(scales.shape) != (k_dim // group, n)):
        raise ValueError(f"{who}: x {tuple(x.shape)}, words "
                         f"{tuple(word.shape)}, scales {tuple(scales.shape)} "
                         f"and group {group} do not match")
    x2 = x.reshape(-1, k_dim).contiguous()
    return dtype, x2, torch.empty(x2.shape[0], n, device=x.device,
                                  dtype=x.dtype)


def launch_word_matmul(who: str, x: torch.Tensor, word: torch.Tensor,
                       scales: torch.Tensor, group: int) -> torch.Tensor:
    """Launch the first body, ``csrc/int4_word_matmul.cu``: x [..., K]
    float32 or bfloat16, words int32 [K/8, N], scales float32 [K/group, N]
    -> [..., N] in x's dtype, at any group dividing K. Counts nothing:
    each caller counts its own launches."""
    dtype, x2, y = _word_operands(who, x, word, scales, group)
    (m, k_dim), (plane, n) = x2.shape, word.shape
    if m:
        lib = native.library("int4_word_matmul")
        splits = lib.int4_word_matmul_splits(m, plane, n)
        ws = (torch.empty(splits * m * n, device=x.device,
                          dtype=torch.float32) if splits > 1 else y)
        status = lib.int4_word_matmul(
            x2.data_ptr(), word.data_ptr(), scales.data_ptr(), y.data_ptr(),
            ws.data_ptr(), m, k_dim, n, group, splits, dtype,
            torch.cuda.current_stream(x.device).cuda_stream)
        native.check(status, who)
    return y.reshape(*x.shape[:-1], n)


def launch_word_mma(who: str, x: torch.Tensor, word: torch.Tensor,
                    scales: torch.Tensor, group: int) -> torch.Tensor:
    """Launch the tensor-core body (``csrc/int4_matmul_mma.cu``, library
    ``int4_word_matmul_mma``), one launch, with the operands of
    ``launch_word_matmul`` at a (K/8, group) that ``WORD_BODIES`` gives it
    (raises ``ValueError`` otherwise). Counts nothing."""
    dtype, x2, y = _word_operands(who, x, word, scales, group)
    (m, k_dim), n = x2.shape, word.shape[1]
    if not _word_mma_takes(k_dim // 8, group):
        raise ValueError(f"{who}: no tensor-core body at K={k_dim}, group "
                         f"{group}")
    if m:
        status = native.library(
            "int4_word_matmul_mma").int4_word_matmul_mma(
            x2.data_ptr(), word.data_ptr(), scales.data_ptr(), y.data_ptr(),
            m, k_dim, n, group, dtype,
            torch.cuda.current_stream(x.device).cuda_stream)
        native.check(status, who)
    return y.reshape(*x.shape[:-1], n)


def _group(word, scales):
    return 8 * word.shape[-2] // max(scales.shape[-2], 1)


def int4_matmul_v2_cuda(x: torch.Tensor, word: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """The first body (``csrc/int4_word_matmul.cu``) on CUDA tensors."""
    y = launch_word_matmul("int4_matmul_v2_cuda", x, word, scales,
                           _group(word, scales))
    int4_matmul_v2_cuda.launches += 1
    return y


int4_matmul_v2_cuda.launches = 0


def int4_matmul_v2_mma_cuda(x: torch.Tensor, word: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """The tensor-core body (``launch_word_mma``) on CUDA tensors, one
    counted launch."""
    y = launch_word_mma("int4_matmul_v2_mma_cuda", x, word, scales,
                        _group(word, scales))
    int4_matmul_v2_mma_cuda.launches += 1
    return y


int4_matmul_v2_mma_cuda.launches = 0


def int4_matmul_v2(x: torch.Tensor, word: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(words, scales)`` -> [..., N] in x's dtype: for a CUDA
    tensor the body ``WORD_BODIES`` gives, for a CPU tensor the plain
    version."""
    if not x.is_cuda:
        return int4_matmul_v2_plain(x, word, scales)
    if word_body(x.shape[-1], _group(word, scales)) == "mma":
        return int4_matmul_v2_mma_cuda(x, word, scales)
    return int4_matmul_v2_cuda(x, word, scales)


def _normal(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev)


def check(device=None, out=None) -> dict:
    """The kernel (on the card) or its plain version (on the CPU) against
    ``x @ dequantize_int4_v2`` in float32 at [8, 1280] x [1280, 1536]
    (CPU: [8, 256] x [256, 384]): relative error below 2e-5, the JAX
    tool's limit."""
    dev = resolve_device(device)
    m, k_dim, n = (8, 1280, 1536) if dev.type == "cuda" else (8, 256, 384)
    rng = np.random.default_rng(0)
    w = _normal(rng, (k_dim, n), dev)
    x = _normal(rng, (m, k_dim), dev)
    word, s = quantize_int4_v2(w)
    wd = dequantize_int4_v2(word, s)
    ref = x @ wd
    got = int4_matmul_v2(x, word, s)
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    row = {"check": "int4_matmul_v2", "shape": [m, k_dim, n],
           "group": k_dim // s.shape[0], "max_abs_err": err, "rel": rel,
           "quant_max_abs_err": float((wd - w).abs().max())}
    rep = report("int4_layout_ab check", dev, [row],
                 "ok" if rel < 2e-5 else "fail", out)
    if not rel < 2e-5:
        raise AssertionError(f"int4_matmul_v2: relative error {rel}")
    return rep


def bench(device=None, out=None) -> dict:
    """K9 ("v1-u8"), the word kernel ("v2-i32") and a bf16 matmul at the
    decode shapes, bf16 x, weights from HBM and from L2."""
    dev = resolve_device(device)
    shapes = BENCH_SHAPES if dev.type == "cuda" else CPU_BENCH_SHAPES
    rng = np.random.default_rng(0)
    rows, keep = [], []
    for m, k_dim, n in shapes:
        w = _normal(rng, (k_dim, n), dev)
        xbf = _normal(rng, (m, k_dim), dev).bfloat16()
        p1, s1 = i4.quantize_int4(w)
        p2, s2 = quantize_int4_v2(w)
        t = {}
        for arm, fn, weights in (
                ("v1-u8", i4.int4_matmul, (p1, s1)),
                ("v2-i32", int4_matmul_v2, (p2, s2)),
                ("bf16", torch.matmul, (w.bfloat16(),))):
            t[arm], warm = arm_times(fn, xbf, weights)
            nbytes = sum(a.numel() * a.element_size() for a in weights)
            rows.append(arm_row(arm, (m, k_dim, n), t[arm], warm, nbytes))
        keep.append(rule(t["v2-i32"], t["v1-u8"]) == "keep")
    return report("int4_layout_ab bench", dev, rows,
                  "keep" if all(keep) else "reject", out,
                  current=current_arm(dev, shapes[0][1]),
                  word_body=[WORD_BODIES[word_body(k, fit_group_v2(k))][0]
                             if dev.type == "cuda" else
                             "int4_matmul_v2_plain" for _, k, _ in shapes])


def main(device=None, out=None, mode="bench") -> dict:
    """Int4 words of eight nibbles vs K9: ``check`` (numerics) or
    ``bench`` (timing)."""
    return (check if mode == "check" else bench)(device=device, out=out)


if __name__ == "__main__":
    cli(main, modes=("bench", "check"))
