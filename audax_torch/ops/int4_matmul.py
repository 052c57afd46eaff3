"""Int4 weight-only matmul: the CUDA kernel K9 and its plain PyTorch version.

Port of ``audax/ops/int4_matmul.py`` (``fit_group``, ``quantize_int4``,
``dequantize_int4``, ``int4_matmul``). Decode with a small batch reads every
decoder weight once per token, so bytes per weight set the pace; 4-bit
storage is two nibbles per uint8 byte, packed split-half along the
contraction axis, with one float32 scale per (group of contraction rows,
output channel) -- round-to-nearest group-wise int4.

Layouts (``K`` = contraction dim, ``N`` = output dim), kept byte for byte
from the JAX package so its int4 trees cross the bridge unchanged:

  packed  uint8 [..., K//2, N]   byte (c, n) holds K-row c in the low nibble
                                 and K-row c + K//2 in the high nibble, each
                                 stored as q + 8, q in [-7, 7]
  scales  f32   [..., G, N]      G = K // group; a group never straddles the
                                 split-half boundary (K//2 % group == 0)

``int4_matmul`` dispatches on the tensor it is given:

  * CUDA, M <= 256 rows: kernel K9, which reads the packed bytes and scales
    once and never builds a float weight, on the body ``BODIES`` gives the
    call's (K/2, group): the tensor-core body (``csrc/int4_matmul_mma.cu``,
    mma.sync, one launch with its K splits reduced in a thread block
    cluster) wherever it takes the call -- every group that is a multiple
    of 16 packed rows, K/2 up to 8192: each Whisper projection -- and the
    split-half body (``csrc/int4_matmul.cu``, CUDA cores, a second launch
    for its split-K sum) for the rest. Each body has a wrapper of its own
    that checks the operands and counts its launches
    (``int4_matmul_mma_cuda``, ``int4_matmul_cuda``);
  * CUDA, M > 256 (the encoder, the cross-K/V projection at admit):
    dequantize, then ``torch.matmul`` -- what the JAX function does outside
    its kernel. It counts its own launches (``int4_matmul_dequant``); a
    failure of K9 never takes this branch;
  * CPU: ``int4_matmul_plain`` (dequantize, then a float32 product).

A leading layer axis is selected by ``layer``; the kernel is given the
pointer of that layer's slice (a view, never a copy), which is what the TPU
kernel's scalar prefetch did.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audax_torch.ops import native

__all__ = ["fit_group", "quantize_int4", "dequantize_int4", "int4_matmul",
           "int4_matmul_plain", "int4_matmul_cuda", "int4_matmul_mma_cuda",
           "int4_matmul_dequant", "MAX_KERNEL_ROWS", "BODIES", "int4_body"]

#: the kernel's row limit; larger M dequantizes and calls torch.matmul
MAX_KERNEL_ROWS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: K9's bodies on a CUDA tensor, in the order ``int4_body`` tries them:
#: name -> (the counter of its launches in ``ops.KERNELS``, whether it takes
#: a call's (K/2, group)). The tensor-core body's rule is the source's
#: ``int4mma::takes``: a group of whole 16-row products and at most 16
#: splits of 512 packed rows; the split-half body takes every call.
BODIES = {
    "mma": ("int4_matmul_mma",
            lambda kh, group: group % 16 == 0 and kh <= 16 * 512),
    "split_half": ("int4_matmul", lambda kh, group: True),
}


def int4_body(k_dim: int, group: int) -> str:
    """The body ``BODIES`` gives a [.., K] x [K/2, N] call at ``group``."""
    return next(name for name, (_, takes) in BODIES.items()
                if takes(k_dim // 2, group))


def fit_group(k_dim: int, group: int = 128) -> int:
    """Largest divisor of ``k_dim // 2`` that is <= ``group``, found by
    halving (``group`` itself when that divides, else possibly not a power
    of two, e.g. fit_group(160) == 80). Split-half packing needs groups
    that do not straddle the half boundary."""
    if k_dim % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {k_dim}")
    g = min(group, k_dim // 2)
    while (k_dim // 2) % g:
        g //= 2
    if g < 1:
        raise ValueError(f"no valid int4 group for K={k_dim}")
    return g


def quantize_int4(w: torch.Tensor, *, group: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` [..., K, N] (contraction axis -2) to (packed
    [..., K//2, N] uint8, scales [..., G, N] float32), both contiguous
    (``w`` may be a strided view, e.g. a transposed embedding)."""
    w = w.float().contiguous()
    k_dim, n = w.shape[-2], w.shape[-1]
    g = fit_group(k_dim, group)
    num_g = k_dim // g
    grouped = w.reshape(*w.shape[:-2], num_g, g, n)           # [..., G, g, N]
    s = grouped.abs().amax(dim=-2)                            # [..., G, N]
    s = torch.clamp_min(s / 7.0, 1e-12)
    q = torch.clamp(torch.round(grouped / s[..., None, :]), -7, 7)
    q = q.reshape(*w.shape[:-2], k_dim, n)
    lo = (q[..., : k_dim // 2, :] + 8).to(torch.uint8)
    hi = (q[..., k_dim // 2:, :] + 8).to(torch.uint8)
    return lo | (hi << 4), s


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_int4`` -> [..., K, N] in ``dtype``."""
    kh = packed.shape[-2]
    g = 2 * kh // scales.shape[-2]
    pi = packed.to(torch.int32)
    q = torch.cat([(pi & 0xF) - 8, (pi >> 4) - 8], dim=-2).to(dtype)
    return q * torch.repeat_interleave(scales.to(dtype), g, dim=-2)


def _select(packed, scales, layer):
    """(packed [K//2, N], scales [G, N]) of ``layer`` -- views, no copy."""
    if packed.dim() == 3:
        if layer is None:
            raise ValueError("stacked int4 weights need a layer index")
        return packed[int(layer)], scales[int(layer)]
    if packed.dim() != 2:
        raise ValueError(f"packed int4 weights must be [K//2, N] or "
                         f"[L, K//2, N], got {tuple(packed.shape)}")
    return packed, scales


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, *, layer=None) -> torch.Tensor:
    """``x @ dequant(packed, scales)``: dequantize in float32, a float32
    product, cast back to x's dtype. x [..., K] -> [..., N]."""
    int4_matmul_plain.launches += 1
    packed, scales = _select(packed, scales, layer)
    w = dequantize_int4(packed, scales, torch.float32)
    return (x.float() @ w).to(x.dtype)


int4_matmul_plain.launches = 0


def int4_matmul_dequant(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, *, layer=None) -> torch.Tensor:
    """The large-M branch: dequantize in x's dtype, then ``torch.matmul``
    (the JAX function's own path outside its kernel). Float32 runs in full
    float32 (TF32 is off on the port's CUDA devices)."""
    packed, scales = _select(packed, scales, layer)
    y = torch.matmul(x, dequantize_int4(packed, scales, x.dtype))
    int4_matmul_dequant.launches += 1
    return y


int4_matmul_dequant.launches = 0


def _operands(who, x, packed, scales, layer):
    """Check K9's operands on the card: (x as [M, K] contiguous, packed
    [K//2, N] and scales [G, N] of ``layer`` -- views --, the leading dims
    of x, K, N and the group). Raises ``ValueError`` on anything the
    kernels do not take."""
    packed, scales = _select(packed, scales, layer)
    if not (x.is_cuda and packed.is_cuda and scales.is_cuda
            and x.device == packed.device == scales.device):
        raise ValueError(f"{who}: every operand must be on one CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{who}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise ValueError(f"{who}: packed must be uint8 and scales float32, "
                         f"got {packed.dtype} / {scales.dtype}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{who}: packed and scales must be contiguous")
    kh, n = packed.shape
    k_dim, num_g = 2 * kh, scales.shape[0]
    if x.shape[-1] != k_dim or scales.shape[1] != n or num_g % 2 \
            or k_dim % num_g:
        raise ValueError(f"{who}: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} and scales "
                         f"{tuple(scales.shape)} do not match")
    x2 = x.reshape(-1, k_dim).contiguous()
    if x2.shape[0] > MAX_KERNEL_ROWS:
        raise ValueError(f"{who}: {x2.shape[0]} rows > {MAX_KERNEL_ROWS}")
    return x2, packed, scales, x.shape[:-1], k_dim, n, k_dim // num_g


def int4_matmul_mma_cuda(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, *, layer=None) -> torch.Tensor:
    """K9's tensor-core body (``csrc/int4_matmul_mma.cu``), one counted
    launch: x [..., K] float32 or bfloat16 with at most 256 rows, packed
    uint8 [(L,) K//2, N], scales float32 [(L,) G, N] -> [..., N] in x's
    dtype, summed in float32, at a (K/2, group) that ``BODIES`` gives this
    body (raises ``ValueError`` otherwise)."""
    x2, packed, scales, lead, k_dim, n, group = _operands(
        "int4_matmul_mma_cuda", x, packed, scales, layer)
    if int4_body(k_dim, group) != "mma":
        raise ValueError(f"int4_matmul_mma_cuda: no tensor-core body at "
                         f"K={k_dim}, group {group}")
    m = x2.shape[0]
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    if m == 0:
        return y.reshape(*lead, n)
    if x2.data_ptr() % (2 * x2.element_size()):    # it loads pairs of x
        x2 = x2.clone()
    status = native.library("int4_matmul_mma").int4_matmul_mma(
        x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(), m,
        k_dim, n, group, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(status, "int4_matmul_mma")
    int4_matmul_mma_cuda.launches += 1
    return y.reshape(*lead, n)


int4_matmul_mma_cuda.launches = 0


def int4_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, *, layer=None) -> torch.Tensor:
    """K9's split-half body (``csrc/int4_matmul.cu``, CUDA cores), one
    counted call -- its kernel and, with more than one K split, the split
    sum: same operands as ``int4_matmul_mma_cuda``, at any (K/2, group)."""
    x2, packed, scales, lead, k_dim, n, group = _operands(
        "int4_matmul_cuda", x, packed, scales, layer)
    m, kh = x2.shape[0], k_dim // 2
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    if m == 0:
        return y.reshape(*lead, n)
    lib = native.library("int4_matmul")
    splits = lib.int4_matmul_splits(m, kh, n)
    ws = (torch.empty(splits * m * n, device=x.device, dtype=torch.float32)
          if splits > 1 else y)
    status = lib.int4_matmul(
        x2.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
        ws.data_ptr(), m, k_dim, n, group, splits, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(status, "int4_matmul")
    int4_matmul_cuda.launches += 1
    return y.reshape(*lead, n)


int4_matmul_cuda.launches = 0


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                *, layer: Optional[int] = None) -> torch.Tensor:
    """``x @ dequant(packed, scales)`` -> [..., N]. ``packed``/``scales`` as
    ``quantize_int4`` writes them, optionally with one leading stacked axis
    picked by ``layer``. CUDA: kernel K9 for at most 256 rows (on the body
    ``BODIES`` gives), dequantize + ``torch.matmul`` above that; CPU: the
    plain version."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales, layer=layer)
    m = x.numel() // max(x.shape[-1], 1)
    if m > MAX_KERNEL_ROWS:
        return int4_matmul_dequant(x, packed, scales, layer=layer)
    k_dim = x.shape[-1]
    if int4_body(k_dim, k_dim // max(scales.shape[-2], 1)) == "mma":
        return int4_matmul_mma_cuda(x, packed, scales, layer=layer)
    return int4_matmul_cuda(x, packed, scales, layer=layer)
