"""W4A8 -- int8 activations times int4 weights -- against kernel K9: port of
``tools/w4a8_probe.py``.

The activations are quantized per row to int8 outside the kernel, in the
JAX function's order of operations (float32; ``absmax`` floored at 1e-12,
then / 127; round half to even; clip to +-127). The weights keep K9's
split-half uint8 layout (``ops/int4_matmul.py:quantize_int4``). The kernel
(``csrc/w4a8_matmul.cu``) sums int8 x times int8 (nib - 8) per group
exactly in int32 with ``__dp4a``, scales each group's sum once in float32
and applies the row scale last.

``main`` holds the probe against ``x @ dequantize_int4`` (the NRMSE is the
activation quantization's noise, expected below 1%) and times four arms
with their weights from device memory and warm in L2: K9 ("w4a16
(current)"), the probe (quantization and kernel), an int8 weight matrix
with per-column scales converted to bf16 for a bf16 ``torch.matmul`` (the
JAX tool's "int8 einsum"), and a bf16 matmul; beside them the activation
quantization alone, which the probe's arm includes. Verdict: ``keep`` when
the probe beats K9 by ``tools.KEEP_RATIO``.

    python -m audax_torch.tools.w4a8_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops import int4_matmul as i4
from audax_torch.ops import native
from audax_torch.tools import (arm_row, arm_times, cli, current_arm,
                               kernel_operands, report, split_half_shape)
from audax_torch.tools import verdict as rule

__all__ = ["quantize_activations", "w4a8_matmul", "w4a8_matmul_plain",
           "w4a8_matmul_cuda", "main"]


def quantize_activations(x: torch.Tensor):
    """x [..., K] -> (int8 [M, K], float32 row scales [M, 1]), M the rows
    of x: the JAX function's dynamic per-row symmetric quantization."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    xs = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    xq = torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8)
    return xq, xs


def w4a8_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: per-group int8 products summed
    in float32 (exact: every partial sum is an integer below 2^24), scaled
    by s_g, summed over the groups, times the row scale."""
    w4a8_matmul_plain.launches += 1
    k_dim, n, group = split_half_shape("w4a8_matmul_plain", x, packed, scales)
    xq, xs = quantize_activations(x)
    m, num_g = xq.shape[0], k_dim // group
    pi = packed.to(torch.int32)
    q = torch.cat([(pi & 0xF) - 8, (pi >> 4) - 8]).float()      # [K, N]
    part = torch.einsum("mgk,gkn->mgn", xq.float().reshape(m, num_g, group),
                        q.reshape(num_g, group, n))
    acc = (part * scales[None]).sum(dim=1)
    return (acc * xs).to(x.dtype).reshape(*x.shape[:-1], n)


w4a8_matmul_plain.launches = 0


def w4a8_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/w4a8_matmul.cu``): x [..., K] float32 or
    bfloat16, packed uint8 [K/2, N], scales float32 [G, N] -> [..., N] in
    x's dtype. K % 8 == 0 and a group that is a multiple of 4."""
    who = "w4a8_matmul_cuda"
    dtype = kernel_operands(who, x, packed, scales, torch.uint8)
    k_dim, n, group = split_half_shape(who, x, packed, scales)
    if k_dim % 8 or group % 4:
        raise ValueError(f"{who}: needs K % 8 == 0 and a group that is a "
                         f"multiple of 4, got K {k_dim}, group {group}")
    xq, xs = quantize_activations(x)
    m = xq.shape[0]
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    lib = native.library("w4a8_matmul")
    splits = lib.w4a8_matmul_splits(m, k_dim // 2, n)
    ws = (torch.empty(splits * m * n, device=x.device, dtype=torch.float32)
          if splits > 1 else y)
    status = lib.w4a8_matmul(
        xq.data_ptr(), xs.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        y.data_ptr(), ws.data_ptr(), m, k_dim, n, group, splits, dtype,
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(status, who)
    w4a8_matmul_cuda.launches += 1
    return y.reshape(*x.shape[:-1], n)


w4a8_matmul_cuda.launches = 0


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """int8-quantized x @ int4 weights -> [..., N] in x's dtype: the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return w4a8_matmul_cuda(x, packed, scales)
    return w4a8_matmul_plain(x, packed, scales)


def main(device=None, out=None) -> dict:
    """W4A8 vs K9 at [8, 1280] x [1280, 5120] (CPU: [8, 256] x [256, 512]),
    bf16 x."""
    dev = resolve_device(device)
    m, k_dim, n = (8, 1280, 5120) if dev.type == "cuda" else (8, 256, 512)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((k_dim, n)).astype(np.float32)
                         ).to(dev)
    x = torch.from_numpy(rng.standard_normal((m, k_dim)).astype(np.float32)
                         ).to(dev)
    xbf = x.bfloat16()
    packed, sc = i4.quantize_int4(w)
    s8 = w.abs().amax(dim=0) / 127
    wq8 = torch.clamp(torch.round(w / s8), -127, 127).to(torch.int8)

    # correctness: w4a8 against the float product on the dequantized weights
    ref = x @ i4.dequantize_int4(packed, sc)
    got = w4a8_matmul(xbf, packed, sc).float()
    nrmse = float(((got - ref) ** 2).mean().sqrt() / ref.std())
    if not nrmse < 2e-2:
        raise AssertionError(f"w4a8 vs int4-dequant: NRMSE {nrmse}")

    rows, t = [], {}
    for arm, fn, weights in (
            ("w4a16 (current)", i4.int4_matmul, (packed, sc)),
            ("w4a8 (probe)", w4a8_matmul, (packed, sc)),
            ("int8 einsum", lambda x_, q_, s_: torch.matmul(
                x_, q_.to(x_.dtype)) * s_, (wq8, s8)),
            ("bf16 einsum", torch.matmul, (w.bfloat16(),))):
        t[arm], warm = arm_times(fn, xbf, weights)
        nbytes = sum(a.numel() * a.element_size() for a in weights)
        rows.append(arm_row(arm, (m, k_dim, n), t[arm], warm, nbytes))
    quant, _ = arm_times(lambda x_: quantize_activations(x_), xbf, ())
    return report("w4a8_probe", dev, rows,
                  rule(t["w4a8 (probe)"], t["w4a16 (current)"]), out,
                  nrmse=nrmse, us_activation_quant=1e6 * quant,
                  current=current_arm(dev, k_dim))


if __name__ == "__main__":
    cli(main)
