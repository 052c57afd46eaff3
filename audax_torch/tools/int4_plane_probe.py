"""Plane-interleaved int32 int4 packing against kernel K9: port of
``tools/int4_plane_probe.py``.

The packing is ``int4_layout_ab``'s split-eighth words (nibble p of word
(c, n) holds K-row c + p*K/8), but the quantization groups are K9's: the
group (128 by default) is halved until it divides K, not K/8, so a group
may straddle two planes (K = 1280: plane 160, group 128). The kernel is
``int4_layout_ab``'s (``csrc/int4_word_matmul.cu``), which takes any group
that divides K; ``plane_matmul`` counts its own launches.

``main`` checks the plane kernel against K9 on the same round-to-nearest
grid (bf16 x: they must agree to 2e-2 of the largest output), counts the
bytes each streams, and times both with their weights from device memory
and warm in L2. Its row carries the keys of ``results/int4_plane_probe.json``
(the TPU's record, left as it is) plus the L2-warm times; the floor is the
plane layout's bytes over the H100's 3.35 TB/s. Verdict: ``keep`` if
``t_plane < 0.85 * t_current``.

    python -m audax_torch.tools.int4_plane_probe [--device cpu] [--out PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from audax_torch.core.runtime import resolve_device
from audax_torch.ops import int4_matmul as i4
from audax_torch.tools import arm_times, cli, current_arm, report
from audax_torch.tools import verdict as rule
from audax_torch.tools.int4_layout_ab import (dequantize_int4_v2,
                                              launch_word_matmul,
                                              quantize_words)
from audax_torch.utils.profiling import H100_HBM_BPS

__all__ = ["quantize_int4_planes", "plane_matmul", "plane_matmul_plain",
           "plane_matmul_cuda", "main"]


def quantize_int4_planes(w: torch.Tensor, *, group: int = 128):
    """w [K, N] -> (words int32 [K/8, N], scales float32 [G, N], group):
    the group halved until it divides K; it may straddle planes."""
    k_dim = w.shape[0]
    if k_dim % 8:
        raise ValueError(f"plane packing needs K % 8 == 0, got {k_dim}")
    g = group
    while k_dim % g:
        g //= 2
    word, s = quantize_words(w, g)
    return word, s, g


def _check_group(who, word, scales, group):
    if 8 * word.shape[0] != group * scales.shape[0]:
        raise ValueError(f"{who}: group {group} does not match words "
                         f"{tuple(word.shape)} and scales "
                         f"{tuple(scales.shape)}")


def plane_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor, *, group: int) -> torch.Tensor:
    """``x @ dequant(packed, scales)`` in float32, cast to x's dtype."""
    plane_matmul_plain.launches += 1
    _check_group("plane_matmul_plain", packed, scales, group)
    return (x.float() @ dequantize_int4_v2(packed, scales)).to(x.dtype)


plane_matmul_plain.launches = 0


def plane_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, *, group: int) -> torch.Tensor:
    """The word kernel at a group that may straddle planes."""
    y = launch_word_matmul("plane_matmul_cuda", x, packed, scales, group)
    plane_matmul_cuda.launches += 1
    return y


plane_matmul_cuda.launches = 0


def plane_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 *, group: int) -> torch.Tensor:
    """x [..., K] @ plane-packed int4 -> [..., N]: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return plane_matmul_cuda(x, packed, scales, group=group)
    return plane_matmul_plain(x, packed, scales, group=group)


def main(device=None, out=None) -> dict:
    """Plane-interleaved int32 packing vs K9 at [8, 1280] x [1280, 5120]
    (CPU: [8, 256] x [256, 512]), bf16 x."""
    dev = resolve_device(device)
    m, k_dim, n = (8, 1280, 5120) if dev.type == "cuda" else (8, 256, 512)
    r = np.random.default_rng(0)
    w = torch.from_numpy((r.standard_normal((k_dim, n)) / np.sqrt(k_dim))
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(r.standard_normal((m, k_dim)).astype(np.float32)
                         ).to(dev).bfloat16()

    # parity: the same RTN grid as K9, so the two agree to bf16 noise
    pk8, s8 = i4.quantize_int4(w)
    pkp, sp, gp = quantize_int4_planes(w)
    y_cur = i4.int4_matmul(x, pk8, s8)
    y_pl = plane_matmul(x, pkp, sp, group=gp)
    err = float((y_pl.float() - y_cur.float()).abs().max())
    rel = err / float(y_cur.float().abs().max())
    row = {"parity_max_abs_err": err, "parity_rel": rel,
           "bytes_current": pk8.numel() + 4 * s8.numel(),
           "bytes_plane": 4 * pkp.numel() + 4 * sp.numel(),
           "group_current": k_dim // s8.shape[0], "group_plane": gp}
    if not rel < 2e-2:
        raise AssertionError(f"plane kernel parity broke: {err}")

    t_cur, t_cur_l2 = arm_times(i4.int4_matmul, x, (pk8, s8))
    t_pl, t_pl_l2 = arm_times(
        lambda xx, p, s: plane_matmul(xx, p, s, group=gp), x, (pkp, sp))
    row.update(us_current=1e6 * t_cur, us_plane=1e6 * t_pl,
               us_current_l2=1e6 * t_cur_l2, us_plane_l2=1e6 * t_pl_l2,
               floor_us_selected_bytes=row["bytes_plane"] / H100_HBM_BPS
               * 1e6,
               speedup=t_cur / t_pl, verdict=rule(t_pl, t_cur))
    return report("int4_plane_probe", dev, [row], row["verdict"], out,
                  current=current_arm(dev, k_dim))


if __name__ == "__main__":
    cli(main)
