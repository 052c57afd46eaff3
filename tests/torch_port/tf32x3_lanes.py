"""The 3xTF32 pieces of ``csrc/tf32x3.cuh`` in numpy, lane by lane, for the
numpy transcriptions of the float32 tensor-core bodies (K2's
``flash_fwd_tf32x3.cu``, K7's and K8's ``flash_bwd_tf32x3.cu``).

A warp's fragment is an array [..., 32, n] (lane, register), with any
leading axes: a transcription may run many warps at once. Lane ``l``
holds g = l // 4, t = l % 4 (``G``, ``T``).
"""

import numpy as np

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero (the magnitude's low 13 bits, sign apart)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mma(c, a, b):
    """One ``mma.sync.m16n8k8.row.col`` on each warp's fragments: c [..., 32,
    4] += A @ B with A 16x8 from a [..., 32, 4] and B 8x8 from b [..., 32,
    2]."""
    am = np.zeros(a.shape[:-2] + (16, 8))
    am[..., G, T], am[..., G + 8, T] = a[..., 0], a[..., 1]
    am[..., G, T + 4], am[..., G + 8, T + 4] = a[..., 2], a[..., 3]
    bm = np.zeros(b.shape[:-2] + (8, 8))
    bm[..., T, G], bm[..., T + 4, G] = b[..., 0], b[..., 1]
    d = am @ bm
    return (c + np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                          d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]],
                         -1)).astype(np.float32)


def mma3(c, a, b, passes=3):
    """c += a b in 3xTF32 in the kernel's order (``tf32x3::mma3``), or in
    one TF32 pass."""
    if passes == 1:
        return mma(c, tf32(a), tf32(b))
    (ab, as_), (bb, bs) = split(a), split(b)
    return mma(mma(mma(c, as_, bb), ab, bs), ab, bb)


def a_from_c(c):
    """``tf32x3::a_from_c``: a C fragment as the next product's A fragment
    in the permuted k order (a0 = c0, a1 = c2, a2 = c1, a3 = c3)."""
    return c[..., [0, 2, 1, 3]]
