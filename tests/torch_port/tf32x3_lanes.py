"""The 3xTF32 pieces of ``csrc/tf32x3.cuh`` in numpy, lane by lane, for the
numpy transcriptions of the float32 tensor-core bodies (K2's
``flash_fwd_tf32x3.cu``, K7's and K8's ``flash_bwd_tf32x3.cu``), and
``fwd_warps``, the key loop of K2's float32 body for many warps at once
(K2's transcription runs a head's warps through it, the head folds' a
whole grid of warps).

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


NEG = np.float32(-1e30)
LN2 = np.float32(0.6931471805599453)


def fwd_warps(qa, kst, vst, kv_len, bk, passes=3, rows=None):
    """The key loop and epilogue of K2's float32 body
    (``flash_fwd_tf32x3_kernel``) for many warps at once.

    ``qa`` [..., KS, 32, 4]: each warp's A fragments of Q, scaled by scale *
    log2(e), k-step by k-step; ``kst``, ``vst`` [..., rows, D]: the K and V
    rows of the warp's head as its ring stages them (rows past ``kv_len``
    zero, never read), their leading axes broadcast against ``qa``'s;
    ``bk`` the keys of one ring stage (one step of the online softmax);
    ``rows``, for the causal mask, each warp's first query row (an int
    array broadcast against ``qa``'s leading axes), or None. A warp takes
    no tile past its last row; the loop runs to the last tile any warp
    takes, and a tile wholly masked for a warp leaves its m, l and o
    exactly as they were (p = 0, alpha = 1).
    Returns (o [..., 16, D], lse [..., 16]) of the warp's 16 rows, each
    written by the lanes that hold it."""
    lead, ks = qa.shape[:-3], qa.shape[-3]
    nt_ = bk // 8
    m = np.full(lead + (32, 2), NEG, np.float32)
    lpart = np.zeros(lead + (32, 2), np.float32)
    acc = np.zeros(lead + (ks, 32, 4), np.float32)
    i = np.arange(4)
    end = kv_len if rows is None else min(kv_len, int(np.max(rows)) + 16)
    for k0 in range(0, end, bk):
        kt, vt = kst[..., k0: k0 + bk, :], vst[..., k0: k0 + bk, :]
        s = np.zeros(lead + (nt_, 32, 4), np.float32)
        for kk in range(ks):
            for nt in range(nt_):
                bfr = np.stack([kt[..., 8 * nt + G, 8 * kk + T],
                                kt[..., 8 * nt + G, 8 * kk + T + 4]], -1)
                s[..., nt, :, :] = mma3(s[..., nt, :, :], qa[..., kk, :, :],
                                        bfr, passes)
        col = (k0 + 8 * np.arange(nt_)[:, None, None]
               + 2 * T[None, :, None] + (i & 1))
        masked = col >= kv_len
        if rows is not None:
            row = (np.asarray(rows)[..., None, None, None]
                   + (G[:, None] + 8 * (i >> 1)))
            masked = masked | (col > row)
        s[np.broadcast_to(masked, s.shape)] = NEG
        for hh in range(2):
            vals = s[..., 2 * hh: 2 * hh + 2]
            mx = vals.max(axis=(-3, -1))
            mx = np.repeat(mx.reshape(lead + (8, 4)).max(-1), 4, -1)  # quad
            m_new = np.maximum(m[..., hh], mx)
            alpha = np.exp2(m[..., hh] - m_new)
            mu = np.where(m_new == NEG, np.float32(0), m_new)
            p = np.exp2(vals - mu[..., None, :, None])
            s[..., 2 * hh: 2 * hh + 2] = p
            lpart[..., hh] = lpart[..., hh] * alpha + p.sum((-3, -1))
            m[..., hh] = m_new
            acc[..., 2 * hh: 2 * hh + 2] *= alpha[..., None, :, None]
        for j in range(nt_):
            afr = a_from_c(s[..., j, :, :])              # k permuted
            for nd in range(ks):
                bfr = np.stack([vt[..., 8 * j + 2 * T, 8 * nd + G],
                                vt[..., 8 * j + 2 * T + 1, 8 * nd + G]], -1)
                acc[..., nd, :, :] = mma3(acc[..., nd, :, :], afr, bfr,
                                          passes)
    lt = np.repeat(lpart.reshape(lead + (8, 4, 2)).sum(-2), 4, -2)
    o = np.zeros(lead + (16, 8 * ks), np.float32)
    lse = np.zeros(lead + (16,), np.float32)
    for hh in range(2):
        ls = np.where(lt[..., hh] == 0, np.float32(1), lt[..., hh])
        for nd in range(ks):
            for e in range(2):
                o[..., G + 8 * hh, 8 * nd + 2 * T + e] = (
                    acc[..., nd, :, 2 * hh + e] / ls)
        lse[..., G + 8 * hh] = np.where(
            lt[..., hh] == 0, NEG,
            m[..., hh] * LN2 + np.log(np.where(lt[..., hh] == 0, 1,
                                               lt[..., hh])))
    return o, lse
