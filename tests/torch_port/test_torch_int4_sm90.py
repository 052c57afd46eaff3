"""K9's tensor-core body (``csrc/int4_matmul_mma.cu``) on the CPU, where
nothing can launch.

* The kernel's schedule, transcribed into numpy lane by lane: the split
  plan and the shared memory read from the source (``csrc_constexpr``);
  each warp's copy of its 16 columns of every packed row of the block's
  range -- 16-byte rows where the rows are 16-byte aligned, else the two
  aligned 16-byte chunks that cover the row (chunks at or past the layer's
  end zero-filled, bytes past the buffer's end garbage) read at the row's
  offset in 2-byte or 1-byte pieces; the ``ldmatrix.x4.trans`` register of
  each lane (bytes (2t, 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1)); the
  unpack by mask, byte permute under 0x43 and a bf16 subtraction of 136;
  x's three bf16 parts (round to nearest even, each of what the parts
  before it leave) staged as B fragments; the m16n8k16 products through
  the fragment maps of ``mma.sync`` (A row, B col, C), each part in its
  own sums; each group summed from zero, its parts added smallest first,
  then scaled and added in float32;
  and the blocks of a cluster summed in block order. At M in {1, 3, 8, 9,
  16}, N in {1, 7, 130, 258} (258 = 2 mod 16, as 51,866), groups 64, 80
  and 128, and a stacked layer, it equals ``int4_matmul_plain`` within
  1e-5 of the plain output's largest value (the plain version rounds each
  dequantized weight to float32 and sums in another order).
* The same inputs through the JAX package's ``int4_matmul`` (its Pallas
  kernel in interpret mode, as the JAX tests run it) within 1e-5.
* One bf16 part of float32 x instead of three has at least 100x the
  error: the split is what keeps the float32 parity.
* The body table: its rule is the source's ``takes``, the plan fills the
  card at the decode shapes and fits a cluster, every plan's shared memory
  fits one block, and the launcher refuses CPU tensors and counts apart;
  the library is bound with the C prototype's arguments.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops import int4_matmul as J
from audax_torch.ops import KERNELS, native
from audax_torch.ops import int4_matmul as i4

from .csrc_constexpr import CSRC, constexpr_function

SRC = "int4_matmul_mma.cu"
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
WARPS, WARP_N, MT, KSTEP, STAGE = 4, 16, 8, 16, 32


def _fn(name):
    return constexpr_function(SRC, name)


def bf16(x):
    """``cvt.rn.bf16x2.f32``: float32 -> the nearest bf16 (ties to even),
    returned as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def x_parts(v, parts):
    """The kernel's split of float32 x into ``parts`` bf16 values, largest
    first: each the round-to-nearest of what the ones before it leave."""
    out, v = [], np.asarray(v, np.float32).copy()
    for _ in range(parts):
        p = bf16(v)
        out.append(p)
        v = (v - p).astype(np.float32)
    return out


def byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on uint32 arrays."""
    x, y = np.broadcast_arrays(np.asarray(x, np.uint32),
                               np.asarray(y, np.uint32))
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                   + [(y >> (8 * i)) & 0xFF for i in range(4)])
    return sum(src[(sel >> (4 * i)) & 0x7] << (8 * i) for i in range(4))


def bf16_pair(v):
    """The two bf16 values of a uint32 register as float32 (low, high)."""
    v = np.asarray(v, np.uint32)
    return ((v << 16).view(np.float32), (v & 0xFFFF0000).view(np.float32))


def unpack(r0, r1):
    """``int4mma::unpack``: A fragments [32, 8] (a0..a7) of the low and the
    high nibbles from the ldmatrix registers of rows 0-7 and 8-15."""
    out = []
    for shift in (0, 4):
        regs = []
        for r in (r0, r1):
            nib = (r >> shift) & 0x0F0F0F0F
            for sel in (0x4240, 0x4341):        # bytes 0, 2 / 1, 3
                lo, hi = bf16_pair(byte_perm(nib, np.uint32(0x43434343), sel))
                regs += [lo - 136, hi - 136]    # exact in bf16
        # register order: a0a1 (r0 col 2g), a2a3 (r0 col 2g+1), a4a5, a6a7
        out.append(np.stack(regs, -1).astype(np.float32))
    return out


def mma16(c, a, b):
    """One ``mma.sync.m16n8k16.row.col`` bf16 product: c [32, 4] += A @ B
    with A 16x16 from a [32, 8] and B 16x8 from b [32, 4]; the products
    are exact, the float32 sum rounded once."""
    am = np.zeros((16, 16))
    am[G, 2 * T], am[G, 2 * T + 1] = a[:, 0], a[:, 1]
    am[G + 8, 2 * T], am[G + 8, 2 * T + 1] = a[:, 2], a[:, 3]
    am[G, 2 * T + 8], am[G, 2 * T + 9] = a[:, 4], a[:, 5]
    am[G + 8, 2 * T + 8], am[G + 8, 2 * T + 9] = a[:, 6], a[:, 7]
    bm = np.zeros((16, 8))
    bm[2 * T, G], bm[2 * T + 1, G] = b[:, 0], b[:, 1]
    bm[2 * T + 8, G], bm[2 * T + 9, G] = b[:, 2], b[:, 3]
    d = am @ bm
    return (c + np.stack([d[G, 2 * T], d[G, 2 * T + 1], d[G + 8, 2 * T],
                          d[G + 8, 2 * T + 1]], -1)).astype(np.float32)


def ldmatrix_regs(smem_rows):
    """``ldmatrix.x4.trans`` over 32 rows of 16 bytes: register j of lane
    (g, t) holds bytes (8j + 2t, 2g), (8j + 2t, 2g + 1), (8j + 2t + 1, 2g),
    (8j + 2t + 1, 2g + 1)."""
    rows = smem_rows.astype(np.uint32)
    return [rows[8 * j + 2 * T, 2 * G] | rows[8 * j + 2 * T, 2 * G + 1] << 8
            | rows[8 * j + 2 * T + 1, 2 * G] << 16
            | rows[8 * j + 2 * T + 1, 2 * G + 1] << 24 for j in range(4)]


def vec_of(n, base):
    """``launch_vec``: the widest row read the alignment allows."""
    return 16 if n % 16 == 0 and base % 16 == 0 else \
        2 if n % 2 == 0 and base % 2 == 0 else 1


def warp_rows(mem, base, kh, n, c0, rows, st, nw, vec, nt):
    """The 32 x 16 nt bytes a warp's lanes read for rows c0 + 32 st + [0,
    32) at columns nw + [0, 16 nt): what its cp.async copies leave in shared
    memory (rows past the range zero-filled), read as the kernel reads them
    (the swizzled chunks of an aligned row through ldmatrix, or each row at
    its offset in the nt + 1 aligned chunks that cover it)."""
    w_end = base + kh * n
    out = np.zeros((32, 16 * nt), np.uint8)
    swz = _fn("swizzle")
    for r in range(32):
        rr = st * STAGE + r
        addr = base + (c0 + rr) * n + nw
        if vec == 16:
            stored = np.zeros(16 * nt, np.uint8)     # the smem row
            for ch in range(nt):
                if rr < rows and nw + 16 * ch < n:
                    at = 16 * swz(rr, ch, nt)
                    stored[at:at + 16] = mem[addr + 16 * ch:addr + 16 * ch + 16]
            for i in range(nt):                  # ldmatrix of tile i, row r
                at = 16 * swz(r, i, nt)
                out[r, 16 * i:16 * i + 16] = stored[at:at + 16]
            continue
        copy = np.zeros(16 * (nt + 1), np.uint8)
        a = addr % 16
        for q in range(nt + 1):
            src = addr - a + 16 * q
            if rr < rows and src < w_end:
                copy[16 * q:16 * q + 16] = mem[src:src + 16]
        out[r] = copy[a:a + 16 * nt]
    return out


def kernel_schedule(x, mem, base, kh, n, scales, group, parts=None, nt=None):
    """``int4mma_kernel`` in numpy: x [M, K] float32 (bf16 values for bf16
    x), the packed matrix at byte ``base`` of the flat uint8 buffer ``mem``,
    scales [G, N] -> y [M, N] float32 (before the cast to x's dtype). ``nt``
    (A tiles per warp) defaults to the source's ``pick_nt``."""
    m = x.shape[0]
    parts = parts or 3
    k9 = _fn("ROUTE_K9")
    nt = nt or _fn("pick_nt")(k9, m, n, kh)
    tiles = _fn("block_tiles")(m, n, nt)
    rng = _fn("split_range")(k9, tiles, kh, nt)
    splits = _fn("split_count")(k9, tiles, kh, nt)
    wcols = WARP_N * nt
    num_g = 2 * kh // group
    vec = vec_of(n, base)
    y = np.zeros((m, n), np.float32)
    for m0 in range(0, m, MT):
        xb = np.zeros((MT, 2 * kh), np.float32)
        xb[:min(MT, m - m0)] = x[m0:m0 + MT]
        xp = x_parts(xb, parts)                  # staged once per block
        for nb in range(0, n, WARPS * wcols):
            partial = []
            for split in range(splits):
                c0 = split * rng
                c1 = min(kh, c0 + rng)
                rows = c1 - c0
                red = np.zeros((MT, WARPS * wcols), np.float32)
                for warp in range(WARPS):
                    nw = nb + warp * wcols
                    ok = nw + np.arange(wcols) < n
                    sc = np.zeros((num_g, wcols), np.float32)
                    sc[:, ok] = scales[:, nw:nw + wcols][:, :ok.sum()]
                    tot = np.zeros((nt, 32, 4), np.float32)
                    plo = np.zeros((nt, parts, 32, 4), np.float32)
                    phi = np.zeros((nt, parts, 32, 4), np.float32)
                    for st in range(-(-rows // STAGE)):
                        tile = warp_rows(mem, base, kh, n, c0, rows, st, nw,
                                         vec, nt)
                        for half in range(2):
                            j = 2 * st + half
                            if j * KSTEP >= rows:
                                break
                            c = c0 + j * KSTEP
                            bl, bh = ([np.stack([xp[p][G, h + c + 2 * T + o]
                                                 for o in (0, 1, 8, 9)], -1)
                                       for p in range(parts)]
                                      for h in (0, kh))
                            for i in range(nt):
                                regs = ldmatrix_regs(
                                    tile[:, 16 * i:16 * i + 16])
                                alo, ahi = unpack(regs[2 * half],
                                                  regs[2 * half + 1])
                                for p in range(parts):  # a chain each
                                    plo[i, p] = mma16(plo[i, p], alo, bl[p])
                                    phi[i, p] = mma16(phi[i, p], ahi, bh[p])
                            c += KSTEP
                            if c % group == 0 or c >= c1:
                                gi = (c - 1) // group
                                for i in range(nt):
                                    cols = [16 * i + 2 * G, 16 * i + 2 * G + 1]
                                    sl = sc[gi][cols]            # [2, 32]
                                    sh = sc[gi + num_g // 2][cols]
                                    s_lo = np.stack([sl[0], sl[0], sl[1],
                                                     sl[1]], -1)
                                    s_hi = np.stack([sh[0], sh[0], sh[1],
                                                     sh[1]], -1)
                                    lo, hi = plo[i, -1], phi[i, -1]
                                    for p in reversed(range(parts - 1)):
                                        lo = (lo + plo[i, p]).astype(np.float32)
                                        hi = (hi + phi[i, p]).astype(np.float32)
                                    tot[i] = (tot[i] + (lo * s_lo + hi * s_hi)
                                              ).astype(np.float32)
                                plo[:] = phi[:] = 0
                    for i in range(nt):
                        cl = warp * wcols + 16 * i + 2 * G
                        red[2 * T, cl] = tot[i, :, 0]
                        red[2 * T + 1, cl] = tot[i, :, 1]
                        red[2 * T, cl + 1] = tot[i, :, 2]
                        red[2 * T + 1, cl + 1] = tot[i, :, 3]
                partial.append(red)
            acc = np.zeros((MT, WARPS * wcols), np.float32)
            for red in partial:                  # block rank order
                acc = (acc + red).astype(np.float32)
            mm, nn = min(MT, m - m0), min(WARPS * wcols, n - nb)
            y[m0:m0 + mm, nb:nb + nn] = acc[:mm, :nn]
    return y


def _inputs(rng, m, k_dim, n, group, layers=None):
    shape = (k_dim, n) if layers is None else (layers, k_dim, n)
    w = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((m, k_dim)).astype(np.float32)
    q, s = i4.quantize_int4(torch.from_numpy(w), group=group)
    assert 2 * (k_dim // 2) // s.shape[-2] == group
    return x, q.numpy(), s.numpy()


def _flat(rng, q, offset):
    """``q``'s bytes at byte ``offset`` of a buffer whose other bytes,
    and 16 past its end, are garbage."""
    mem = rng.integers(0, 256, offset + q.size + 16, dtype=np.uint8)
    mem[offset:offset + q.size] = q.reshape(-1)
    return mem


def _tol(ref):
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


CASES = [  # (M, K, N, group, byte offset of the packed matrix, A tiles a warp)
    (1, 256, 7, 128, 0, None), (3, 384, 130, 64, 0, None),
    (8, 320, 258, 80, 0, None), (9, 256, 1, 128, 5, None),
    (16, 256, 258, 128, 3, None), (8, 384, 128, 64, 0, None),
    (3, 320, 128, 80, 8, None), (8, 256, 258, 128, 0, 4),
    (9, 320, 130, 80, 0, 2), (8, 256, 256, 128, 0, 4),
    (16, 384, 512, 64, 16, 2), (1, 256, 7, 128, 0, 4),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_schedule_equals_the_plain_version(rng, case):
    """Every alignment path (ldmatrix at N % 16 == 0 on an aligned base;
    2-byte and 1-byte reads) at one, two and four A tiles a warp (the
    source's ``pick_nt`` gives the projections one and the tied logits
    four; the others are held here by forcing them)."""
    m, k_dim, n, group, offset, nt = case
    x, q, s = _inputs(rng, m, k_dim, n, group)
    got = kernel_schedule(x, _flat(rng, q, offset), offset, k_dim // 2, n, s,
                          group, nt=nt)
    ref = i4.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


@pytest.mark.parametrize("case", [(8, 320, 258, 80, 0), (9, 384, 7, 64, 0),
                                  (16, 256, 130, 128, 0)], ids=str)
def test_schedule_matches_jax_pallas(rng, case):
    m, k_dim, n, group, offset = case
    x, q, s = _inputs(rng, m, k_dim, n, group)
    ref = np.asarray(J.int4_matmul(jnp.asarray(x), jnp.asarray(q),
                                   jnp.asarray(s), backend="pallas",
                                   interpret=True))
    got = kernel_schedule(x, _flat(rng, q, offset), offset, k_dim // 2, n, s,
                          group)
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


def test_schedule_of_a_stacked_layer_view(rng):
    """A layer of [3, K/2, N] is read in place: its bytes start at layer *
    K/2 * N of the stack (here 2-byte aligned: N = 258), and the chunks
    past its end hold the next layer's bytes, which must not leak in."""
    x, q, s = _inputs(rng, 8, 320, 258, 80, layers=3)
    mem = _flat(rng, q, 0)
    kh = q.shape[1]
    for layer in range(3):
        got = kernel_schedule(x, mem, layer * kh * 258, kh, 258, s[layer], 80)
        ref = i4.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                   torch.from_numpy(s), layer=layer).numpy()
        np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


def test_bf16_x_is_one_part(rng):
    """bf16 x: one product per k16 on x's own values; before the final
    cast the sum equals the float32 product of the bf16 values."""
    x, q, s = _inputs(rng, 8, 384, 130, 64)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    got = kernel_schedule(xb, _flat(rng, q, 0), 0, 192, 130, s, 64, parts=1)
    ref = i4.int4_matmul_plain(torch.from_numpy(xb), torch.from_numpy(q),
                               torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


def test_one_bf16_part_is_a_hundred_times_worse_than_three(rng):
    x, q, s = _inputs(rng, 8, 256, 130, 128)
    mem = _flat(rng, q, 0)
    ref = i4.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s)).numpy().astype(np.float64)
    e3 = np.abs(kernel_schedule(x, mem, 0, 128, 130, s, 128) - ref).max()
    e1 = np.abs(kernel_schedule(x, mem, 0, 128, 130, s, 128, parts=1)
                - ref).max()
    assert e1 > 100 * e3


def test_three_parts_keep_float32_and_unpack_is_exact(rng):
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)
         ).astype(np.float32)
    hi, mid, lo = x_parts(v, 3)
    assert np.all(bf16(hi) == hi) and np.all(bf16(mid) == mid)
    np.testing.assert_array_equal((hi.astype(np.float64) + mid + lo)
                                  .astype(np.float32), v)
    # bytes (b0, b1, b2, b3) of each register: a0, a1 = nib(b0), nib(b2)
    # (column 2g, rows 2t, 2t + 1), a2, a3 = nib(b1), nib(b3) (column
    # 2g + 1); a4..a7 the same from the register of rows 8-15; minus 8
    b = rng.integers(0, 256, (2, 32, 4)).astype(np.uint32)
    r0, r1 = (sum(b[i, :, j] << (8 * j) for j in range(4)) for i in (0, 1))
    lo_a, hi_a = unpack(r0, r1)
    order = [0, 2, 1, 3]
    want_lo = np.concatenate([b[0][:, order] & 0xF, b[1][:, order] & 0xF], 1)
    want_hi = np.concatenate([b[0][:, order] >> 4, b[1][:, order] >> 4], 1)
    np.testing.assert_array_equal(lo_a, want_lo - 8.0)
    np.testing.assert_array_equal(hi_a, want_hi - 8.0)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_row_reads_cover_every_alignment(rng, nt):
    """Each warp's 16 nt columns of a row -- the swizzled chunks through
    ldmatrix, or the nt + 1 aligned chunks read at the row's offset -- are
    the row's bytes, at every offset and width."""
    for n in (1, 7, 130, 258, 1280):
        for base in range(16):
            kh = 32
            mem = rng.integers(0, 256, base + kh * n + 16, dtype=np.uint8)
            vec = vec_of(n, base)
            for nw in range(0, n, WARP_N * nt):
                tile = warp_rows(mem, base, kh, n, 0, kh, 0, nw, vec, nt)
                width = min(WARP_N * nt, n - nw)
                want = np.stack([mem[base + r * n + nw:
                                     base + r * n + nw + width]
                                 for r in range(32)])
                np.testing.assert_array_equal(tile[:, :width], want)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_swizzle_keeps_ldmatrix_free_of_bank_conflicts(nt):
    """Each 8-row matrix of an ldmatrix reads 8 chunks of 16 bytes that
    fall on 32 distinct banks (rows 16 nt bytes apart), and every row's
    chunks are a permutation."""
    swz = _fn("swizzle")
    for i in range(nt):
        for j in range(4):
            banks = set()
            for r in range(8 * j, 8 * j + 8):
                start = (r * 16 * nt + 16 * swz(r, i, nt)) // 4 % 32
                banks |= {start + b for b in range(4)}
            assert len(banks) == 32
    for r in range(32):
        assert sorted(swz(r, c, nt) for c in range(nt)) == list(range(nt))


@pytest.mark.parametrize("kh,group", [(640, 128), (2560, 128), (64, 16),
                                      (160, 80), (8192, 128), (8320, 128),
                                      (640, 8), (96, 32), (120, 40)])
def test_body_table_is_the_source_rule(kh, group):
    assert i4.BODIES["mma"][1](kh, group) == bool(_fn("takes")(kh, group))
    body = i4.int4_body(2 * kh, group)
    assert body == ("mma" if _fn("takes")(kh, group) else "split_half")


@pytest.mark.parametrize("m,kh,n", [(8, 640, 1280), (8, 640, 5120),
                                    (8, 2560, 1280), (8, 640, 51866),
                                    (1, 640, 1280), (16, 640, 1280),
                                    (256, 2560, 5120), (8, 4096, 7),
                                    (8, 4096, 51866), (16, 2048, 20000),
                                    (8, 8192, 1280)])
def test_split_plan_fills_the_card_and_fits(m, kh, n):
    k9 = _fn("ROUTE_K9")
    nt = _fn("pick_nt")(k9, m, n, kh)
    tiles = _fn("block_tiles")(m, n, nt)
    rng = _fn("split_range")(k9, tiles, kh, nt)
    splits = _fn("split_count")(k9, tiles, kh, nt)
    assert nt in (1, 2, 4) and (nt == 1 or tiles * splits >= 132)
    assert rng % STAGE == 0 and rng <= 512 // nt and 1 <= splits <= 16
    assert (splits - 1) * rng < kh <= splits * rng
    assert _fn("grid_blocks")(k9, m, n, kh, nt) == tiles * splits
    decode = {(8, 640, 1280): 1, (8, 640, 5120): 4, (8, 2560, 1280): 2,
              (8, 640, 51866): 4}                # the widths the card chose
    if (m, kh, n) in decode:
        assert nt == decode[(m, kh, n)] and tiles * splits >= 132
    smem = _fn("smem_bytes")
    for parts in (1, 3):
        for vec in (16, 2, 1):
            for group in (16, 64, 80, 128):
                assert smem(parts, vec, nt, rng, group) <= 232448


def test_launcher_refuses_cpu_tensors_and_counts_apart(rng):
    x, q, s = _inputs(rng, 8, 256, 128, 128)
    xt, qt, st = map(torch.from_numpy, (x, q, s))
    before = (i4.int4_matmul_mma_cuda.launches, i4.int4_matmul_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        i4.int4_matmul_mma_cuda(xt, qt, st)
    with pytest.raises(ValueError, match="CUDA"):
        i4.int4_matmul_cuda(xt, qt, st)
    assert (i4.int4_matmul_mma_cuda.launches,
            i4.int4_matmul_cuda.launches) == before
    assert KERNELS["int4_matmul_mma"] == (i4.int4_matmul_mma_cuda,
                                          i4.int4_matmul_plain)
    assert {KERNELS[c][0] for c, _ in i4.BODIES.values()} == {
        i4.int4_matmul_mma_cuda, i4.int4_matmul_cuda}


class _OnCard:
    """Stands in for a CUDA x of ``shape`` in ``int4_matmul``'s dispatch,
    which reads only where x lies and its shape."""
    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        return int(np.prod(self.shape))


@pytest.mark.parametrize("k_dim,group,body", [
    (1280, 128, "mma"), (5120, 128, "mma"), (1280, 80, "mma"),
    (1280, 40, "split_half"), (17408, 128, "split_half")])
def test_entry_point_calls_the_one_body_the_table_gives(monkeypatch, k_dim,
                                                        group, body):
    """On the card ``int4_matmul`` calls one body's wrapper, the one
    ``int4_body`` names, and that wrapper alone checks the operands."""
    calls = []
    for name, attr in (("mma", "int4_matmul_mma_cuda"),
                       ("split_half", "int4_matmul_cuda")):
        monkeypatch.setattr(i4, attr,
                            lambda *a, name=name, **k: calls.append(name))
    i4.int4_matmul(_OnCard(8, k_dim), None, torch.zeros(k_dim // group, 3))
    assert calls == [body] == [i4.int4_body(k_dim, group)]


def test_library_is_bound_with_the_c_prototype():
    src = (CSRC / SRC).read_text()
    assert native.KERNEL_SOURCES["int4_matmul_mma"] == SRC
    proto = re.search(r"int int4_matmul_mma\(([^)]*)\)", src)[1]
    argtypes, _ = native.SIGNATURES["int4_matmul_mma"]["int4_matmul_mma"]
    assert len(argtypes) == len(proto.split(","))
    assert "audax/ops/int4_matmul.py:_int4_kernel" in " ".join(src.split())
