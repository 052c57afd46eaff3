"""P5 v1's and the word kernel's (P2, P3) tensor-core bodies
(``csrc/int4_matmul_mma.cu``: ``ROUTE_V1`` and the word route,
``int4word_kernel``, on K9's skeleton) on the CPU, where nothing can launch.

* v1: each bf16 pair by one mask and magic, ``(r >> s) & 0x000F000F |
  0x43004300`` less 136 (s = 0, 8: the low nibbles of columns 2g, 2g + 1;
  4, 12: the high ones), equals K9's byte-permute unpack bit for bit; K9's
  schedule (``test_torch_int4_sm90.kernel_schedule``, every alignment path)
  run with it equals the plain version and the JAX tool's ``_kernel_v1``
  in interpret mode.
* The word route transcribed into numpy lane by lane, every 16-column A
  tile at once: the plan read from the source (``csrc_constexpr``); each
  warp's copy of a k16 step's 16 word rows (16-byte chunks at
  ``wswizzle``'s places, or the 4 nt + 1 aligned chunks that cover an
  unaligned row, the words past the matrix garbage) and the lanes' 8-byte
  (or two 4-byte) reads of columns 2g, 2g + 1 at word rows t + 4e; the
  byte permutes 0x5410 / 0x7632 and each plane's mask and magic; x's B
  fragments at the same word rows of each plane, float32 x in three bf16
  parts; the m16n8k16 products through the fragment maps, each plane's
  parts summed from zero, added smallest first, scaled by the plane's own
  group (read from the staged scales as the kernel indexes them) and added
  in float32; the blocks of a cluster summed in block order. At P2's
  groups (dividing K/8) and P3's (straddling planes), M in {1, 8, 9},
  aligned and ragged N, an unaligned base and nt 1, 2, 4 it equals the
  plain versions within 1e-5 of the largest output (bf16 x: within one
  bf16 step of each element beside that), and the JAX tools'
  ``int4_matmul_v2(interpret=True)`` and ``plane_matmul`` (interpret mode).
* The swizzle puts each half warp's 8-byte reads on 32 distinct banks.
* The tables (``V1_BODIES``, ``WORD_BODIES``, ``PLANE_BODIES``) are the
  source's ``takes`` / ``takes_word``; every plan fits a block and fills
  the card at the tools' shapes; the libraries are bound with the C
  prototypes, built from their ``#if`` branches; the wrappers refuse CPU
  tensors and count apart; the entry points call the one body the tables
  give.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audax_torch.ops import int4_matmul as i4
from audax_torch.ops import native
from audax_torch.tools import probe_kernels
from audax_torch.tools import int4_layout_ab as lab
from audax_torch.tools import int4_plane_probe as pp
from audax_torch.tools import int4_unpack_probe as up

from . import test_torch_int4_sm90 as k9
from .csrc_constexpr import CSRC, constexpr_function
from .test_torch_int4_probe_sm90 import mma16
from .test_torch_int4_sm90 import bf16, bf16_pair, byte_perm, x_parts

SRC = "int4_matmul_mma.cu"
REPO = Path(__file__).resolve().parents[2]
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
MT, KSTEP, PLANES = 8, 16, 8
SMEM_LIMIT = 232448


def _fn(name):
    return constexpr_function(SRC, name)


def nib_pair(r, s):
    """``nib_pair``: the bf16 pair of (r >> s) & 0x000F000F | 0x43004300,
    less 136 each: (nib at bit s, nib at bit 16 + s) - 8."""
    v = ((np.asarray(r, np.uint32) >> np.uint32(s)) & np.uint32(0x000F000F)
         ) | np.uint32(0x43004300)
    lo, hi = bf16_pair(v)
    return lo - 136, hi - 136


def unpack_v1(r0, r1):
    """``unpack_v1``: the A fragments [.., 8] of the low and the high
    nibbles, one mask and magic a pair (the order of ``k9.unpack``)."""
    out = []
    for shift in (0, 4):
        vals = []
        for r in (r0, r1):
            for s in (shift, shift + 8):          # column 2g, 2g + 1
                vals += list(nib_pair(r, s))
        out.append(np.stack(vals, -1).astype(np.float32))
    return out


# ---- P5 v1 -------------------------------------------------------------------

def test_v1_pairs_are_k9_unpack_bit_for_bit():
    rng = np.random.default_rng(0)
    regs = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(
        np.uint32)
    regs[:, :256] = np.arange(256, dtype=np.uint32) * 0x01010101
    for got, want in zip(unpack_v1(*regs), k9.unpack(*regs)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


V1_CASES = [  # (M, K, N, group, byte offset of the packed matrix, nt)
    (8, 256, 256, 128, 0, None), (9, 320, 258, 80, 0, 2),
    (1, 256, 7, 64, 5, None), (16, 384, 130, 64, 3, 4),
    (8, 256, 512, 128, 16, 1), (3, 256, 128, 128, 8, 4),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", V1_CASES, ids=str)
def test_v1_schedule_equals_the_plain_version(monkeypatch, rng, dtype, case):
    """K9's schedule with v1's unpack: every alignment path, nt 1, 2, 4."""
    monkeypatch.setattr(k9, "unpack", unpack_v1)
    m, k_dim, n, group, offset, nt = case
    x, q, s = k9._inputs(rng, m, k_dim, n, group)
    if dtype == "bf16":
        x = _bf16_values(x)
    got = k9.kernel_schedule(x, k9._flat(rng, q, offset), offset, k_dim // 2,
                             n, s, group, parts=1 if dtype == "bf16" else 3,
                             nt=nt)
    xt = torch.from_numpy(x)
    ref = up.unpack_v1_plain(xt.bfloat16() if dtype == "bf16" else xt,
                             torch.from_numpy(q), torch.from_numpy(s))
    _check(got, ref.float().numpy(), dtype)


# ---- the word route, transcribed ---------------------------------------------

def word_plan(m, n, kw, nt=None):
    """(nt, word rows a split, splits) as the launcher picks them."""
    word = _fn("ROUTE_WORD")
    nt = nt or _fn("pick_nt")(word, m, n, kw)
    tiles = _fn("block_tiles")(m, n, nt)
    return (nt, _fn("split_range")(word, tiles, kw, nt),
            _fn("split_count")(word, tiles, kw, nt))


def step_words(mem, base, kw, n, c0, j, nt, vec):
    """u [U, 32, 4, 2]: the words lane (g, t) of each 16-column tile u
    reads for k16 step j of a split at word row c0 -- word rows t + 4e of
    the step, columns 2g and 2g + 1 of the tile -- from its warp's copy in
    shared memory. ``mem``: flat uint32 words, the matrix [kw, n] at word
    ``base``, the rest garbage. VEC 16: the row's chunks stored at
    ``wswizzle``(row in the range), read at ``wswizzle``(row in the step);
    VEC 4: the 4 nt + 1 aligned chunks that cover the row (those at or past
    the matrix's end zero-filled), read at the row's offset."""
    swz = _fn("wswizzle")
    warps = -(-n // (16 * nt))
    out = np.zeros((warps * nt, 32, 4, 2), np.uint32)
    end = 4 * (base + kw * n)                    # bytes
    for wp in range(warps):
        nw = 16 * nt * wp
        for r in range(16):
            rr = KSTEP * j + r
            addr = 4 * (base + (c0 + rr) * n + nw)
            t, e = r % 4, r // 4
            if vec == 16:
                stored = np.zeros((4 * nt, 4), np.uint32)
                for ch in range(4 * nt):
                    if nw + 4 * ch < n:
                        stored[swz(rr, ch, nt)] = mem[addr // 4 + 4 * ch:
                                                      addr // 4 + 4 * ch + 4]
                for i in range(nt):
                    for g in range(8):
                        at = stored[swz(r, 4 * i + g // 2, nt)]
                        out[wp * nt + i, 4 * g + t, e] = at[2 * (g % 2):
                                                            2 * (g % 2) + 2]
                continue
            a = addr % 16
            copy = np.zeros(4 * (4 * nt + 1), np.uint32)
            for ch in range(4 * nt + 1):
                src = addr - a + 16 * ch
                if src < end:
                    copy[4 * ch:4 * ch + 4] = mem[src // 4:src // 4 + 4]
            for i in range(nt):
                for g in range(8):
                    at = a // 4 + 16 * i + 2 * g
                    out[wp * nt + i, 4 * g + t, e] = copy[at:at + 2]
    return out


def a_registers(u):
    """``load_words``' permutes: x[q][h] [U, 32] of the step's words u."""
    return [[byte_perm(u[..., 2 * (q // 2), q % 2],
                       u[..., 2 * (q // 2) + 1, q % 2], sel)
             for sel in (0x5410, 0x7632)] for q in range(4)]


def plane_fragment(x_regs, p):
    """Plane p's A values [U, 32, 8] (a0 .. a7) from the permuted words."""
    vals = []
    for q in range(4):
        vals += list(nib_pair(x_regs[q][p // 4], 4 * (p % 4)))
    return np.stack(vals, -1).astype(np.float32)


def word_schedule(x, words, s, group, parts, nt=None, base=0, seed=0):
    """``int4word_kernel`` in numpy: x [M, K] float32 (bf16 values with
    ``parts`` 1), words [K/8, N] int32 at word ``base`` of a garbage
    buffer, scales [K/group, N] -> y [M, N] float32 (before the cast)."""
    m, k_dim = x.shape
    kw, n = words.shape
    nt, rng_, splits = word_plan(m, n, kw, nt)
    vec = 16 if n % 4 == 0 and base % 4 == 0 else 4
    mem = np.random.default_rng(seed).integers(
        0, 2 ** 32, base + kw * n + 4, dtype=np.uint64).astype(np.uint32)
    mem[base:base + kw * n] = words.view(np.uint32).reshape(-1)
    u_tiles = -(-n // (16 * nt)) * nt
    cols = 16 * np.arange(u_tiles)[:, None] + 2 * G       # column 2g
    ngw = _fn("wgroups")(rng_, group)
    y = np.zeros((m, n), np.float32)
    for m0 in range(0, m, MT):
        xb = np.zeros((MT, k_dim), np.float32)
        xb[:min(MT, m - m0)] = x[m0:m0 + MT]
        xp = x_parts(xb, parts)
        partial = []
        for split in range(splits):
            c0, c1 = split * rng_, min(kw, split * rng_ + rng_)
            # the scales as staged: [plane][group of the range][column]
            ss = np.zeros((PLANES, ngw, 16 * u_tiles + 2), np.float32)
            for p in range(PLANES):
                g0 = int(div_by(p * kw + c0, group))
                g1 = int(div_by(p * kw + c1 - 1, group))
                for gi in range(min(ngw, g1 - g0 + 1)):
                    ss[p, gi, :n] = s[g0 + gi]
            tot = np.zeros((u_tiles, 32, 4), np.float32)
            for j in range((c1 - c0) // KSTEP):
                regs = a_registers(step_words(mem, base, kw, n, c0, j, nt,
                                              vec))
                c = c0 + KSTEP * j
                for p in range(PLANES):
                    gi = int(div_by(p * kw + c, group)
                             - div_by(p * kw + c0, group))
                    a = plane_fragment(regs, p)
                    acc = [mma16(np.zeros((u_tiles, 32, 4), np.float32), a,
                                 np.stack([xp[q][G, p * kw + c + T + 4 * e]
                                           for e in range(4)], -1))
                           for q in range(parts)]
                    tile = acc[-1]
                    for q in reversed(range(parts - 1)):
                        tile = (tile + acc[q]).astype(np.float32)
                    sc = np.stack([ss[p, gi][cols], ss[p, gi][cols],
                                   ss[p, gi][cols + 1], ss[p, gi][cols + 1]],
                                  -1)
                    tot = (tot + tile * sc).astype(np.float32)
            partial.append(tot)
        acc = np.zeros((u_tiles, 32, 4), np.float32)
        for tot in partial:                       # block rank order
            acc = (acc + tot).astype(np.float32)
        blk = np.zeros((MT, 16 * u_tiles), np.float32)
        for q in range(4):
            blk[2 * T + q % 2, cols + q // 2] = acc[..., q]
        mm = min(MT, m - m0)
        y[m0:m0 + mm] = blk[:mm, :n]
    return y


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _check(got, ref, dtype):
    """float32: within 1e-5 of the largest output; bf16 (``got`` the
    schedule's float32 output, cast here): within one bf16 step of each
    element beside that."""
    tol = 1e-5 * float(np.abs(ref).max()) + 1e-7
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
        return
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(bf16(got) - ref) <= step + tol)


def _words(seed, m, k_dim, n, group):
    """x [M, K], words [K/8, N] and scales at exactly ``group``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k_dim, n)).astype(np.float32) / k_dim ** 0.5
    x = rng.standard_normal((m, k_dim)).astype(np.float32)
    word, s = lab.quantize_words(torch.from_numpy(w), group)
    return x, word.numpy(), s.numpy()


def _plain(x, word, s, dtype):
    xt = torch.from_numpy(x)
    return lab.int4_matmul_v2_plain(
        xt.bfloat16() if dtype == "bf16" else xt, torch.from_numpy(word),
        torch.from_numpy(s)).float().numpy()


WORD_CASES = [  # (M, K, N, group, word offset of the matrix, nt)
    (8, 256, 128, 32, 0, None),      # P2: the group divides K/8 = 32
    (9, 384, 130, 16, 0, None),      # ragged N: the covering chunks
    (1, 512, 64, 64, 0, 4),
    (8, 640, 96, 128, 0, 2),         # P3: K/8 = 80, group 128 straddles
    (3, 384, 7, 96, 0, 1),           # P3: K/8 = 48, group 96
    (8, 256, 256, 32, 1, 2),         # unaligned base: 4-byte reads
    (16, 1024, 200, 256, 0, 4),      # a group over two whole planes
    (9, 1280, 64, 128, 0, None),     # P3's K and group (plane 160)
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", WORD_CASES, ids=str)
def test_word_schedule_equals_the_plain_version(dtype, case):
    m, k_dim, n, group, base, nt = case
    x, word, s = _words(m + k_dim + n, m, k_dim, n, group)
    if dtype == "bf16":
        x = _bf16_values(x)
    got = word_schedule(x, word, s, group, 1 if dtype == "bf16" else 3,
                        nt=nt, base=base)
    _check(got, _plain(x, word, s, dtype), dtype)


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("group", [32, 128])
def test_word_schedule_at_every_warp_width(nt, group):
    """P2's group 32 and P3's straddling group 128 at K = 1280 (plane 160),
    float32 x: nt changes the plan (the block's 64 nt columns), not y."""
    x, word, s = _words(nt + group, 9, 1280, 136, group)
    got = word_schedule(x, word, s, group, 3, nt=nt)
    _check(got, _plain(x, word, s, "f32"), "f32")


@pytest.mark.parametrize("k_dim,n,group", [(1280, 5120, 32),
                                           (1280, 5120, 128)], ids=str)
def test_word_schedule_at_the_tools_shape(k_dim, n, group):
    """P2 (group 32) and P3 (group 128) at [8, 1280] x [1280, 5120], bf16 x,
    on the plan the launcher picks there (nt 4)."""
    x, word, s = _words(group, 8, k_dim, n, group)
    x = _bf16_values(x)
    assert word_plan(8, n, k_dim // 8)[0] == 4
    got = word_schedule(x, word, s, group, 1)
    _check(got, _plain(x, word, s, "bf16"), "bf16")


def test_plane_fragment_is_each_planes_nibbles():
    """The permutes and each plane's mask and magic give A value (row g =
    column 2g, k 2t + e) = nib_p(word at column 2g, word row t + 4e) - 8,
    and the same at column 2g + 1 (A row g + 8) and k + 8 (rows + 8)."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2 ** 32, (1, 32, 4, 2), dtype=np.uint64).astype(
        np.uint32)
    regs = a_registers(u)
    for p in range(PLANES):
        a = plane_fragment(regs, p)[0]
        nib = ((u[0] >> np.uint32(4 * p)) & 0xF).astype(np.float32) - 8
        for v, (e, col) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1),
                                      (2, 0), (3, 0), (2, 1), (3, 1)]):
            np.testing.assert_array_equal(a[:, v], nib[:, e, col])


def div_by(a, d):
    """``div_by``: a * RN(1 / d) in float32, truncated, corrected by one."""
    a = np.asarray(a, np.int64)
    inv = np.float32(1) / np.float32(d)
    q = np.trunc(a.astype(np.float32) * inv).astype(np.int64)
    q -= q * d > a
    q += (q + 1) * d <= a
    return q


@pytest.mark.parametrize("d", [1, 3, 7, 10, 16, 40, 96, 128, 255, 4096])
def test_div_by_is_integer_division(d):
    """Every a below 2^17 and a sample up to 2^22, the word route's domain
    (K-rows 8 kw + c below 2^15, entries / 32 over steps below 2^12)."""
    a = np.concatenate([np.arange(2 ** 17), np.random.default_rng(d)
                        .integers(0, 2 ** 22, 2 ** 16)])
    np.testing.assert_array_equal(div_by(a, d), a // d)


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_swizzle_puts_each_half_warp_on_32_banks(nt):
    """Each 8-byte read of a step (word rows t + 4e, columns 2g, 2g + 1 of
    tile i) by a half warp (lanes 16h .. 16h + 15) touches 32 distinct
    4-byte banks, and the copy and the read agree on every chunk's place."""
    swz = _fn("wswizzle")
    rowb = _fn("wrow_bytes")(16, nt)
    for j in range(3):
        for r in range(16):
            for ch in range(4 * nt):
                assert swz(r, swz(KSTEP * j + r, ch, nt), nt) == ch
    for e in range(4):
        for i in range(nt):
            for h in range(2):
                banks = set()
                for lane in range(16 * h, 16 * h + 16):
                    g, t = lane // 4, lane % 4
                    r = t + 4 * e
                    at = (rowb * r + 16 * swz(r, 4 * i + g // 2, nt)
                          + 8 * (g % 2))
                    banks |= {(at // 4) % 32, (at // 4 + 1) % 32}
                assert len(banks) == 32


# ---- the JAX tools in interpret mode -----------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jt():
    return {n: _jax_tool(n) for n in ("int4_layout_ab", "int4_plane_probe",
                                      "int4_unpack_probe")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _xj(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k_dim,n", [(8, 256, 256), (9, 512, 130)],
                         ids=str)
def test_word_schedule_matches_int4_matmul_v2(jt, dtype, m, k_dim, n):
    x, word, s = _words(m + n, m, k_dim, n, lab.fit_group_v2(k_dim))
    if dtype == "bf16":
        x = _bf16_values(x)
    ref = np.asarray(jt["int4_layout_ab"].int4_matmul_v2(
        _xj(x, dtype), jnp.asarray(word), jnp.asarray(s), interpret=True),
        np.float32)
    got = word_schedule(x, word, s, k_dim // s.shape[0],
                        1 if dtype == "bf16" else 3)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k_dim,group", [(1280, 128), (384, 64)], ids=str)
def test_word_schedule_matches_plane_matmul(jt, interpret, dtype, k_dim,
                                            group):
    """P3's straddling groups (K/8 160 or 48, groups 128 or 64); the JAX
    kernel takes N in whole blocks of its block_n (128)."""
    rng = np.random.default_rng(k_dim)
    w = rng.standard_normal((k_dim, 256)).astype(np.float32)
    x = rng.standard_normal((8, k_dim)).astype(np.float32)
    if dtype == "bf16":
        x = _bf16_values(x)
    jw, js, g = jt["int4_plane_probe"].quantize_int4_planes(
        jnp.asarray(w), group=group)
    assert g == group and (k_dim // 8) % g
    word, s = np.array(jw), np.array(js)
    ref = np.asarray(jt["int4_plane_probe"].plane_matmul(
        _xj(x, dtype), jw, js, group=g, block_n=128), np.float32)
    got = word_schedule(x, word, s, g, 1 if dtype == "bf16" else 3)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_v1_schedule_matches_jax_pallas(jt, interpret, monkeypatch, rng,
                                        dtype):
    monkeypatch.setattr(k9, "unpack", unpack_v1)
    x, q, s = k9._inputs(rng, 8, 256, 256, 128)
    if dtype == "bf16":
        x = _bf16_values(x)
    tool = jt["int4_unpack_probe"]
    ref = np.asarray(tool.run_variant(tool._kernel_v1, _xj(x, dtype),
                                      jnp.asarray(q), jnp.asarray(s)),
                     np.float32)
    got = k9.kernel_schedule(x, q.reshape(-1), 0, 128, 256, s, 128,
                             parts=1 if dtype == "bf16" else 3)
    _check(got, ref, dtype)


# ---- tables, plans, bindings, routing ----------------------------------------

@pytest.mark.parametrize("kw,group", [(160, 32), (160, 128), (640, 128),
                                      (160, 40), (168, 64), (144, 128),
                                      (4096, 128), (4112, 16), (16, 16),
                                      (48, 96), (160, 8), (128, 256)])
def test_body_tables_are_the_source_rules(kw, group):
    takes, takes_word = _fn("takes"), _fn("takes_word")
    for mod, table, body in ((lab, lab.WORD_BODIES, lab.word_body),
                             (pp, pp.PLANE_BODIES, lab.word_body)):
        assert table["mma"][1](kw, group) == bool(takes_word(kw, group))
        assert body(8 * kw, group) == ("mma" if takes_word(kw, group)
                                       else "cuda_core")
    kh = 4 * kw                                  # the same K, split-half
    if (2 * kh) % group or (2 * kh // group) % 2:
        return                                   # no split-half layout
    assert up.V1_BODIES["mma"][1](kh, group) == bool(takes(kh, group))
    assert up.v1_body(2 * kh, group) == ("mma" if takes(kh, group)
                                         else "split_half")


@pytest.mark.parametrize("m,kw,n", [(8, 160, 5120), (8, 640, 1280),
                                    (8, 160, 1280), (9, 160, 1287),
                                    (1, 16, 7), (256, 160, 1280),
                                    (8, 4096, 1280), (8, 1024, 51866)])
def test_every_word_plan_fits_a_block(m, kw, n):
    smem = _fn("word_smem_bytes")
    for nt in (None, 1, 2, 4):
        if nt and kw > 16 * 256 // nt:
            continue
        nt_, rng_, splits = word_plan(m, n, kw, nt)
        assert rng_ % KSTEP == 0 and splits <= 16
        assert rng_ <= _fn("max_range")(_fn("ROUTE_WORD"), nt_) and rng_ * splits >= kw
        for f32 in (0, 1):
            for vec in (16, 4):
                for group in (16, 32, 128):
                    assert smem(f32, vec, nt_, rng_, group) <= SMEM_LIMIT
    route = _fn("route_smem_bytes")
    assert route(3, 1, 16, 4, 128, 128) == route(0, 1, 16, 4, 128, 128)


@pytest.mark.parametrize("kw,group", [(160, 32), (160, 128), (640, 128),
                                      (48, 96), (128, 256), (4096, 16),
                                      (4096, 128), (144, 48)])
def test_word_smem_holds_every_index(kw, group):
    """Each region of ``word_smem_bytes`` holds the highest index the
    kernel reads or writes in it, at every split of the plan: x's uint2
    [plane][k16 step][part][lane], a warp's word rows (ROWB bytes each),
    a warp's scales [plane][group][16 nt] (every plane's groups of the
    range fit ``wgroups``), the cluster's slots."""
    for nt in (1, 2, 4):
        if kw > 16 * 256 // nt:
            continue
        for m, n in ((8, 5120), (8, 1287), (1, 64)):
            _, rng_, splits = word_plan(m, n, kw, nt)
            ngw = _fn("wgroups")(rng_, group)
            for f32 in (0, 1):
                parts = 1 + 2 * f32
                ksteps = rng_ // KSTEP
                assert _fn("wx_bytes")(parts, rng_) >= 8 * (
                    ((PLANES - 1) * ksteps + ksteps - 1) * parts * 32
                    + (parts - 1) * 32 + 31 + 1)
                for vec in (16, 4):
                    rowb = _fn("wrow_bytes")(vec, nt)
                    assert rowb >= 64 * nt + (0 if vec == 16 else 12)
                    assert _fn("ww_bytes")(vec, nt, rng_) == 4 * rng_ * rowb
            for split in range(splits):
                c0, c1 = split * rng_, min(kw, split * rng_ + rng_)
                for p in range(PLANES):
                    ng = (p * kw + c1 - 1) // group - (p * kw + c0) // group
                    assert ng + 1 <= ngw
            assert _fn("wscale_floats")(rng_, group, nt) == (
                PLANES * ngw * 16 * nt)


def test_word_plan_fills_the_card_at_the_tools_shapes():
    """nt 4 at 1280 -> 5120 (P2, P3), 2 at 5120 -> 1280, 1 at 1280^2: the
    widest tile that leaves every SM a block."""
    for (m, kw, n), want in (((8, 160, 5120), 4), ((8, 640, 1280), 2),
                             ((8, 160, 1280), 1)):
        nt, _, splits = word_plan(m, n, kw)
        assert nt == want
        assert _fn("block_tiles")(m, n, nt) * splits >= 132


@pytest.mark.parametrize("lib,fn,macro,old", [
    ("int4_unpack_v1_mma", "int4_unpack_v1_mma", "AUDAX_INT4_V1",
     ("int4_unpack_variants", "int4_unpack_v1")),
    ("int4_word_matmul_mma", "int4_word_matmul_mma", "AUDAX_INT4_WORD",
     ("int4_word_matmul", "int4_word_matmul"))])
def test_libraries_are_bound_with_the_c_prototypes(lib, fn, macro, old):
    src = (CSRC / SRC).read_text()
    assert native.KERNEL_SOURCES[lib] == SRC
    assert native.DEFINES[lib] == (f"-D{macro}",)
    proto = re.search(rf"int {fn}\(([^)]*)\)", src)[1]
    argtypes, _ = native.SIGNATURES[lib][fn]
    assert len(argtypes) == len(proto.split(","))
    branch = src[src.index(f"defined({macro})"):]
    assert branch.index(f"int {fn}(") < branch.index("#e")
    old_src = (CSRC / native.KERNEL_SOURCES[old[0]]).read_text()
    old_proto = re.search(rf"int {old[1]}\(([^)]*)\)", old_src)[1]
    assert len(native.SIGNATURES[old[0]][old[1]][0]) == len(
        old_proto.split(","))


def test_wrappers_refuse_cpu_tensors_and_count_apart():
    x = torch.zeros(2, 256)
    q, s = i4.quantize_int4(torch.zeros(256, 128))
    word, ws = lab.quantize_int4_v2(torch.zeros(256, 128))
    calls = (lambda: up.unpack_v1_mma_cuda(x, q, s),
             lambda: lab.int4_matmul_v2_mma_cuda(x, word, ws),
             lambda: pp.plane_matmul_mma_cuda(x, word, ws, group=32))
    wrappers = (up.unpack_v1_mma_cuda, lab.int4_matmul_v2_mma_cuda,
                pp.plane_matmul_mma_cuda)
    before = [w.launches for w in wrappers]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [w.launches for w in wrappers] == before
    kernels = probe_kernels()
    for table, cuda, first in (
            (up.V1_BODIES, up.unpack_v1_mma_cuda, up.unpack_v1_cuda),
            (lab.WORD_BODIES, lab.int4_matmul_v2_mma_cuda,
             lab.int4_matmul_v2_cuda),
            (pp.PLANE_BODIES, pp.plane_matmul_mma_cuda,
             pp.plane_matmul_cuda)):
        assert [kernels[c][0] for c, _ in table.values()] == [cuda, first]
    assert kernels["int4_unpack_v1_mma"][1] is up.unpack_v1_plain
    assert kernels["int4_word_matmul_mma"][1] is lab.int4_matmul_v2_plain
    assert kernels["int4_plane_matmul_mma"][1] is pp.plane_matmul_plain


class _OnCard:
    """Stands in for a CUDA x of ``shape`` in the entry points' dispatch,
    which reads only where x lies and its shape."""
    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("k_dim,group", [(1280, 32), (1280, 128),
                                         (5120, 128), (1280, 40),
                                         (1344, 64), (40960, 128)])
def test_entry_points_call_the_one_body_the_tables_give(monkeypatch, k_dim,
                                                        group):
    calls = []
    for mod, attr, name in ((up, "unpack_v1_mma_cuda", "v1 mma"),
                            (up, "unpack_v1_cuda", "v1 split_half"),
                            (lab, "int4_matmul_v2_mma_cuda", "p2 mma"),
                            (lab, "int4_matmul_v2_cuda", "p2 cuda_core"),
                            (pp, "plane_matmul_mma_cuda", "p3 mma"),
                            (pp, "plane_matmul_cuda", "p3 cuda_core")):
        monkeypatch.setattr(mod, attr,
                            lambda *a, name=name, **k: calls.append(name))
    word = torch.zeros(k_dim // 8, 3)
    scales = torch.zeros(k_dim // group, 3)
    if k_dim % 2 == 0 and (k_dim // group) % 2 == 0:
        up.run_variant("v1", _OnCard(8, k_dim), None, scales)
    lab.int4_matmul_v2(_OnCard(8, k_dim), word, scales)
    pp.plane_matmul(_OnCard(8, k_dim), word, scales, group=group)
    want = [f"p2 {lab.word_body(k_dim, group)}",
            f"p3 {lab.word_body(k_dim, group)}"]
    if (k_dim // group) % 2 == 0:
        want.insert(0, f"v1 {up.v1_body(k_dim, group)}")
    assert calls == want
    if up.v1_body(k_dim, group) != "mma":
        with pytest.raises(ValueError, match="block_n"):
            up.run_variant("v1", _OnCard(8, k_dim), None, scales,
                           block_n=128)
