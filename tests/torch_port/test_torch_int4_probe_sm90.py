"""P5 v2's and P4's tensor-core bodies (``csrc/int4_matmul_mma.cu``,
``ROUTE_V2`` and ``ROUTE_W4A8`` on K9's skeleton) on the CPU, where nothing
can launch.

* Both schedules transcribed into numpy lane by lane, every A tile of the
  block's columns at once: the split plan read from the source
  (``csrc_constexpr``); the ``ldmatrix.x4.trans`` register of each lane
  over 32 packed rows (the copy plan and its alignment paths are K9's,
  held by ``test_torch_int4_sm90.py``); then
  - v2 in bf16: K9's unpack (mask, byte permute under 0x43, bf16 minus
    136), one ``mul.rn.bf16x2`` by the bf16-rounded scale of the pair's
    column, m16n8k16 products through the fragment maps, one chain per
    half over all of K;
  - v2 in float32: the register of an 8-row step read as a TF32 A fragment
    (byte k = a_k: packed rows 2t, 2t + 1 at k slots t, t + 4), each
    nibble times its scale rounded once in float32, x's pairs (2t, 2t + 1)
    as B, 3xTF32 on m16n8k8 (``tf32x3_lanes``), each k16 step summed from
    zero and added in float32;
  - W4A8: each block's row maxima over its range combined across the
    cluster, x quantized (IEEE division, round half to even, clamp), A's
    words of four k values by ``__byte_perm(r0, r1, 0x6420 / 0x7531)``,
    masked and less 8 per byte (``__vsub4``), x's int8 B fragments in the
    same k order, m16n8k32 s8 products in exact int32, each group
    converted, scaled and added in float32 at its end, the row scale after
    the cluster sum;
  and the blocks of a cluster summed in block order. At M in {1, 8, 9}, N
  in {7, 130, 5120}, groups 64 and 128 (and the tools' [8, 1280] x [1280,
  5120]) each equals its plain version: v2 in bf16 within one bf16 step of
  each element (beside 1e-5 of the largest output for the float32 sums'
  order), float32 and W4A8 within 1e-5 of the largest output.
* The same inputs through the JAX tools' functions (their Pallas kernels in
  interpret mode): ``run_variant(_kernel_v2, ...)`` and
  ``w4a8_matmul(interpret=True)``.
* v2's bf16 weights as the transcription forms them are bit-identical to
  ``dequantize_int4(..., torch.bfloat16)``; W4A8's in-kernel quantization,
  each split's maxima combined, gives xq and xs bit-identical to
  ``quantize_activations`` and to the arrays the JAX function hands its
  kernel.
* The body tables are the sources' ``takes`` / ``takes_w4a8``; every plan's
  shared memory fits a block; the new entry points are bound with their C
  arguments, built from their ``#if`` branch; the entry points route by
  the tables; the wrappers refuse CPU tensors.
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
from audax_torch.tools import int4_unpack_probe as up
from audax_torch.tools import w4a8_probe as wp

from . import tf32x3_lanes as tl
from .csrc_constexpr import CSRC, constexpr_function
from .test_torch_int4_sm90 import bf16, byte_perm, ldmatrix_regs, unpack

SRC = "int4_matmul_mma.cu"
REPO = Path(__file__).resolve().parents[2]
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
MT, KSTEP, STAGE = 8, 16, 32


def _fn(name):
    return constexpr_function(SRC, name)


def plan(route, m, n, kh, nt=None):
    """(nt, packed rows a split, splits) as the launcher picks them on
    ``route`` (the source's ROUTE_* number)."""
    nt = nt or _fn("pick_nt")(route, m, n, kh)
    tiles = _fn("block_tiles")(m, n, nt)
    return (nt, _fn("split_range")(route, tiles, kh, nt),
            _fn("split_count")(route, tiles, kh, nt))


def mma16(c, a, b):
    """``mma.sync.m16n8k16.row.col`` bf16 on any number of tiles: c [..., 32,
    4] += A @ B, A 16x16 from a [..., 32, 8], B 16x8 from b [..., 32, 4];
    the products exact, the float32 sum rounded once."""
    am = np.zeros(a.shape[:-2] + (16, 16))
    am[..., G, 2 * T], am[..., G, 2 * T + 1] = a[..., 0], a[..., 1]
    am[..., G + 8, 2 * T], am[..., G + 8, 2 * T + 1] = a[..., 2], a[..., 3]
    am[..., G, 2 * T + 8], am[..., G, 2 * T + 9] = a[..., 4], a[..., 5]
    am[..., G + 8, 2 * T + 8], am[..., G + 8, 2 * T + 9] = a[..., 6], a[..., 7]
    bm = np.zeros(b.shape[:-2] + (16, 8))
    bm[..., 2 * T, G], bm[..., 2 * T + 1, G] = b[..., 0], b[..., 1]
    bm[..., 2 * T + 8, G], bm[..., 2 * T + 9, G] = b[..., 2], b[..., 3]
    d = am @ bm
    return (c + np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                          d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]],
                         -1)).astype(np.float32)


def mma_s8(c, a, b):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32``: c [..., 32, 4] int64 +=
    A @ B exactly, A 16x32 from a [..., 32, 16] (register q's four bytes:
    q 0 (g, 4t + e), 1 (g + 8, 4t + e), 2 (g, 16 + 4t + e), 3 (g + 8,
    16 + 4t + e)), B 32x8 from b [..., 32, 8] (register 0 (4t + e, g),
    1 (16 + 4t + e, g))."""
    am = np.zeros(a.shape[:-2] + (16, 32), np.int64)
    bm = np.zeros(b.shape[:-2] + (32, 8), np.int64)
    for e in range(4):
        am[..., G, 4 * T + e] = a[..., e]
        am[..., G + 8, 4 * T + e] = a[..., 4 + e]
        am[..., G, 16 + 4 * T + e] = a[..., 8 + e]
        am[..., G + 8, 16 + 4 * T + e] = a[..., 12 + e]
        bm[..., 4 * T + e, G] = b[..., e]
        bm[..., 16 + 4 * T + e, G] = b[..., 4 + e]
    d = am @ bm
    return c + np.stack([d[..., G, 2 * T], d[..., G, 2 * T + 1],
                         d[..., G + 8, 2 * T], d[..., G + 8, 2 * T + 1]], -1)


def words_int8(w):
    """The four bytes of each uint32 as int8 values [..., 4]."""
    w = np.asarray(w, np.uint32)
    return np.stack([((w >> (8 * e)) & 0xFF).astype(np.uint8).view(np.int8)
                     for e in range(4)], -1).astype(np.int64)


def vsub4_8(w):
    """``__vsub4(w, 0x08080808)``: each byte less 8, wrapping."""
    w = np.asarray(w, np.uint32).astype(np.int64)
    return sum(((((w >> (8 * e)) & 0xFF) - 8) & 0xFF) << (8 * e)
               for e in range(4)).astype(np.uint32)


def nib_f32(nibs, k):
    """``nib_f32``: byte k of a register masked to 0x0F0F0F0F under the
    exponent of 2^23, less 2^23 + 8 (exact)."""
    bits = byte_perm(nibs, np.uint32(0x4B000000), 0x7540 | k)
    return (np.asarray(bits, np.uint32).view(np.float32)
            - np.float32(8388616.0)).astype(np.float32)


def quantize_rows(xb, c0, c1, kh):
    """W4A8's step 2 for one block: the largest |x| of each row over the
    block's packed rows [c0, c1) of both halves."""
    part = np.concatenate([xb[:, c0:c1], xb[:, kh + c0:kh + c1]], 1)
    return np.abs(part).max(1)


def row_scales(block_max):
    """The cluster's row maxima (the largest of its blocks') -> xs =
    max(a, 1e-12) / 127 in float32 (IEEE division)."""
    a = np.max(np.stack(block_max), 0).astype(np.float32)
    return (np.maximum(a, np.float32(1e-12)) / np.float32(127)).astype(
        np.float32)


def quantize(xb, xs):
    """xq = clamp(round half to even(x / xs), +-127) (``__fdiv_rn``,
    ``__float2int_rn``)."""
    return np.clip(np.rint((xb / xs[:, None]).astype(np.float32)), -127,
                   127).astype(np.int64)


def schedule(route, x, q, s, group, nt=None, record=None):
    """``int4mma_kernel<ROUTE_V2 or ROUTE_W4A8, ...>`` in numpy for x [M, K]
    float32 (bf16 values where ``route`` is "v2_bf16" or "w4a8_bf16"),
    packed q [K/2, N] uint8, scales s [G, N] float32 -> y [M, N] float32
    before the cast to x's dtype. ``record``: a dict that receives v2's
    bf16 weights W~ [K, N] ("w") or W4A8's (xq, xs) of each 8-row tile."""
    m, k_dim = x.shape
    kh, n = q.shape
    kind = route.split("_")[0]
    nt, rng, splits = plan(_fn(f"ROUTE_{kind.upper()}"), m, n, kh, nt)
    u = -(-n // 16)                              # 16-column A tiles
    rows_p = splits * rng + STAGE
    qp = np.zeros((rows_p, 16 * u), np.uint8)
    qp[:kh, :n] = q
    sp = np.zeros((s.shape[0], 16 * u), np.float32)
    sp[:, :n] = s
    num_g = s.shape[0]
    cols = 16 * np.arange(u)[:, None] + 2 * G    # [u, 32]: column 2g
    if record is not None and route == "v2_bf16":
        record["w"] = np.zeros((k_dim, 16 * u), np.float32)
    y = np.zeros((m, n), np.float32)
    for m0 in range(0, m, MT):
        xb = np.zeros((MT, k_dim), np.float32)
        xb[:min(MT, m - m0)] = x[m0:m0 + MT]
        if kind == "w4a8":
            xs = row_scales([quantize_rows(xb, sp_ * rng,
                                           min(kh, sp_ * rng + rng), kh)
                             for sp_ in range(splits)])
            xq = quantize(xb, xs)
            if record is not None:
                record.setdefault("xq", []).append(xq)
                record.setdefault("xs", []).append(xs)
        partial = []
        for split in range(splits):
            c0, c1 = split * rng, min(kh, split * rng + rng)
            tot = np.zeros((u, 32, 4), np.float32)
            plo = np.zeros((u, 32, 4), np.float32)
            phi = np.zeros((u, 32, 4), np.float32)
            ilo = np.zeros((u, 32, 4), np.int64)
            ihi = np.zeros((u, 32, 4), np.int64)
            for st in range(-(-(c1 - c0) // STAGE)):
                c = c0 + st * STAGE
                tile = qp[c:c + STAGE].reshape(STAGE, u, 16).transpose(1, 0, 2)
                if c + STAGE > c1:               # rows past the range: 0
                    tile = tile.copy()
                    tile[:, c1 - c:] = 0
                regs = _regs(tile)
                if kind == "w4a8":
                    a = [byte_perm(regs[0], regs[1], 0x6420),
                         byte_perm(regs[0], regs[1], 0x7531),
                         byte_perm(regs[2], regs[3], 0x6420),
                         byte_perm(regs[2], regs[3], 0x7531)]
                    alo = np.concatenate([words_int8(vsub4_8(w & 0x0F0F0F0F))
                                          for w in a], -1)
                    ahi = np.concatenate([words_int8(vsub4_8((w >> 4)
                                                             & 0x0F0F0F0F))
                                          for w in a], -1)
                    bl, bh = ([np.stack([xq[G, h + c + 2 * T + o]
                                         for o in (0, 1, 8, 9, 16, 17, 24,
                                                   25)], -1)
                               for h in (0, kh)])
                    ilo, ihi = mma_s8(ilo, alo, bl), mma_s8(ihi, ahi, bh)
                    c_end = c + STAGE
                    if c_end % group == 0 or c_end >= c1:
                        gi = (c_end - 1) // group
                        sl = sp[gi][cols]        # [u, 32]: column 2g
                        sl1 = sp[gi][cols + 1]
                        sh = sp[gi + num_g // 2][cols]
                        sh1 = sp[gi + num_g // 2][cols + 1]
                        s_lo = np.stack([sl, sl, sl1, sl1], -1)
                        s_hi = np.stack([sh, sh, sh1, sh1], -1)
                        tot = (tot + (ilo.astype(np.float32) * s_lo
                                      + ihi.astype(np.float32) * s_hi)
                               ).astype(np.float32)
                        ilo[:] = ihi[:] = 0
                    continue
                for half in range(2):
                    j = c + half * KSTEP        # the k16 step's first row
                    if j >= c1:
                        break
                    gi = j // group
                    s_l = [sp[gi][cols], sp[gi][cols + 1]]
                    s_h = [sp[gi + num_g // 2][cols],
                           sp[gi + num_g // 2][cols + 1]]
                    if route == "v2_bf16":
                        alo, ahi = unpack(regs[2 * half], regs[2 * half + 1])
                        col = [0, 0, 1, 1, 0, 0, 1, 1]   # column 2g + col
                        wl = bf16(alo * np.stack([bf16(s_l[k]) for k in col],
                                                 -1))
                        wh = bf16(ahi * np.stack([bf16(s_h[k]) for k in col],
                                                 -1))
                        if record is not None:
                            _record_bf16(record["w"], wl, j, cols)
                            _record_bf16(record["w"], wh, kh + j, cols)
                        bl, bh = [np.stack([xb[G, h + j + 2 * T + o]
                                            for o in (0, 1, 8, 9)], -1)
                                  for h in (0, kh)]
                        plo, phi = mma16(plo, wl, bl), mma16(phi, wh, bh)
                        continue
                    acc = np.zeros((u, 32, 4), np.float32)
                    for e in range(2):          # packed rows 8e .. 8e + 7
                        r = regs[2 * half + e]
                        lo, hi = r & 0x0F0F0F0F, (r >> 4) & 0x0F0F0F0F
                        wl = np.stack([(nib_f32(lo, k) * s_l[k % 2])
                                       .astype(np.float32)
                                       for k in range(4)], -1)
                        wh = np.stack([(nib_f32(hi, k) * s_h[k % 2])
                                       .astype(np.float32)
                                       for k in range(4)], -1)
                        bl, bh = (np.stack([xb[G, h + j + 8 * e + 2 * T + o]
                                            for o in (0, 1)], -1)
                                  for h in (0, kh))
                        acc = tl.mma3(tl.mma3(acc, wl, bl), wh, bh)
                    tot = (tot + acc).astype(np.float32)
            if kind == "v2" and route == "v2_bf16":
                tot = (plo + phi).astype(np.float32)
            partial.append(tot)
        acc = np.zeros((u, 32, 4), np.float32)
        for p in partial:                         # block rank order
            acc = (acc + p).astype(np.float32)
        blk = np.zeros((MT, 16 * u), np.float32)
        for qi in range(4):
            blk[2 * T + qi % 2, cols + qi // 2] = acc[..., qi]
        if kind == "w4a8":
            blk = (blk * xs[:, None]).astype(np.float32)
        mm = min(MT, m - m0)
        y[m0:m0 + mm] = blk[:mm, :n]
    if record is not None and route == "v2_bf16":
        record["w"] = record["w"][:, :n]
    return y


def _regs(tile):
    """``ldmatrix.x4.trans`` of every A tile at once: tile [u, 32, 16]
    bytes -> four registers [u, 32]."""
    rows = tile.astype(np.uint32)
    return [rows[:, 8 * j + 2 * T, 2 * G] | rows[:, 8 * j + 2 * T, 2 * G + 1]
            << 8 | rows[:, 8 * j + 2 * T + 1, 2 * G] << 16
            | rows[:, 8 * j + 2 * T + 1, 2 * G + 1] << 24 for j in range(4)]


def _record_bf16(w, frag, k0, cols):
    """W~ [K, N] from a k16 step's A values [u, 32, 8]: a0 a1 (column 2g,
    k 2t, 2t + 1), a2 a3 (column 2g + 1), a4..a7 the same at k + 8."""
    for v, (dk, dc) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1),
                                  (8, 0), (9, 0), (8, 1), (9, 1)]):
        w[k0 + 2 * T + dk, cols + dc] = frag[..., v]


def _inputs(seed, m, k_dim, n, group):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k_dim, n)).astype(np.float32) / k_dim ** 0.5
    x = rng.standard_normal((m, k_dim)).astype(np.float32)
    q, s = i4.quantize_int4(torch.from_numpy(w), group=group)
    assert k_dim // s.shape[0] == group
    return x, q.numpy(), s.numpy()


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _one_bf16_step(got_f32, ref):
    """got (the schedule's float32 output) cast to bf16 is within one bf16
    step of each element of ref (bf16), beside 1e-5 of the largest output
    for the float32 sums' order."""
    got = bf16(got_f32)
    ref = np.asarray(ref, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    slack = step + 1e-5 * float(np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= slack)


def _tol(ref):
    return 1e-5 * float(np.abs(ref).max()) + 1e-7


GRID = [(m, n, group) for m in (1, 8, 9) for n in (7, 130, 5120)
        for group in (64, 128)]


def _k(group):
    """K with two groups in each half."""
    return 4 * group


@pytest.mark.parametrize("m,n,group", GRID + [(8, 5120, "tools")], ids=str)
def test_v2_bf16_schedule_equals_the_plain_version(m, n, group):
    k_dim, group = (1280, 128) if group == "tools" else (_k(group), group)
    x, q, s = _inputs(m * n + group, m, k_dim, n, group)
    xb = _bf16_values(x)
    got = schedule("v2_bf16", xb, q, s, group)
    ref = up.unpack_v2_plain(torch.from_numpy(xb).bfloat16(),
                             torch.from_numpy(q), torch.from_numpy(s))
    _one_bf16_step(got, ref.float().numpy())


@pytest.mark.parametrize("m,n,group", GRID + [(8, 5120, "tools")], ids=str)
def test_v2_f32_schedule_equals_the_plain_version(m, n, group):
    k_dim, group = (1280, 128) if group == "tools" else (_k(group), group)
    x, q, s = _inputs(m * n + group + 1, m, k_dim, n, group)
    got = schedule("v2_f32", x, q, s, group)
    ref = up.unpack_v2_plain(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


@pytest.mark.parametrize("m,n,group", GRID + [(8, 5120, "tools")], ids=str)
def test_w4a8_schedule_equals_the_plain_version(m, n, group):
    k_dim, group = (1280, 128) if group == "tools" else (_k(group), group)
    x, q, s = _inputs(m * n + group + 2, m, k_dim, n, group)
    got = schedule("w4a8_f32", x, q, s, group)
    ref = wp.w4a8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


@pytest.mark.parametrize("m,n,group", [(1, 7, 64), (9, 130, 128),
                                       (8, 5120, 64)], ids=str)
def test_w4a8_bf16_schedule_equals_the_plain_version(m, n, group):
    """bf16 x: the same int8 values (x's bf16 values are exact in float32),
    the output rounded once to bf16."""
    x, q, s = _inputs(m * n + group + 3, m, _k(group), n, group)
    xb = _bf16_values(x)
    got = schedule("w4a8_bf16", xb, q, s, group)
    ref = wp.w4a8_matmul_plain(torch.from_numpy(xb).bfloat16(),
                               torch.from_numpy(q), torch.from_numpy(s))
    _one_bf16_step(got, ref.float().numpy())


@pytest.mark.parametrize("route", ["v2_bf16", "v2_f32", "w4a8_f32"])
@pytest.mark.parametrize("nt", [1, 2, 4])
def test_schedules_at_every_warp_width(route, nt):
    """nt A tiles a warp changes the split plan (the tool's ``block_n`` =
    64 nt), not the result."""
    m, k_dim, n, group = 9, 512, 130, 128
    x, q, s = _inputs(nt, m, k_dim, n, group)
    xr = _bf16_values(x) if route == "v2_bf16" else x
    got = schedule(route, xr, q, s, group, nt=nt)
    args = (torch.from_numpy(xr), torch.from_numpy(q), torch.from_numpy(s))
    if route == "v2_bf16":
        ref = up.unpack_v2_plain(args[0].bfloat16(), *args[1:])
        _one_bf16_step(got, ref.float().numpy())
        return
    ref = (up.unpack_v2_plain if route == "v2_f32" else
           wp.w4a8_matmul_plain)(*args).numpy()
    np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


# ---- the JAX tools in interpret mode ----------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jt():
    return {n: _jax_tool(n) for n in ("w4a8_probe", "int4_unpack_probe")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,group", [(9, 130, 64), (8, 7, 128)], ids=str)
def test_v2_schedule_matches_jax_pallas(jt, interpret, dtype, m, n, group):
    x, q, s = _inputs(m + n, m, _k(group), n, group)
    if dtype == "bf16":
        x = _bf16_values(x)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tool = jt["int4_unpack_probe"]
    ref = np.asarray(tool.run_variant(tool._kernel_v2, xj, jnp.asarray(q),
                                      jnp.asarray(s)), np.float32)
    got = schedule(f"v2_{dtype}", x, q, s, group)
    if dtype == "bf16":
        _one_bf16_step(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,group", [(9, 130, 64), (8, 7, 128)], ids=str)
def test_w4a8_schedule_matches_jax_pallas(jt, dtype, m, n, group):
    x, q, s = _inputs(m + n + 1, m, _k(group), n, group)
    if dtype == "bf16":
        x = _bf16_values(x)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = np.asarray(jt["w4a8_probe"].w4a8_matmul(
        xj, jnp.asarray(q), jnp.asarray(s), interpret=True), np.float32)
    got = schedule(f"w4a8_{dtype}", x, q, s, group)
    if dtype == "bf16":
        _one_bf16_step(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=_tol(ref), rtol=0)


# ---- bit-identity: v2's bf16 weights, W4A8's quantization -------------------

@pytest.mark.parametrize("n,group", [(130, 64), (5120, 128)], ids=str)
def test_v2_bf16_weights_are_dequantize_int4_bit_for_bit(n, group):
    x, q, s = _inputs(n, 8, _k(group), n, group)
    rec = {}
    schedule("v2_bf16", _bf16_values(x), q, s, group, record=rec)
    want = i4.dequantize_int4(torch.from_numpy(q), torch.from_numpy(s),
                              torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(rec["w"].view(np.uint32),
                                  want.view(np.uint32))


def _quant_rows(seed, m, k_dim):
    """Rows over six orders of magnitude, one all zero (the 1e-12 floor)
    and one whose largest value is 127 (xs = 1: x / xs hits the ties
    2.5, -3.5, 0.5 that round half to even)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k_dim))
         * np.logspace(-3, 3, m)[:, None]).astype(np.float32)
    x[2] = 0.0
    x[4, :5] = [127.0, 2.5, -3.5, 0.5, -1.5]
    x[4, 5:] = np.clip(x[4, 5:], -100, 100)
    return x


@pytest.mark.parametrize("m,k_dim,n,group", [(9, 256, 130, 64),
                                             (16, 512, 5120, 128)], ids=str)
def test_w4a8_in_kernel_quantization_is_bit_identical(jt, monkeypatch, m,
                                                      k_dim, n, group):
    x = _quant_rows(m + k_dim, m, k_dim)
    _, q, s = _inputs(k_dim, 1, k_dim, n, group)
    rec = {}
    schedule("w4a8_f32", x, q, s, group, record=rec)
    xq = np.concatenate(rec["xq"])[:m]
    xs = np.concatenate(rec["xs"])[:m]
    tq, ts = wp.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(xq, tq.numpy().astype(np.int64))
    np.testing.assert_array_equal(xs.view(np.uint32),
                                  ts.numpy()[:, 0].view(np.uint32))
    assert (xq[4, 1:5] == [2, -4, 0, -2]).all()
    seen = []
    orig = pl.pallas_call

    def capture(*args, **kw):
        call = orig(*args, **kw)
        return lambda *ops: (seen.append(ops), call(*ops))[1]
    monkeypatch.setattr(pl, "pallas_call", capture)
    jt["w4a8_probe"].w4a8_matmul(jnp.asarray(x), jnp.asarray(q),
                                 jnp.asarray(s), interpret=True)
    _, jq, jxs = seen[0][:3]
    np.testing.assert_array_equal(xq, np.asarray(jq)[:m].astype(np.int64))
    np.testing.assert_array_equal(xs.view(np.uint32),
                                  np.asarray(jxs, np.float32)[:m, 0]
                                  .view(np.uint32))


def test_w4a8_words_are_four_k_values_of_one_column():
    """``__byte_perm(r0, r1, 0x6420)`` of two ldmatrix registers (packed
    rows 2t, 2t + 1 and 2t + 8, 2t + 9) is column 2g at those four rows,
    0x7531 column 2g + 1; with the x staging's offsets (0, 1, 8, 9) both
    sides of every k slot name the same packed row."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 256, (1, 32, 16), dtype=np.uint8)
    regs = _regs(tile)
    for j, want in enumerate(ldmatrix_regs(tile[0])):   # K9's, one tile
        np.testing.assert_array_equal(regs[j][0], want)
    for j, (sel, col) in enumerate([(0x6420, 0), (0x7531, 1)]):
        for pair in (0, 1):
            word = byte_perm(regs[2 * pair], regs[2 * pair + 1], sel)[0]
            got = np.stack([(word >> (8 * e)) & 0xFF for e in range(4)], -1)
            rows = 16 * pair + 2 * T[:, None] + np.array([0, 1, 8, 9])
            np.testing.assert_array_equal(got, tile[0][rows,
                                                       (2 * G + col)[:, None]])
    assert (words_int8(vsub4_8(np.uint32(0x0F070800))) == [-8, 0, -1, 7]
            ).all()


def test_f32_fragment_is_the_register_relabelled():
    """v2 in float32: byte k of an 8-row step's register is a_k of the
    TF32 A fragment -- a0 (A row g = column 2g, k slot t = packed row 2t),
    a1 (column 2g + 1, row 2t), a2 (column 2g, row 2t + 1), a3 (column
    2g + 1, row 2t + 1) -- and nib_f32 reads each as nib - 8."""
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 256, (1, 32, 16), dtype=np.uint8)
    regs = _regs(tile)
    for j in range(4):
        lo = regs[j][0] & 0x0F0F0F0F
        for k, (dr, dc) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            want = (tile[0][8 * j + 2 * T + dr, 2 * G + dc] & 0xF) - 8.0
            np.testing.assert_array_equal(nib_f32(lo, k), want)


# ---- tables, plans, bindings, routing ----------------------------------------

@pytest.mark.parametrize("kh,group", [(640, 128), (2560, 128), (64, 16),
                                      (160, 80), (8192, 128), (8320, 128),
                                      (640, 8), (96, 32), (120, 40),
                                      (640, 64), (128, 32), (192, 48)])
def test_body_tables_are_the_source_rules(kh, group):
    takes, takes_w4a8 = _fn("takes"), _fn("takes_w4a8")
    assert up.V2_BODIES["mma"][1](kh, group) == bool(takes(kh, group))
    assert wp.W4A8_BODIES["mma"][1](kh, group) == bool(takes_w4a8(kh,
                                                                   group))
    assert up.v2_body(2 * kh, group) == ("mma" if takes(kh, group)
                                         else "blocked")
    assert wp.w4a8_body(2 * kh, group) == ("mma" if takes_w4a8(kh, group)
                                           else "dp4a")


@pytest.mark.parametrize("m,kh,n", [(8, 640, 5120), (9, 640, 1287),
                                    (1, 128, 7), (8, 2560, 1280),
                                    (256, 640, 1280), (8, 8192, 1280),
                                    (8, 640, 51866)])
def test_every_plan_fits_a_block(m, kh, n):
    smem = _fn("route_smem_bytes")
    for nt in (None, 1, 2, 4):
        if nt and kh > 16 * 512 // nt:
            continue
        for route in (0, 1, 2):
            nt_, rng, _ = plan(route, m, n, kh, nt)
            for f32 in (0, 1):
                for vec in (16, 2, 1):
                    for group in (32, 64, 128):
                        assert smem(route, f32, vec, nt_, rng, group) <= 232448
    assert _fn("route_parts")(1, 1) == 4 and _fn("route_parts")(0, 1) == 3
    assert _fn("quant_floats")(2) == 6 * MT and _fn("quant_floats")(1) == 0


@pytest.mark.parametrize("lib,fn,macro", [
    ("int4_unpack_v2_mma", "int4_unpack_v2_mma", "AUDAX_INT4_V2"),
    ("w4a8_matmul_mma", "w4a8_matmul_mma", "AUDAX_INT4_W4A8")])
def test_libraries_are_bound_with_the_c_prototypes(lib, fn, macro):
    src = (CSRC / SRC).read_text()
    assert native.KERNEL_SOURCES[lib] == SRC
    assert native.DEFINES[lib] == (f"-D{macro}",)
    proto = re.search(rf"int {fn}\(([^)]*)\)", src)[1]
    argtypes, _ = native.SIGNATURES[lib][fn]
    assert len(argtypes) == len(proto.split(","))
    branch = src[src.index(f"defined({macro})"):]
    assert branch.index(f"int {fn}(") < branch.index("#e")
    old = {"int4_unpack_v2_mma": ("int4_unpack_variants", "int4_unpack_v2"),
           "w4a8_matmul_mma": ("w4a8_matmul", "w4a8_matmul")}[lib]
    old_src = (CSRC / native.KERNEL_SOURCES[old[0]]).read_text()
    old_proto = re.search(rf"int {old[1]}\(([^)]*)\)", old_src)[1]
    assert len(native.SIGNATURES[old[0]][old[1]][0]) == len(
        old_proto.split(","))


def test_wrappers_refuse_cpu_tensors_and_count_apart():
    x = torch.zeros(2, 256)
    q, s = i4.quantize_int4(torch.zeros(256, 128))
    before = (up.unpack_v2_mma_cuda.launches, wp.w4a8_matmul_mma_cuda.launches)
    for call in (up.unpack_v2_mma_cuda, wp.w4a8_matmul_mma_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            call(x, q, s)
    assert (up.unpack_v2_mma_cuda.launches,
            wp.w4a8_matmul_mma_cuda.launches) == before
    kernels = probe_kernels()
    assert {kernels[c][0] for c, _ in up.V2_BODIES.values()} == {
        up.unpack_v2_mma_cuda, up.unpack_v2_cuda}
    assert {kernels[c][0] for c, _ in wp.W4A8_BODIES.values()} == {
        wp.w4a8_matmul_mma_cuda, wp.w4a8_matmul_cuda}
    assert kernels["int4_unpack_v2_mma"][1] is up.unpack_v2_plain
    assert kernels["w4a8_matmul_mma"][1] is wp.w4a8_matmul_plain


class _OnCard:
    """Stands in for a CUDA x of ``shape`` in the entry points' dispatch,
    which reads only where x lies and its shape."""
    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("k_dim,group", [(1280, 128), (1280, 64), (1280, 80),
                                         (1280, 40), (17408, 128)])
def test_entry_points_call_the_one_body_the_tables_give(monkeypatch, k_dim,
                                                        group):
    calls = []
    for mod, attr, name in ((up, "unpack_v2_mma_cuda", "v2 mma"),
                            (up, "unpack_v2_cuda", "v2 blocked"),
                            (wp, "w4a8_matmul_mma_cuda", "w4a8 mma"),
                            (wp, "w4a8_matmul_cuda", "w4a8 dp4a")):
        monkeypatch.setattr(mod, attr,
                            lambda *a, name=name, **k: calls.append(name))
    scales = torch.zeros(k_dim // group, 3)
    up.run_variant("v2", _OnCard(8, k_dim), None, scales)
    wp.w4a8_matmul(_OnCard(8, k_dim), None, scales)
    assert calls == [f"v2 {up.v2_body(k_dim, group)}",
                     f"w4a8 {wp.w4a8_body(k_dim, group)}"]
    if up.v2_body(k_dim, group) != "mma":
        with pytest.raises(ValueError, match="block_n"):
            up.run_variant("v2", _OnCard(8, k_dim), None, scales,
                           block_n=128)
