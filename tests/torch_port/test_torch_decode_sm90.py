"""K3's and K6's body on Hopper (``csrc/decode_attention_sm90.cu``) on the
CPU, where nothing can launch.

* The kernel's schedule, transcribed into numpy: the plan (q-heads a
  block serves, the keys the call can see, the cluster's splits, each
  block's chunk and tile) and the shared memory read from the source
  (``csrc_constexpr``); each block's scores of its chunk (masked -1e30
  past ``pos[b] + r``), its row maxima, the cluster's maximum, p = exp(s -
  m) with the block's l summed unrounded, p (times v's scale in int8)
  rounded to q's dtype (bf16 by bit operations), the block's partial PV,
  and the partials and l summed in block order before the division. A
  block whose chunk lies past its slot's position adds zeros. At Tq 1/3/16,
  S 1/5/68/448/1500, head dims 16-128, ``pos`` None / scalar / a [B]
  vector with 0 and S - 1, GQA 8q/2kv, int8 and a tiled chunk it equals
  ``decode_attention_stacked_plain`` / ``_int8_plain`` /
  ``decode_attention_plain`` within 1e-5 of the plain output's largest
  value (float32), bf16 q within 2e-2 (the plain version rounds p / l, the
  kernel p).
* The same inputs through the JAX package's ``decode_attention_stacked``
  and ``decode_attention`` (their Pallas kernels in interpret mode, as the
  JAX tests run them) within 1e-5.
* The plan: at least 132 blocks at the main paths' cross shapes, at most
  16 splits, chunks that cover the keys, every plan's shared memory within
  one block's 227 KB; the counted launchers refuse CPU tensors; the
  library is bound with the C prototype's arguments.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import decode_attention as jax_decode1
from audax.ops.attention import decode_attention_stacked as jax_decode
from audax_torch.models.whisper import quantize_kv
from audax_torch.ops import KERNELS, native
from audax_torch.ops import attention as A

from .csrc_constexpr import CSRC, constexpr_function

SRC = "decode_attention_sm90.cu"
NEG = np.float32(-1e30)
TOL = 1e-5
TOL_BF16 = 2e-2
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _fn(name):
    return constexpr_function(SRC, name)


def bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32: the
    kernel's ``__float2bfloat16``."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def plan(b, h, hkv, tq, s_len, d, pos, per_slot, elt, quant):
    """The launch's plan as ``make_plan`` computes it, from the source."""
    group = h // hkv
    rows = _fn("block_rows")(group, tq)
    pairs = b * hkv * _fn("head_blocks")(group, tq)
    keys = _fn("visible_keys")(s_len, pos, tq, per_slot)
    splits = _fn("split_count")(keys, pairs, rows, d, elt, quant)
    chunk = _fn("split_chunk")(keys, splits)
    tile = _fn("tile_keys")(rows, chunk, d, elt, quant)
    smem = (_fn("smem_bytes")(rows, chunk, tile, d, elt, quant) if tile > 0
            else -1)
    return dict(rows=rows, pairs=pairs, keys=keys, splits=splits,
                chunk=chunk, tile=tile, smem=smem,
                head_block=_fn("head_block")(group, tq))


def schedule(q, k, v, ks, vs, layer, pos, scale, dtype):
    """``decode_cluster_kernel`` in numpy: q [B, H, Tq, D] float32 (bf16
    values for ``dtype`` "bf16"), k, v [L, B, Hkv, S, D] float32 (int8
    codes as float32 with ``ks``/``vs`` [L, B, Hkv, S], else None), ``pos``
    None, an int or a [B] array. Returns o [B, H, Tq, D] float32."""
    b, h, tq, d = q.shape
    hkv, s_len = k.shape[2], k.shape[3]
    quant = ks is not None
    rnd = bf16 if dtype == "bf16" else (lambda x: np.asarray(x, np.float32))
    per_slot = isinstance(pos, np.ndarray)
    host = (0 if per_slot else s_len if pos is None
            else max(-tq, min(int(pos), s_len)))
    elt = 1 if quant else (2 if dtype == "bf16" else 4)
    p = plan(b, h, hkv, tq, s_len, d, host, int(per_slot), elt, int(quant))
    assert 0 < p["smem"] <= SMEM_LIMIT
    group, hb = h // hkv, p["head_block"]
    splits, chunk = p["splits"], p["chunk"]
    out = np.zeros_like(q)
    for pair in range(p["pairs"]):
        nhb = -(-group // hb)
        hblk, bk = pair % nhb, pair // nhb
        bi, kvh = bk // hkv, bk % hkv
        h0 = kvh * group + hblk * hb
        nh = min(hb, group - hblk * hb)
        qb = q[bi, h0:h0 + nh].reshape(nh * tq, d)          # rows i tq + r
        rq = np.tile(np.arange(tq), nh)
        p_b = int(pos[bi]) if per_slot else host
        seen = min(max(p_b + tq, 0), s_len)
        blocks = []
        for rank in range(splits):                          # 1. scores
            j0 = rank * chunk
            n = max(0, min(j0 + chunk, p["keys"], seen) - j0)
            j = j0 + np.arange(n)
            kk = k[layer, bi, kvh, j0:j0 + n]
            s = (qb @ kk.T).astype(np.float32) * np.float32(scale)
            if quant:
                s = s * ks[layer, bi, kvh, j0:j0 + n][None]
            valid = j[None] <= p_b + rq[:, None]
            s = np.where(valid, s, NEG).astype(np.float32)
            mx = s.max(axis=1) if n else np.full(nh * tq, NEG, np.float32)
            blocks.append((j0, n, s, valid, mx))
        m = np.max([bl[4] for bl in blocks], axis=0)        # 2. cluster max
        acc = np.zeros((nh * tq, d), np.float32)
        lsum = np.zeros(nh * tq, np.float32)
        for j0, n, s, valid, _ in blocks:                   # 3. block order
            e = np.where(valid, np.exp(s - m[:, None]), 0).astype(np.float32)
            l_blk = e.sum(axis=1, dtype=np.float32)
            if quant:
                e = e * vs[layer, bi, kvh, j0:j0 + n][None]
            pv = (rnd(e) @ v[layer, bi, kvh, j0:j0 + n]).astype(np.float32)
            acc = (acc + pv).astype(np.float32)
            lsum = (lsum + l_blk).astype(np.float32)
        o = acc / np.where(lsum == 0, np.float32(1), lsum)[:, None]
        out[bi, h0:h0 + nh] = rnd(o).reshape(nh, tq, d)
    return out


def _inputs(rng, L, b, h, hkv, tq, s_len, d, quant=False, dtype="f32"):
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((L, b, hkv, s_len, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, s_len, d)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    if quant:
        qkv = quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
        return q, tuple(t.numpy() for t in qkv)
    return q, (k, v)


def _torch_kv(kv, dtype):
    if len(kv) == 4:
        return tuple(torch.from_numpy(a) for a in kv)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return tuple(torch.from_numpy(a).to(tdt) for a in kv)


def _schedule(q, kv, layer, pos, scale, dtype):
    if len(kv) == 4:
        kq, ksc, vq, vsc = kv
        return schedule(q, kq.astype(np.float32), vq.astype(np.float32), ksc,
                        vsc, layer, pos, scale, dtype)
    return schedule(q, kv[0], kv[1], None, None, layer, pos, scale, dtype)


def _pos(kind, b, s_len):
    if kind == "none":
        return None
    if kind == "scalar":
        return min(7, s_len - 1)
    vec = np.array([0, s_len - 1, s_len // 2, 1][:b], np.int32)
    return np.minimum(vec, s_len - 1)


def _torch_pos(pos):
    return torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos


def _rel_err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


CASES = [  # (L, B, H, Hkv, Tq, S, D, pos kind, int8)
    (2, 1, 1, 1, 1, 1, 64, "scalar", False),
    (2, 2, 2, 2, 1, 1, 16, "vector", False),
    (2, 2, 2, 1, 3, 5, 32, "vector", False),
    (1, 2, 2, 2, 1, 68, 64, "vector", True),
    (1, 2, 2, 2, 16, 68, 64, "scalar", True),
    (2, 2, 2, 2, 3, 448, 64, "scalar", False),
    (1, 2, 2, 2, 1, 448, 128, "vector", False),
    (1, 2, 2, 2, 1, 1500, 64, "none", False),
    (1, 2, 2, 2, 1, 1500, 64, "none", True),
    (1, 1, 2, 2, 16, 1500, 16, "none", False),
    (1, 2, 8, 2, 3, 64, 64, "vector", False),
    (1, 2, 8, 2, 16, 68, 32, "vector", True),
    (1, 2, 8, 2, 1, 448, 128, "scalar", True),
    # the music LM's decode step (Qwen3-0.6B: GQA 16q/8kv, group 2, head
    # dim 128, a 256-row cache): a host-int position and four slots with
    # 0 and S - 1 among them
    (2, 1, 16, 8, 1, 256, 128, "scalar", False),
    (2, 4, 16, 8, 1, 256, 128, "vector", False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_equals_the_plain_version(rng, case):
    L, b, h, hkv, tq, s_len, d, kind, quant = case
    q, kv = _inputs(rng, L, b, h, hkv, tq, s_len, d, quant)
    pos = _pos(kind, b, s_len)
    scale = d ** -0.5
    plain = (A.decode_attention_stacked_int8_plain if quant
             else A.decode_attention_stacked_plain)
    for layer in range(L):
        got = _schedule(q, kv, layer, pos, scale, "f32")
        ref = plain(torch.from_numpy(q), _torch_kv(kv, "f32"), layer,
                    pos=_torch_pos(pos), scale=scale).numpy()
        assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("case", [c for c in CASES if c[5] <= 448],
                         ids=lambda c: "-".join(map(str, c)))
def test_schedule_matches_jax_pallas(rng, case):
    L, b, h, hkv, tq, s_len, d, kind, quant = case
    q, kv = _inputs(rng, L, b, h, hkv, tq, s_len, d, quant)
    pos = _pos(kind, b, s_len)
    for layer in range(L):
        got = _schedule(q, kv, layer, pos, d ** -0.5, "f32")
        ref = np.asarray(jax_decode(
            jnp.asarray(q), tuple(jnp.asarray(a) for a in kv), layer,
            pos=None if pos is None else jnp.asarray(pos),
            backend="pallas", interpret=True))
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("pos", [None, 0, 11])
def test_k6_schedule_at_one_layer(rng, quant, pos):
    """K6: the body on the cache viewed as [1, B, Hkv, S, D], against
    ``decode_attention_plain`` and JAX's ``decode_attention`` (Pallas in
    interpret mode)."""
    b, h, hkv, tq, s_len, d = 2, 4, 2, 2, 20, 32
    q, kv = _inputs(rng, 1, b, h, hkv, tq, s_len, d, quant)
    one = tuple(a[0] for a in kv)
    got = _schedule(q, kv, 0, pos, d ** -0.5, "f32")
    ref = A.decode_attention_plain(torch.from_numpy(q), _torch_kv(one, "f32"),
                                   pos=pos).numpy()
    assert _rel_err(got, ref) <= TOL
    jref = np.asarray(jax_decode1(jnp.asarray(q),
                                  tuple(jnp.asarray(a) for a in one),
                                  pos=pos, backend="pallas", interpret=True))
    np.testing.assert_allclose(got, jref, atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["none", "vector"])
def test_bf16_q(rng, quant, kind):
    """bf16 q: p rounded to bf16 before PV, as the TPU kernel rounds it; the
    plain version rounds p / l instead, hence 2e-2."""
    L, b, h, hkv, tq, s_len, d = 1, 2, 4, 2, 3, 300, 64
    q, kv = _inputs(rng, L, b, h, hkv, tq, s_len, d, quant, dtype="bf16")
    pos = _pos(kind, b, s_len)
    got = _schedule(q, kv, 0, pos, d ** -0.5, "bf16")
    plain = (A.decode_attention_stacked_int8_plain if quant
             else A.decode_attention_stacked_plain)
    ref = plain(torch.from_numpy(q).to(torch.bfloat16), _torch_kv(kv, "bf16"),
                0, pos=_torch_pos(pos)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_BF16, rtol=0)
    assert np.array_equal(got, bf16(got))


def test_tiled_chunk_equals_the_plain_version(rng):
    """A chunk too large for one block's shared memory is copied in tiles:
    the plan says so, and the arithmetic is the same."""
    b, h, hkv, tq, s_len, d = 1, 2, 2, 16, 3000, 128
    p = plan(b, h, hkv, tq, s_len, d, s_len, 0, 4, 0)
    assert p["splits"] == 16 and 32 <= p["tile"] < p["chunk"]
    q, kv = _inputs(rng, 1, b, h, hkv, tq, s_len, d)
    got = _schedule(q, kv, 0, None, d ** -0.5, "f32")
    ref = A.decode_attention_stacked_plain(
        torch.from_numpy(q), _torch_kv(kv, "f32"), 0).numpy()
    assert _rel_err(got, ref) <= TOL


def test_blocks_past_a_slot_add_nothing(rng):
    """A per-slot pos plans for every key; slot 0 at pos 0 leaves all but
    its first block without a visible key, and they add zeros."""
    b, h, s_len, d = 2, 2, 448, 64
    p = plan(b, h, h, 1, s_len, d, 0, 1, 4, 0)
    assert p["keys"] == s_len and p["splits"] > 1
    q, kv = _inputs(rng, 1, b, h, h, 1, s_len, d)
    pos = np.array([0, s_len - 1], np.int32)
    got = _schedule(q, kv, 0, pos, d ** -0.5, "f32")
    np.testing.assert_allclose(got[0, :, 0], kv[1][0, 0, :, 0], rtol=0,
                               atol=0)
    ref = A.decode_attention_stacked_plain(
        torch.from_numpy(q), _torch_kv(kv, "f32"), 0,
        pos=torch.from_numpy(pos)).numpy()
    assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("b,h,elt,quant,splits", [(4, 6, 4, 0, 16),
                                                  (8, 20, 1, 1, 7)])
def test_plan_fills_the_card_at_the_cross_shapes(b, h, elt, quant, splits):
    """Transcription's (B 4, H 6, f32) and serving's (B 8, H 20, int8)
    cross-attention over 1500 keys: at least two blocks per SM of 132, at
    least 32 keys a block, K/V copied whole (the splits the card was timed
    at)."""
    p = plan(b, h, h, 1, 1500, 64, 1500, 0, elt, quant)
    assert p["splits"] == splits and p["pairs"] * p["splits"] >= 2 * 132
    assert p["chunk"] >= 32 and p["tile"] == p["chunk"]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("elt,quant", [(4, 0), (2, 0), (1, 1)])
def test_every_plan_fits_and_covers_the_keys(d, elt, quant):
    for b, h, hkv in ((1, 1, 1), (4, 6, 6), (8, 20, 20), (2, 8, 2),
                      (1, 16, 1), (64, 20, 20)):
        for tq in (1, 3, 16):
            for s_len in (1, 5, 68, 448, 1500, 7000, 30000):
                for pos, per_slot in ((s_len, 0), (0, 0), (s_len // 3, 0),
                                      (-tq, 0), (0, 1)):
                    p = plan(b, h, hkv, tq, s_len, d, pos, per_slot, elt,
                             quant)
                    assert 1 <= p["splits"] <= 16
                    assert p["head_block"] * tq <= 64
                    assert p["head_block"] * -(-h // hkv // p["head_block"]
                                               ) >= h // hkv
                    assert p["chunk"] * p["splits"] >= p["keys"]
                    assert (p["splits"] - 1) * p["chunk"] < max(p["keys"], 1)
                    if p["tile"] > 0:
                        assert p["smem"] <= SMEM_LIMIT
                        assert p["tile"] == p["chunk"] or (
                            p["tile"] % 32 == 0 and p["tile"] < p["chunk"])
                    else:   # only where the chunk's scores leave no
                        # room for a tile (the first body refuses these too)
                        assert (_fn("fixed_bytes")(p["rows"], d)
                                + 4 * p["rows"] * p["chunk"]
                                + 32 * (2 * d * elt + 8 * quant)
                                > SMEM_LIMIT - 64)
                    if p["keys"] >= 32:
                        assert p["chunk"] >= 32 or p["splits"] == 16


def test_launchers_refuse_cpu_tensors_and_count_apart():
    q = torch.zeros(1, 2, 1, 16)
    k = torch.zeros(1, 1, 2, 8, 16)
    s = torch.ones(1, 1, 2, 8)
    codes = k.to(torch.int8)
    counters = (A.decode_attention_sm90_cuda, A.decode_attention_sm90_int8_cuda,
                A.decode_attention_core_cuda, A.decode_attention_stacked_cuda)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_sm90_cuda(q, k, k, 0)
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_sm90_int8_cuda(q, codes, s, codes, s, 0)
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_core_cuda(q, k, None, k, None, 0)
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_stacked_cuda(q, (k, k), 0, body="cuda_core")
    with pytest.raises(ValueError, match="body"):
        A.decode_attention_stacked_cuda(q, (k, k), 0, body="wgmma")
    assert [f.launches for f in counters] == before
    assert KERNELS["decode_attention_sm90"] == (
        A.decode_attention_sm90_cuda, A.decode_attention_stacked_plain)
    assert KERNELS["decode_attention_sm90_int8"] == (
        A.decode_attention_sm90_int8_cuda,
        A.decode_attention_stacked_int8_plain)
    assert KERNELS["decode_attention_cuda_core"][0] is (
        A.decode_attention_core_cuda)


def test_library_is_bound_with_the_c_prototype():
    src = (CSRC / SRC).read_text()
    assert native.KERNEL_SOURCES["decode_attention_sm90"] == SRC
    for fn in ("decode_sm90", "decode_sm90_smem"):
        proto = re.search(rf"\b(?:int|long long) {fn}\(([^)]*)\)", src)[1]
        argtypes, _ = native.SIGNATURES["decode_attention_sm90"][fn]
        assert len(argtypes) == len(proto.split(","))
    text = " ".join(src.split())
    assert "audax/ops/attention.py:_dec_kernel_stacked" in text
    assert "audax/ops/attention.py:_dec_kernel" in text
