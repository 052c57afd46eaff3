"""K2's float32 body on the tensor cores (``csrc/flash_fwd_tf32x3.cu``) on
the CPU, where nothing can launch.

* The kernel's schedule, transcribed into numpy lane by lane: TF32
  round-to-nearest (ties away, ``cvt.rna``) by bit operations on float32
  views; the big/small split; the three m16n8k8 products per k-step in the
  kernel's order (small cross terms first), each product through the
  fragment maps of ``mma.sync`` (A row, B col, C); Q scaled by scale *
  log2(e); the online softmax over 64-key tiles (32 and 128 at head_dim 64)
  with the masks, a row's max over its quad, l a per-lane partial summed
  over the quad at the end; and P V with S's C fragments as P's A fragments
  in the permuted k order (k = t <-> key 2t, k = t + 4 <-> key 2t + 1) and
  V's B fragments from key rows 2t and 2t + 1. At [1, 2, 130, d] for d in
  16/32/64/128, with causal, GQA, cross and ragged ``kv_len`` cases, it
  equals ``flash_forward_plain`` within 1e-5 (o and lse): a wrong map or
  permutation moves o by O(1).
* The same inputs through the JAX package's flash forward (its Pallas
  kernel in interpret mode, as the JAX tests run it) within 1e-4.
* One TF32 pass instead of three has at least 10x the error (fixed seed):
  the split is what keeps the float32 parity.
* The body table: its "tf32x3" keys are the source's instantiations, each
  tile's shared memory (the source's ``smem_bytes``) fits one block, the
  K and V fragment reads of the padded rows fall on 32 distinct banks, an
  off-table call raises on the CPU, and the new launcher refuses CPU
  tensors; the library is built and bound with the C prototype's
  arguments.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import flash_attention as jax_flash
from audax_torch.ops import KERNELS, native
from audax_torch.ops import attention as att

from .csrc_constexpr import CSRC, constexpr_function
from .tf32x3_lanes import G, T, a_from_c, mma3, split, tf32

NEG = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
BQ, WARPS = 64, 4


def kernel_schedule(q, k, v, *, causal=False, kv_len=None, bk=64,
                    passes=3):
    """``flash_fwd_tf32x3_kernel`` in numpy, one warp at a time: q [B, Hq,
    Tq, D], k/v [B, Hkv, Tk, D] float32 -> (o, lse [B*Hq, Tq])."""
    b, hq, tq, d = q.shape
    group, tk = hq // k.shape[1], k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    ks, nt_ = d // 8, bk // 8
    qscale = np.float32(d ** -0.5) * LOG2E
    n_tiles = -(-kv_len // bk)
    o = np.zeros_like(q)
    lse = np.zeros((b * hq, tq), np.float32)
    for bh in range(b * hq):
        bi, h = divmod(bh, hq)
        # K/V as staged: rows past kv_len zero-filled, never read
        rows = n_tiles * bk
        kst, vst = (np.zeros((rows, d), np.float32) for _ in range(2))
        kst[:kv_len] = k[bi, h // group, :kv_len]
        vst[:kv_len] = v[bi, h // group, :kv_len]
        qp = np.zeros((-(-tq // BQ) * BQ, d), np.float32)
        qp[:tq] = q[bi, h] * qscale
        for q0 in range(0, tq, BQ):
            tiles = min(n_tiles, (q0 + BQ - 1) // bk + 1) if causal \
                else n_tiles
            for w in range(WARPS):
                w0 = q0 + 16 * w
                r0 = w0 + G
                qa = [np.stack([qp[r0, 8 * kk + T], qp[r0 + 8, 8 * kk + T],
                                qp[r0, 8 * kk + T + 4],
                                qp[r0 + 8, 8 * kk + T + 4]], 1)
                      for kk in range(ks)]
                m = np.full((32, 2), NEG, np.float32)
                lpart = np.zeros((32, 2), np.float32)
                acc = np.zeros((ks, 32, 4), np.float32)
                for tile in range(tiles):
                    k0 = tile * bk
                    if causal and k0 > w0 + 15:
                        continue
                    kt, vt = kst[k0: k0 + bk], vst[k0: k0 + bk]
                    s = np.zeros((nt_, 32, 4), np.float32)
                    for kk in range(ks):
                        for nt in range(nt_):
                            bfr = np.stack([kt[8 * nt + G, 8 * kk + T],
                                            kt[8 * nt + G, 8 * kk + T + 4]],
                                           1)
                            s[nt] = mma3(s[nt], qa[kk], bfr, passes)
                    if k0 + bk > kv_len or (causal and k0 + bk - 1 > w0):
                        i = np.arange(4)
                        col = (k0 + 8 * np.arange(nt_)[:, None, None]
                               + 2 * T[None, :, None] + (i & 1))
                        row = r0[None, :, None] + 8 * (i >> 1)
                        s[(col >= kv_len) | (causal & (col > row))] = NEG
                    for hh in range(2):
                        vals = s[:, :, 2 * hh: 2 * hh + 2]
                        mx = vals.max(axis=(0, 2))
                        mx = np.repeat(mx.reshape(8, 4).max(1), 4)   # quad
                        m_new = np.maximum(m[:, hh], mx)
                        alpha = np.exp2(m[:, hh] - m_new)
                        mu = np.where(m_new == NEG, np.float32(0), m_new)
                        p = np.exp2(vals - mu[None, :, None])
                        s[:, :, 2 * hh: 2 * hh + 2] = p
                        lpart[:, hh] = lpart[:, hh] * alpha + p.sum((0, 2))
                        m[:, hh] = m_new
                        acc[:, :, 2 * hh: 2 * hh + 2] *= alpha[None, :, None]
                    for j in range(nt_):
                        afr = a_from_c(s[j])            # k permuted
                        for nd in range(ks):
                            bfr = np.stack([vt[8 * j + 2 * T, 8 * nd + G],
                                            vt[8 * j + 2 * T + 1, 8 * nd + G]],
                                           1)
                            acc[nd] = mma3(acc[nd], afr, bfr, passes)
                lt = np.repeat(lpart.reshape(8, 4, 2).sum(1), 4, axis=0)
                for hh in range(2):
                    row = r0 + 8 * hh
                    ok = row < tq
                    ls = np.where(lt[:, hh] == 0, np.float32(1), lt[:, hh])
                    for nd in range(ks):
                        for e in range(2):
                            o[bi, h, row[ok], 8 * nd + 2 * T[ok] + e] = (
                                acc[nd][ok, 2 * hh + e] / ls[ok])
                    lse[bh, row[ok]] = np.where(
                        lt[ok, hh] == 0, NEG,
                        m[ok, hh] * LN2 + np.log(lt[ok, hh]))
    return o, lse


#: (hq, hkv, tq, tk, causal, kv_len) at batch 1
CASES = {
    "mha": (2, 2, 130, 130, False, None),
    "causal_gqa": (2, 1, 130, 130, True, None),
    "cross": (2, 2, 56, 130, False, None),
    "ragged_kv_len": (2, 2, 130, 160, False, 137),
}


def _inputs(seed, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, hq, tq, d), (1, hkv, tk, d), (1, hkv, tk, d)))


def _plain(q, k, v, causal, kv_len):
    kv = k.shape[2] if kv_len is None else kv_len
    o, lse = att.flash_forward_plain(
        *(torch.from_numpy(a) for a in (q, k[:, :, :kv], v[:, :, :kv])),
        causal=causal)
    return o.numpy(), lse.numpy()


def _err(got, ref):
    return max(float(np.abs(g - r).max()) for g, r in zip(got, ref))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_equals_the_plain_version(case, d):
    hq, hkv, tq, tk, causal, kv_len = CASES[case]
    q, k, v = _inputs(d + len(case), hq, hkv, tq, tk, d)
    got = kernel_schedule(q, k, v, causal=causal, kv_len=kv_len)
    assert _err(got, _plain(q, k, v, causal, kv_len)) <= 1e-5


@pytest.mark.parametrize("bk", [32, 128])
def test_schedule_at_the_caller_set_key_tiles(bk):
    q, k, v = _inputs(bk, 2, 2, 130, 160, 64)
    for causal, kv_len, kk, vv in ((False, 137, k, v),
                                   (True, None, k[:, :, :130], v[:, :, :130])):
        got = kernel_schedule(q, kk, vv, causal=causal, kv_len=kv_len, bk=bk)
        assert _err(got, _plain(q, kk, vv, causal, kv_len)) <= 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax_flash(case):
    hq, hkv, tq, tk, causal, kv_len = CASES[case]
    q, k, v = _inputs(7 + len(case), hq, hkv, tq, tk, 64)
    kv = tk if kv_len is None else kv_len
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k[:, :, :kv]),
                               jnp.asarray(v[:, :, :kv]), causal=causal,
                               interpret=True))
    o, _ = kernel_schedule(q, k, v, causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(o, ref, atol=1e-4, rtol=0)


def test_one_tf32_pass_is_ten_times_worse_than_three():
    q, k, v = _inputs(3, 2, 2, 130, 130, 64)
    ref = _plain(q, k, v, False, None)
    three = _err(kernel_schedule(q, k, v), ref)
    one = _err(kernel_schedule(q, k, v, passes=1), ref)
    assert three <= 1e-5 and one >= 10 * three and one > 1e-4


def test_tf32_rounding_and_split():
    x = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                  1 + 2 ** -12, 3.14159265], np.float32)
    big, small = split(x)
    # ties go away from zero; below a half ulp rounds down
    np.testing.assert_array_equal(
        big[:5], np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -9,
                           -(1 + 2 ** -10), 1.0], np.float32))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    # big + small holds x to about 21 bits
    assert np.abs(big.astype(np.float64) + small - x).max() <= 2 ** -20


# ---- the body table, the source and the launcher ----------------------------

def _source():
    return (CSRC / "flash_fwd_tf32x3.cu").read_text()


def test_body_table_matches_the_source_and_fits_shared_memory():
    built = {tuple(map(int, m)) for m in re.findall(
        r"AUDAX_TF32X3\((\d+), (\d+), (\d+)\)", _source())}
    table = {(d,) + tile for (_, d, tile, _), body in att.FWD_BODIES.items()
             if body == "tf32x3"}
    assert table == built
    assert all(dt == torch.float32 and fold == 1 and tile[0] == 64
               for (dt, d, tile, fold), body in att.FWD_BODIES.items()
               if body == "tf32x3")
    smem = constexpr_function("flash_fwd_tf32x3.cu", "smem_bytes")
    assert all(smem(d, bk) <= 232448 for d, _, bk in built)
    assert smem(64, 64) == 2 * 2 * 64 * 68 * 4


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_padded_rows_keep_fragment_reads_free_of_bank_conflicts(d):
    dp = d + 4
    k_banks = (G * dp + T) % 32                 # K: row g, column t
    v_banks = ((2 * T) * dp + G) % 32           # V: rows 2t, 2t + 1, col g
    v1_banks = ((2 * T + 1) * dp + G) % 32
    for banks in (k_banks, (k_banks + 4) % 32, v_banks, v1_banks):
        assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("call", [
    (64, 64, 256), (64, 32, 64), (16, 64, 128), (128, 128, 64),
], ids=str)
def test_off_table_float32_calls_raise_on_cpu(call):
    d, bq, bk = call
    q = torch.zeros(1, 2, 20, d)
    if (torch.float32, d, (bq, bk), 1) in att.FWD_BODIES:
        assert att.FWD_BODIES[(torch.float32, d, (bq, bk), 1)] != "tf32x3"
        return
    before = att.flash_forward_plain.launches
    with pytest.raises(ValueError):
        att.flash_forward(q, q, q, block_q=bq, block_k=bk)
    assert att.flash_forward_plain.launches == before


def test_launcher_refuses_cpu_tensors_and_counts_apart():
    q = torch.zeros(1, 2, 20, 64)
    before = att.flash_forward_tf32x3_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_forward_tf32x3_cuda(q, q, q)
    assert att.flash_forward_tf32x3_cuda.launches == before
    assert KERNELS["flash_forward_tf32x3"] == (att.flash_forward_tf32x3_cuda,
                                               att.flash_forward_plain)
    # a CPU tensor at a tf32x3 tile takes the plain version
    plain = att.flash_forward_plain.launches
    att.flash_forward(q, q, q)
    assert att.flash_forward_plain.launches == plain + 1
    assert att.flash_forward_tf32x3_cuda.launches == before


def test_library_is_bound_with_the_c_prototype():
    assert native.KERNEL_SOURCES["flash_fwd_tf32x3"] == "flash_fwd_tf32x3.cu"
    proto = re.search(r"int flash_fwd_tf32x3\(([^)]*)\)", _source())[1]
    argtypes, _ = native.SIGNATURES["flash_fwd_tf32x3"]["flash_fwd_tf32x3"]
    assert len(argtypes) == len(proto.split(","))
    assert "tf32x3.cuh" in _source()
