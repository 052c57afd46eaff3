"""K7's and K8's float32 bodies on the tensor cores
(``csrc/flash_bwd_tf32x3.cu``) on the CPU, where nothing can launch.

* Both schedules, transcribed into numpy lane by lane, every warp of every
  block at once: the m16n8k8 fragment maps, 3xTF32 in the kernel's order
  (``tf32x3_lanes.py``), ``load_b_t`` and ``load_b_rows_perm``, and the C
  fragment as the next A fragment in ``a_from_c``'s permuted k order;
  each n-tile of dQ, dK and dV summed over a slice from zero and then added
  to its accumulator (on the card that keeps the tensor core's truncating
  accumulation off the long sums; numpy rounds every sum to nearest).
  K7 per (b*hq, 64 query rows): Q's and dO's fragments, lse and delta per
  row, key tiles of ``block_k`` in slices of ``dq_slice`` keys, a warp's
  slices above its rows skipped, masks only on the slices that cross Tk or
  the diagonal. K8 computed transposed per (b*hkv, 64 keys): K's and V's
  fragments, the loop over the group's q heads and their query tiles from
  the first causal tile, slices of ``dkv_slice`` queries with lse and delta
  per column, a slice wholly before a warp's keys skipped, masks only on
  the slices that cross Tq or the diagonal. The slices are the source's
  (``csrc_constexpr.py``). Rows past Tq and Tk are filled once with zeros,
  as the kernels' copies fill them, and once with junk: the masks alone
  must keep it out. At head dims 16/32/64/128 with causal, GQA, cross and
  ragged cases, and at the caller-set tiles of head_dim 64, both equal
  ``flash_backward_{dq,dkv}_plain`` within 1e-5 of the plain gradient's
  largest value: a wrong map or permutation moves a gradient by O(1).
* The same inputs through ``jax.grad`` of the JAX package's flash attention
  (its Pallas kernels in interpret mode, as the JAX tests run them) within
  1e-4.
* One TF32 pass instead of three is at least 10x worse (fixed seed).
* The source: ``BWD_BODIES``' "tf32x3" keys are its instantiations in each
  ``-D`` build, each tile's shared memory (``dq_smem`` / ``dkv_smem``) fits
  one block, the padded fragment reads fall on 32 distinct banks; the
  launchers refuse CPU and bf16 tensors and count apart; the libraries are
  bound with the C prototypes' arguments.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import flash_attention as jax_flash
from audax_torch.ops import KERNELS, native
from audax_torch.ops import attention as att

from .csrc_constexpr import CSRC, constexpr_function, instantiated
from .tf32x3_lanes import G, T, a_from_c, mma3

SOURCE = "flash_bwd_tf32x3.cu"
LOG2E = np.float32(1.4426950408889634)
BR, WARPS = 64, 4
I4 = np.arange(4)
#: the schedules against the plain versions, relative to the largest value
TOL_SCHEDULE = 1e-5
#: against JAX's gradients (both float32, different summation orders)
TOL_JAX = 1e-4
dq_slice = constexpr_function(SOURCE, "dq_slice")
dkv_slice = constexpr_function(SOURCE, "dkv_slice")


def _staged(x, rows, valid, junk):
    """x [n, ...] as a kernel sees it: ``rows`` rows, those at or past
    ``valid`` zero (the copies' zero-fill, the fragment loads' 0) or, with
    ``junk``, drawn from it."""
    out = np.zeros((rows,) + x.shape[1:], np.float32)
    out[:valid] = x[:valid]
    if junk is not None:
        out[valid:] = junk.standard_normal(out[valid:].shape)
    return out


def _a_frags(x, idx, row0, ks):
    """Each warp's A fragments of its 16 rows from row0 [W] of x [N, rows,
    D] (``a_frag``), one [W, 32, 4] array per k-step."""
    i, r = idx[:, None], row0[:, None] + G
    return [np.stack([x[i, r, 8 * kk + T], x[i, r + 8, 8 * kk + T],
                      x[i, r, 8 * kk + T + 4], x[i, r + 8, 8 * kk + T + 4]],
                     -1) for kk in range(ks)]


def _b_t(x, n0, k0):
    """``load_b_t`` of each warp's tile x [W, rows, D]."""
    return np.stack([x[:, n0 + G, k0 + T], x[:, n0 + G, k0 + T + 4]], -1)


def _b_rows_perm(x, k0, n0):
    """``load_b_rows_perm`` of each warp's tile x [W, rows, D]."""
    return np.stack([x[:, k0 + 2 * T, n0 + G],
                     x[:, k0 + 2 * T + 1, n0 + G]], -1)


def _store(out, idx, row0, acc, n):
    """Each warp's C fragments acc [W, D/8, 32, 4] into out [N, n, D] at
    rows row0 + g and row0 + g + 8 (those below n), columns 8 nd + 2t and
    + 1."""
    for h in range(2):
        r = row0[:, None] + G + 8 * h
        ok = r < n
        i = np.broadcast_to(idx[:, None], r.shape)
        for nd in range(acc.shape[1]):
            for e in range(2):
                col = np.broadcast_to(8 * nd + 2 * T + e, r.shape)
                out[i[ok], r[ok], col[ok]] = acc[:, nd, :, 2 * h + e][ok]


def k7_schedule(q, k, v, do, lse, delta, *, causal=False, bk=64, passes=3,
                junk=None):
    """``flash_bwd_dq_tf32x3_kernel`` in numpy: q, do [B, Hq, Tq, D], k, v
    [B, Hkv, Tk, D], lse, delta [B*Hq, Tq] float32 -> dq."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    group, ks, sk = hq // hkv, d // 8, dq_slice(d, bk)
    nt_ = sk // 8
    scale = np.float32(d ** -0.5)
    nqb, n_tiles = -(-tq // BR), -(-tk // bk)
    bh, qb, w = (a.ravel() for a in np.meshgrid(
        np.arange(b * hq), np.arange(nqb), np.arange(WARPS), indexing="ij"))
    bkv = (bh // hq) * hkv + (bh % hq) // group
    w0 = qb * BR + 16 * w                     # each warp's first row
    rows = w0[:, None] + G                    # its rows r0 (and r0 + 8)

    def stage(x, n, valid):
        return np.stack([_staged(a, n, valid, junk) for a in x])

    qp = stage(q.reshape(b * hq, tq, d), nqb * BR, tq)
    op = stage(do.reshape(b * hq, tq, d), nqb * BR, tq)
    lp, dlp = (stage(a, nqb * BR, tq) for a in (lse, delta))
    kst = stage(k.reshape(b * hkv, tk, d), n_tiles * bk, tk)
    vst = stage(v.reshape(b * hkv, tk, d), n_tiles * bk, tk)
    qa, oa = _a_frags(qp, bh, w0, ks), _a_frags(op, bh, w0, ks)
    l2 = np.stack([lp[bh[:, None], rows + 8 * h] for h in range(2)],
                  -1) * LOG2E                 # [W, 32, 2]
    dl = np.stack([dlp[bh[:, None], rows + 8 * h] for h in range(2)], -1)
    tiles = np.full(len(w0), n_tiles)
    if causal:
        tiles = np.minimum(tiles, (qb * BR + BR - 1) // bk + 1)
    acc = np.zeros((len(w0), ks, 32, 4), np.float32)
    for tile in range(n_tiles):
        for sub in range(bk // sk):
            c0 = tile * bk + sub * sk
            run = (tile < tiles) & ~(causal & (c0 > w0 + 15))
            if not run.any():
                continue
            kt, vt = kst[bkv, c0:c0 + sk], vst[bkv, c0:c0 + sk]
            s = np.zeros((len(w0), nt_, 32, 4), np.float32)
            dp = np.zeros_like(s)
            for kk in range(ks):
                for nt in range(nt_):
                    s[:, nt] = mma3(s[:, nt], qa[kk], _b_t(kt, 8 * nt, 8 * kk),
                                    passes)
                    dp[:, nt] = mma3(dp[:, nt], oa[kk],
                                     _b_t(vt, 8 * nt, 8 * kk), passes)
            with np.errstate(over="ignore", invalid="ignore"):
                p = np.exp2(s * (scale * LOG2E) - l2[:, None, :, I4 >> 1])
                masked = (c0 + sk > tk) | (causal & (c0 + sk - 1 > w0))
                col = (c0 + 8 * np.arange(nt_)[:, None, None]
                       + 2 * T[:, None] + (I4 & 1))
                row = rows[:, None, :, None] + 8 * (I4 >> 1)
                kill = masked[:, None, None, None] & (
                    (col >= tk) | (causal & (col > row)))
                p = np.where(kill, np.float32(0), p)
                ds = p * (dp - dl[:, None, :, I4 >> 1]) * scale
            a = [a_from_c(ds[:, j]) for j in range(nt_)]
            for nd in range(ks):        # summed over the slice, then added
                c = np.zeros((len(w0), 32, 4), np.float32)
                for j in range(nt_):
                    c = mma3(c, a[j], _b_rows_perm(kt, 8 * j, 8 * nd), passes)
                acc[:, nd] = np.where(run[:, None, None], acc[:, nd] + c,
                                      acc[:, nd])
    dq = np.zeros((b * hq, tq, d), np.float32)
    _store(dq, bh, w0, acc, tq)
    return dq.reshape(q.shape)


def k8_schedule(q, k, v, do, lse, delta, *, causal=False, bq=64, passes=3,
                junk=None):
    """``flash_bwd_dkv_tf32x3_kernel`` in numpy, transposed: same operands
    as ``k7_schedule`` -> (dk, dv)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    group, ks = hq // hkv, d // 8
    sq = min(dkv_slice(d), bq)
    nq_ = sq // 8
    scale = np.float32(d ** -0.5)
    nkb, n_qt = -(-tk // BR), -(-tq // bq)
    bkv, kb, w = (a.ravel() for a in np.meshgrid(
        np.arange(b * hkv), np.arange(nkb), np.arange(WARPS), indexing="ij"))
    kw0 = kb * BR + 16 * w                    # each warp's first key
    keys = kw0[:, None] + G                   # its keys r0 (and r0 + 8)

    def stage(x, n, valid):
        return np.stack([_staged(a, n, valid, junk) for a in x])

    ka = _a_frags(stage(k.reshape(b * hkv, tk, d), nkb * BR, tk), bkv, kw0,
                  ks)
    va = _a_frags(stage(v.reshape(b * hkv, tk, d), nkb * BR, tk), bkv, kw0,
                  ks)
    qst = stage(q.reshape(b * hq, tq, d), n_qt * bq, tq)
    ost = stage(do.reshape(b * hq, tq, d), n_qt * bq, tq)
    lst, dst = (stage(a, n_qt * bq, tq) for a in (lse, delta))
    first = kb * BR // bq if causal else np.zeros_like(kb)
    acc_k = np.zeros((len(kw0), ks, 32, 4), np.float32)
    acc_v = np.zeros_like(acc_k)
    cl = 8 * np.arange(nq_)[:, None, None] + 2 * T[:, None] + (I4 & 1)
    for g in range(group):
        bh = (bkv // hkv) * hq + (bkv % hkv) * group + g
        for qt in range(n_qt):
            for sub in range(bq // sq):
                c0 = qt * bq + sub * sq
                if c0 >= tq:
                    break
                run = (qt >= first) & ~(causal & (kw0 > c0 + sq - 1))
                if not run.any():
                    continue
                qs, os_ = qst[bh, c0:c0 + sq], ost[bh, c0:c0 + sq]
                ls, dls = lst[bh, c0:c0 + sq], dst[bh, c0:c0 + sq]
                s = np.zeros((len(kw0), nq_, 32, 4), np.float32)
                dp = np.zeros_like(s)
                for kk in range(ks):
                    for nt in range(nq_):
                        s[:, nt] = mma3(s[:, nt], ka[kk],
                                        _b_t(qs, 8 * nt, 8 * kk), passes)
                        dp[:, nt] = mma3(dp[:, nt], va[kk],
                                         _b_t(os_, 8 * nt, 8 * kk), passes)
                with np.errstate(over="ignore", invalid="ignore"):
                    p = np.exp2(s * (scale * LOG2E) - ls[:, cl] * LOG2E)
                    masked = (c0 + sq > tq) | (causal & (kw0 + 15 > c0))
                    key = keys[:, None, :, None] + 8 * (I4 >> 1)
                    kill = masked[:, None, None, None] & (
                        (c0 + cl >= tq) | (causal & (key > c0 + cl)))
                    p = np.where(kill, np.float32(0), p)
                    ds = p * (dp - dls[:, cl]) * scale
                for acc, x, src in ((acc_v, p, os_), (acc_k, ds, qs)):
                    a = [a_from_c(x[:, j]) for j in range(nq_)]
                    for nd in range(ks):    # summed over the slice, then added
                        c = np.zeros((len(kw0), 32, 4), np.float32)
                        for j in range(nq_):
                            c = mma3(c, a[j], _b_rows_perm(src, 8 * j, 8 * nd),
                                     passes)
                        acc[:, nd] = np.where(run[:, None, None],
                                              acc[:, nd] + c, acc[:, nd])
    dk = np.zeros((b * hkv, tk, d), np.float32)
    dv = np.zeros_like(dk)
    _store(dk, bkv, kw0, acc_k, tk)
    _store(dv, bkv, kw0, acc_v, tk)
    return dk.reshape(k.shape), dv.reshape(v.shape)


#: (hq, hkv, tq, tk, causal) at batch 1: Tq and Tk off the 64-row tiles
CASES = {
    "mha": (2, 2, 130, 130, False),
    "causal_gqa": (4, 2, 130, 130, True),
    "cross": (2, 2, 56, 130, False),
    "ragged": (2, 2, 100, 77, False),
}


def _inputs(seed, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, hq, tq, d), (1, hkv, tk, d), (1, hkv, tk, d),
                           (1, hq, tq, d)))


def _plain(q, k, v, do, causal):
    """The forward's lse, delta and the plain gradients (dq, dk, dv)."""
    tq_, tk_, tv_, to_ = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = att.flash_forward_plain(tq_, tk_, tv_, causal=causal)
    delta = att._delta(o, to_)
    dq, dk, dv = att.flash_backward_plain(tq_, tk_, tv_, o, lse, to_,
                                          causal=causal)
    return lse.numpy(), delta.numpy(), (dq.numpy(), dk.numpy(), dv.numpy())


def _rel(got, ref):
    return max(float(np.abs(g - r).max()) / float(np.abs(r).max())
               for g, r in zip(got, ref))


def _run(kernel, q, k, v, do, lse, delta, causal, tile=64, **kw):
    if kernel == "dq":
        return (k7_schedule(q, k, v, do, lse, delta, causal=causal, bk=tile,
                            **kw),)
    return k8_schedule(q, k, v, do, lse, delta, causal=causal, bq=tile, **kw)


@pytest.mark.parametrize("fill", ["zeros", "junk"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_schedule_equals_the_plain_version(kernel, case, d, fill):
    hq, hkv, tq, tk, causal = CASES[case]
    q, k, v, do = _inputs(d + len(case), hq, hkv, tq, tk, d)
    lse, delta, ref = _plain(q, k, v, do, causal)
    junk = np.random.default_rng(1) if fill == "junk" else None
    got = _run(kernel, q, k, v, do, lse, delta, causal, junk=junk)
    ref = ref[:1] if kernel == "dq" else ref[1:]
    assert _rel(got, ref) <= TOL_SCHEDULE


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_schedule_at_the_caller_set_tiles(kernel, tile):
    """K7 at block_k 32 and 128, K8 at block_q 32 and 128 (head_dim 64)."""
    for causal, hkv, tq, tk in ((False, 2, 100, 77), (True, 1, 150, 150)):
        q, k, v, do = _inputs(tile + tq, 2, hkv, tq, tk, 64)
        lse, delta, ref = _plain(q, k, v, do, causal)
        ref = ref[:1] if kernel == "dq" else ref[1:]
        for junk in (None, np.random.default_rng(2)):
            got = _run(kernel, q, k, v, do, lse, delta, causal, tile,
                       junk=junk)
            assert _rel(got, ref) <= TOL_SCHEDULE


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedules_match_jax_grad(case):
    hq, hkv, tq, tk, causal = CASES[case]
    q, k, v, do = _inputs(5 + len(case), hq, hkv, tq, tk, 64)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, interpret=True)
                       * do)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    lse, delta, _ = _plain(q, k, v, do, causal)
    got = (_run("dq", q, k, v, do, lse, delta, causal)
           + _run("dkv", q, k, v, do, lse, delta, causal))
    for a, r, name in zip(got, ref, "qkv"):
        r = np.asarray(r)
        err = float(np.abs(a - r).max())
        assert err <= TOL_JAX * float(np.abs(r).max()), f"d{name}: {err}"


def test_one_tf32_pass_is_ten_times_worse_than_three():
    q, k, v, do = _inputs(3, 2, 2, 130, 130, 64)
    lse, delta, ref = _plain(q, k, v, do, False)
    for kernel, r in (("dq", ref[:1]), ("dkv", ref[1:])):
        three = _rel(_run(kernel, q, k, v, do, lse, delta, False), r)
        one = _rel(_run(kernel, q, k, v, do, lse, delta, False, passes=1),
                   r)
        assert three <= TOL_SCHEDULE and one >= 10 * three and one > 1e-4


# ---- the body table, the source and the launchers ---------------------------

@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_body_table_matches_the_source_and_fits_shared_memory(kernel):
    macro = "AUDAX_DQ_TF32X3" if kernel == "dq" else "AUDAX_DKV_TF32X3"
    built = instantiated(SOURCE, macro, kernel)
    table = {(d,) + tile for (kn, dt, d, tile), body in att.BWD_BODIES.items()
             if kn == kernel and body == "tf32x3"}
    assert table == built
    assert all(dt == torch.float32 for (kn, dt, _, _), body in
               att.BWD_BODIES.items() if body == "tf32x3")
    # K7's blocks hold 64 query rows, K8's 64 keys
    assert {t[1 if kernel == "dq" else 2] for t in built} == {64}
    smem = constexpr_function(SOURCE, f"{kernel}_smem")
    tiles = {(d, bk if kernel == "dq" else bq) for d, bq, bk in built}
    assert all(smem(d, n) <= 232448 for d, n in tiles)
    assert smem(64, 64) == (2 * 2 * 64 * 68 * 4 if kernel == "dq"
                            else 2 * 2 * 64 * 69 * 4)
    # the slices divide every tile they are cut from
    for d, n in tiles:
        s = dq_slice(d, n) if kernel == "dq" else min(dkv_slice(d), n)
        assert n % s == 0 and s % 8 == 0


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_padded_rows_keep_fragment_reads_free_of_bank_conflicts(d):
    dp = d + 4
    t_banks = (G * dp + T) % 32                 # load_b_t: row g, column t
    p_banks = ((2 * T) * dp + G) % 32           # load_b_rows_perm: rows 2t,
    p1_banks = ((2 * T + 1) * dp + G) % 32      # 2t + 1, column g
    for banks in (t_banks, (t_banks + 4) % 32, p_banks, p1_banks):
        assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_launchers_refuse_cpu_and_bf16_tensors_and_count_apart(kernel):
    fn = getattr(att, f"flash_backward_{kernel}_tf32x3_cuda")
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 40, 64, generator=g)
    lse = torch.zeros(2, 40)
    before = fn.launches
    with pytest.raises(ValueError, match="float32"):
        fn(*(q.to(torch.bfloat16),) * 4, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, q, q, q, lse, lse)
    assert fn.launches == before
    assert KERNELS[f"flash_backward_{kernel}_tf32x3"] == (
        fn, getattr(att, f"flash_backward_{kernel}_plain"))
    # a CPU tensor at a tf32x3 tile takes the plain version
    plain = getattr(att, f"flash_backward_{kernel}_plain")
    n = plain.launches
    att.flash_backward(q, q, q, q, lse, q)
    assert plain.launches == n + 1 and fn.launches == before


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_library_is_bound_with_the_c_prototype(kernel):
    name = f"flash_bwd_{kernel}_tf32x3"
    assert native.KERNEL_SOURCES[name] == SOURCE
    assert native.DEFINES[name] == (f"-DAUDAX_FLASH_BWD_{kernel.upper()}",)
    text = (CSRC / SOURCE).read_text()
    proto = re.search(rf"int {name}\(([^)]*)\)", text)[1]
    argtypes, _ = native.SIGNATURES[name][name]
    assert len(argtypes) == len(proto.split(","))
    assert "tf32x3.cuh" in text
