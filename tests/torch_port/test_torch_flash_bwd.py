"""K7/K8, the flash backward: the bodies' table, the bf16 gradients against
the JAX package, and the bf16 tensor-core bodies' schedules transcribed
into numpy (the float32 body's are ``test_torch_flash_bwd_tf32x3.py``'s).

* ``BWD_BODIES`` against the instantiations of ``csrc/flash_bwd_sm90.cu``
  (the wgmma bodies), ``csrc/flash_bwd_tf32x3.cu`` (the 3xTF32 bodies) and
  ``csrc/flash_bwd.cu`` (the CUDA-core bodies), each library read as its
  ``-DAUDAX_FLASH_BWD_DQ`` / ``-DAUDAX_FLASH_BWD_DKV`` build sees it, with
  every wgmma tile within one block's shared memory (``dq_smem`` /
  ``dkv_smem`` read from the source); ``bwd_body`` and ``resolve_tile``
  route K7 by its query rows and K8 by its keys -- bf16 at 64 or 128 to
  wgmma, float32 at 64 to 3xTF32, the rest to the CUDA cores -- and calls
  off the table raise the same ``ValueError`` on the CPU as on the card;
  the wgmma launchers take bf16 CUDA tensors only.
* bf16 gradients of the port's ``flash_attention`` (CPU tensors: K7/K8's
  plain versions) against ``jax.grad`` of the Pallas kernels in interpret
  mode, in bf16, on the cases of the float32 test in
  ``test_torch_attention.py``, at 2e-2 of the largest gradient: dS and P
  are rounded to bf16 once before their products on both sides.
* The schedules of ``csrc/flash_bwd_sm90.cu`` in numpy -- K7's key tiles
  and 64-key slices with the causal skip, K8's transposed loop over the
  group's q heads and query tiles from its first causal tile, each
  warp group's slices and their column masks (Tq tail, Tk tail, diagonal),
  zero-filled tiles and padded head dims -- at head dims 16/32/64/128 with
  Tq and Tk off the tiles, against the plain versions to 1e-5 in float32.
  Rows past Tq and Tk are filled once with zeros, as the kernels' copies
  fill them, and once with junk: the masks alone must keep them out.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import flash_attention as jax_flash
from audax_torch.ops import attention as att

from .csrc_constexpr import constexpr_function, instantiated

CSRC = Path(__file__).resolve().parents[2] / "audax_torch" / "csrc"
BF16 = torch.bfloat16
#: bf16 gradients against JAX's: one bf16 rounding of dS and P (2^-8
#: relative) summed over the keys, against the largest gradient
TOL_BF16 = 2e-2
#: the numpy schedules against the plain versions, float32
TOL_SCHEDULE = 1e-5


# ---- the body table ------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_body_table_matches_the_sources_and_fits_shared_memory(kernel):
    big = "DQ" if kernel == "dq" else "DKV"
    wgmma = instantiated("flash_bwd_sm90.cu", f"AUDAX_{big}90", kernel)
    tf32x3 = instantiated("flash_bwd_tf32x3.cu", f"AUDAX_{big}_TF32X3",
                          kernel)
    core = instantiated("flash_bwd.cu", "AUDAX_BWD", kernel)
    table = {body: {(d,) + tile
                    for (kn, _, d, tile), b in att.BWD_BODIES.items()
                    if kn == kernel and b == body}
             for body in ("cuda_core", "tf32x3", "wgmma")}
    assert table["wgmma"] == wgmma
    assert table["tf32x3"] == tf32x3
    # the CUDA-core body is built, in either dtype, at every caller-set
    # tile of head_dim 64 (bf16 takes its 32-row ones, float32 those off
    # the 3xTF32 body; chip_smoke.py's A/B of the bodies calls it at 64 x
    # 64 in both dtypes)
    assert table["cuda_core"] <= core
    assert {(64,) + tile for tile in att.TILES} <= core
    # every float32 call has a body built for it
    assert {(d,) + tile for (kn, dt, d, tile) in att.BWD_BODIES
            if kn == kernel and dt == torch.float32} <= tf32x3 | core
    smem = constexpr_function("flash_bwd_sm90.cu", f"{kernel}_smem")
    assert all(smem(*t) <= 232448 for t in wgmma)


@pytest.mark.parametrize("tile", att.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_bf16_routes_by_rows_and_keys_float32_to_the_cuda_cores(tile):
    """bf16 takes wgmma at 64 or 128 rows, float32 the 3xTF32 body at 64
    rows (K7's query rows, K8's keys); the rest goes to the CUDA cores."""
    bq, bk = tile
    assert att.bwd_body("dq", BF16, 64, bq, bk) == (
        "wgmma" if bq >= 64 else "cuda_core")
    assert att.bwd_body("dkv", BF16, 64, bq, bk) == (
        "wgmma" if bk >= 64 else "cuda_core")
    assert att.bwd_body("dq", torch.float32, 64, bq, bk) == (
        "tf32x3" if bq == 64 else "cuda_core")
    assert att.bwd_body("dkv", torch.float32, 64, bq, bk) == (
        "tf32x3" if bk == 64 else "cuda_core")
    for kernel in ("dq", "dkv"):
        assert att.resolve_tile(kernel, 64, bq, bk, dtype=BF16) == tile


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_defaults_per_dtype_and_head_dim(d):
    for kernel in ("dq", "dkv"):
        assert att.resolve_tile(kernel, d, dtype=BF16) == att.BWD_WGMMA_TILE
        assert att.bwd_body(kernel, BF16, d) == "wgmma"
        assert att.bwd_body(kernel, torch.float32, d) == "tf32x3"
        assert att.resolve_tile(kernel, d) == (64, 64)


def _qkv(d, dtype, tq=40):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 2, tq, d, generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("kernel,dtype,d,tile", [
    ("dq", BF16, 128, (64, 32)), ("dkv", BF16, 128, (64, 32)),
    ("dq", BF16, 32, (128, 64)), ("dkv", BF16, 16, (32, 64)),
    ("dq", torch.float32, 128, (64, 128)), ("dkv", BF16, 64, (64, 256)),
], ids=str)
def test_backward_calls_off_the_table_raise_before_dispatch(kernel, dtype, d,
                                                             tile):
    with pytest.raises(ValueError):
        att.bwd_body(kernel, dtype, d, *tile)
    q, k, v = _qkv(d, dtype)
    lse = torch.zeros(2, 40)
    before = (att.flash_backward_dq_plain.launches,
              att.flash_backward_dkv_plain.launches,
              att.flash_forward_plain.launches)
    with pytest.raises(ValueError):
        att.flash_backward(q, k, v, q, lse, q, block_q=tile[0],
                           block_k=tile[1])
    with pytest.raises(ValueError):
        att.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    assert before == (att.flash_backward_dq_plain.launches,
                      att.flash_backward_dkv_plain.launches,
                      att.flash_forward_plain.launches)


def test_bwd_body_names_its_kernels_and_head_dims():
    with pytest.raises(ValueError, match="kernel"):
        att.bwd_body("fwd", BF16, 64)
    with pytest.raises(ValueError, match="no body"):
        att.bwd_body("dq", BF16, 8)


@pytest.mark.parametrize("fn", [att.flash_backward_dq_wgmma_cuda,
                                att.flash_backward_dkv_wgmma_cuda,
                                att.flash_backward_dq_cuda,
                                att.flash_backward_dkv_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    q, k, v = _qkv(64, BF16)
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, v, q, torch.zeros(2, 40), q)


@pytest.mark.parametrize("fn", [att.flash_backward_dq_wgmma_cuda,
                                att.flash_backward_dkv_wgmma_cuda])
def test_wgmma_launchers_take_bf16_cuda_tensors_only(fn):
    q, k, v = _qkv(64, torch.float32)
    lse = torch.zeros(2, 40)
    with pytest.raises(ValueError, match="bf16"):
        fn(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*(t.to(BF16) for t in (q, k, v, q)), lse, lse)


# ---- bf16 gradients against JAX ------------------------------------------------

@pytest.mark.parametrize("causal,gqa,ragged", [
    (False, 1, False), (True, 1, False), (True, 4, False), (False, 2, True)])
def test_bf16_grads_match_jax_pallas(causal, gqa, ragged):
    """bf16 gradients through the port's differentiable ``flash_attention``
    (K7/K8's plain versions) against ``jax.grad`` of the Pallas kernels in
    interpret mode, both sides in bf16 on the same numpy inputs."""
    rng = np.random.default_rng(8)
    tq = 72 if ragged else 64
    tk = tq if causal or not ragged else 50
    shapes = ((2, 4, tq, 32), (2, 4 // gqa, tk, 32), (2, 4 // gqa, tk, 32))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    w = rng.standard_normal((2, 4, tq, 32)).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, interpret=True, block_q=32,
                        block_k=32)
        return jnp.sum(out.astype(jnp.float32) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).to(BF16).requires_grad_(True)
                  for a in (q, k, v))
    out = att.flash_attention(qt, kt, vt, causal=causal)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              (qt, kt, vt))
    for a, b, name in zip(got, ref, "qkv"):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - b).max())
        assert err <= TOL_BF16 * float(np.abs(b).max()), f"d{name}: {err}"


# ---- the tensor-core schedules in numpy -------------------------------------------

def _tile(x, r0, rows, valid, dp, junk):
    """Rows [r0, r0 + rows) of a [T, D] matrix as the kernel stages them:
    the head dim zero-padded to ``dp``; rows at or past ``valid`` zero (the
    copy's zero-fill) or, with ``junk``, drawn from it."""
    t = np.zeros((rows, dp), np.float32)
    n = max(0, min(rows, valid - r0))
    t[:n, :x.shape[1]] = x[r0:r0 + n]
    if junk is not None:
        t[n:, :x.shape[1]] = junk.standard_normal((rows - n, x.shape[1]))
    return t


def _rows(x, r0, rows, valid, junk):
    """Rows of a per-row float32 vector (lse, delta) as staged: 0 past
    ``valid``, or junk."""
    t = np.zeros(rows, np.float32)
    n = max(0, min(rows, valid - r0))
    t[:n] = x[r0:r0 + n]
    if junk is not None:
        t[n:] = junk.standard_normal(rows - n)
    return t


def _k7_schedule(q, k, v, do, lse, delta, causal, scale, bq, bk, junk=None):
    """``flash_bwd_dq_sm90_kernel``: per (b*hq, bq query rows) block, Q and
    dO staged once, the K/V tiles of bk keys, each warp group's 64 rows
    against 64-key slices (bk at 32), a slice above the group's diagonal
    ending the tile, masks only on a slice that crosses Tk or the
    diagonal."""
    b_, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    group, dp, sk = hq // hkv, max(d, 64), min(bk, 64)
    dq = np.zeros_like(q)
    for bh in range(b_ * hq):
        b, h = divmod(bh, hq)
        for q0 in range(0, tq, bq):
            qt = _tile(q[b, h], q0, bq, tq, dp, junk)
            ot = _tile(do[b, h], q0, bq, tq, dp, junk)
            lr = _rows(lse[bh], q0, bq, tq, junk)
            dl = _rows(delta[bh], q0, bq, tq, junk)
            acc = np.zeros((bq, dp), np.float32)
            n_tiles = math.ceil(tk / bk)
            if causal:
                n_tiles = min(n_tiles, (q0 + bq - 1) // bk + 1)
            for j in range(n_tiles):
                kt = _tile(k[b, h // group], j * bk, bk, tk, dp, junk)
                vt = _tile(v[b, h // group], j * bk, bk, tk, dp, junk)
                for wg in range(bq // 64):
                    row_lo, r = q0 + 64 * wg, slice(64 * wg, 64 * wg + 64)
                    for sub in range(bk // sk):
                        c0 = j * bk + sub * sk
                        if causal and c0 > row_lo + 63:
                            break
                        ks = kt[sub * sk:(sub + 1) * sk]
                        vs = vt[sub * sk:(sub + 1) * sk]
                        s, dpv = qt[r] @ ks.T, ot[r] @ vs.T
                        with np.errstate(over="ignore"):
                            p = np.exp(s * scale - lr[r, None])
                        if c0 + sk > tk or (causal and c0 + sk - 1 > row_lo):
                            cols = c0 + np.arange(sk)[None]
                            rows = row_lo + np.arange(64)[:, None]
                            p[(cols >= tk) | (causal & (cols > rows))] = 0.0
                        ds = p * (dpv - dl[r, None]) * scale
                        acc[r] += ds @ ks
            n = min(bq, tq - q0)
            dq[b, h, q0:q0 + n] = acc[:n, :d]
    return dq


def _k8_schedule(q, k, v, do, lse, delta, causal, scale, bq, bk, junk=None):
    """``flash_bwd_dkv_sm90_kernel``, transposed: per (b*hkv, bk keys)
    block, K and V staged once, a loop over the group's q heads and their
    bq-row query tiles from ``k0 // bq`` when causal, each warp group's 64
    keys against slices of 64 query rows (32 at bq 32 or head dim 128),
    S^T = K Q^T with lse and delta per column, a slice wholly before the
    group's keys skipped, masks only on a slice that crosses Tq, Tk or the
    diagonal."""
    b_, hq, tq, d = q.shape
    hkv, tk = k.shape[1:3]
    group, dp = hq // hkv, max(d, 64)
    sq = 32 if d == 128 or bq < 64 else 64
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bkv in range(b_ * hkv):
        b, hk = divmod(bkv, hkv)
        for k0 in range(0, tk, bk):
            kt = _tile(k[b, hk], k0, bk, tk, dp, junk)
            vt = _tile(v[b, hk], k0, bk, tk, dp, junk)
            acc_k = np.zeros((bk, dp), np.float32)
            acc_v = np.zeros((bk, dp), np.float32)
            first_qt = k0 // bq if causal else 0
            nq = math.ceil(tq / bq) - first_qt
            for it in range(group * nq):
                h = hk * group + it // nq
                q0 = (first_qt + it % nq) * bq
                qt = _tile(q[b, h], q0, bq, tq, dp, junk)
                ot = _tile(do[b, h], q0, bq, tq, dp, junk)
                ls = _rows(lse[b * hq + h], q0, bq, tq, junk)
                dl = _rows(delta[b * hq + h], q0, bq, tq, junk)
                for wg in range(bk // 64):
                    key_lo, r = k0 + 64 * wg, slice(64 * wg, 64 * wg + 64)
                    for sub in range(bq // sq):
                        c0 = q0 + sub * sq
                        if causal and key_lo > c0 + sq - 1:
                            continue
                        c = slice(sub * sq, (sub + 1) * sq)
                        st, dpt = kt[r] @ qt[c].T, vt[r] @ ot[c].T
                        with np.errstate(over="ignore"):
                            p = np.exp(st * scale - ls[None, c])
                        if (c0 + sq > tq or key_lo + 64 > tk
                                or (causal and key_lo + 63 > c0)):
                            cols = c0 + np.arange(sq)[None]
                            keys = key_lo + np.arange(64)[:, None]
                            p[(cols >= tq) | (keys >= tk)
                              | (causal & (keys > cols))] = 0.0
                        ds = p * (dpt - dl[None, c]) * scale
                        acc_v[r] += p @ ot[c]
                        acc_k[r] += ds @ qt[c]
            n = min(bk, tk - k0)
            dk[b, hk, k0:k0 + n] = acc_k[:n, :d]
            dv[b, hk, k0:k0 + n] = acc_v[:n, :d]
    return dk, dv


def _schedule_cases():
    cases = []
    for d in (16, 32, 64, 128):
        tiles = {"dq": [att.BWD_WGMMA_TILE], "dkv": [att.BWD_WGMMA_TILE]}
        if d == 64:
            tiles = {kn: sorted(t for (k_, dt, dd, t), b in
                                att.BWD_BODIES.items()
                                if k_ == kn and dt == BF16 and dd == 64
                                and b == "wgmma")
                     for kn in ("dq", "dkv")}
        for kernel, ts in tiles.items():
            for tile in ts:
                for causal, hkv, tq, tk in ((False, 2, 100, 77),
                                            (True, 1, 150, 150)):
                    cases.append((kernel, d, tile, causal, hkv, tq, tk))
    return cases


@pytest.mark.parametrize("kernel,d,tile,causal,hkv,tq,tk", _schedule_cases(),
                         ids=str)
def test_wgmma_schedules_match_the_plain_versions(kernel, d, tile, causal,
                                                  hkv, tq, tk):
    rng = np.random.default_rng(d + tq)
    q, do = (rng.standard_normal((1, 4, tq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, tk, d)).astype(np.float32)
            for _ in range(2))
    tq_, tk_, tv_, to_ = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = att.flash_forward_plain(tq_, tk_, tv_, causal=causal)
    delta = att._delta(o, to_).numpy()
    scale = d ** -0.5
    if kernel == "dq":
        ref = [att.flash_backward_dq_plain(tq_, tk_, tv_, o, lse, to_,
                                           causal=causal).numpy()]
        run = _k7_schedule
    else:
        ref = [t.numpy() for t in att.flash_backward_dkv_plain(
            tq_, tk_, tv_, o, lse, to_, causal=causal)]
        run = _k8_schedule
    for junk in (None, np.random.default_rng(1)):
        got = run(q, k, v, do, lse.numpy(), delta, causal, scale, *tile,
                  junk=junk)
        got = got if isinstance(got, tuple) else (got,)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a, r, atol=TOL_SCHEDULE,
                                       rtol=TOL_SCHEDULE)
