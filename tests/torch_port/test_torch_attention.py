"""Port attention plain versions vs the JAX Pallas kernels (interpret mode).

``flash_forward_plain`` (the CPU side of kernel K2) against
``flash_attention(interpret=True)``, and ``decode_attention_stacked_plain``
(K3) against ``decode_attention_stacked(backend="pallas", interpret=True)``,
on the same numpy inputs, at 1e-5 in float32. The gradients of the port's
differentiable ``flash_attention`` (K7/K8's plain versions) against
``jax.grad`` of the Pallas backward at atol 5e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import decode_attention_stacked as jax_decode
from audax.ops.attention import flash_attention as jax_flash
from audax_torch.ops.attention import (decode_attention_stacked,
                                       decode_attention_stacked_plain,
                                       dot_product_attention,
                                       flash_applicable, flash_attention,
                                       flash_backward_dkv_plain,
                                       flash_backward_dq_plain,
                                       flash_backward_plain, flash_forward,
                                       flash_forward_plain, xla_attention)

TOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hq,hkv,tq,tk,causal", [
    (2, 2, 40, 40, False),        # MHA
    (4, 2, 24, 37, False),        # GQA, ragged Tk
    (4, 1, 48, 48, True),         # causal GQA
    (2, 2, 21, 21, True),         # causal, ragged
])
def test_flash_plain_matches_jax(rng, hq, hkv, tq, tk, causal):
    q, k, v = _randn(rng, 2, hq, tq, 16), _randn(rng, 2, hkv, tk, 16), \
        _randn(rng, 2, hkv, tk, 16)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, interpret=True))
    o, lse = flash_forward_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), ref, atol=TOL, rtol=0)
    # logsumexp of the scaled scores, from numpy in float64
    group = hq // hkv
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, group, 1).astype(np.float64)) * 16 ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((tq, tk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(-1, tq),
                               atol=TOL, rtol=0)


def test_flash_attention_takes_plain_version_on_cpu(rng):
    q = torch.from_numpy(_randn(rng, 1, 2, 8, 16))
    before = flash_forward_plain.launches
    out = flash_attention(q, q, q)
    assert flash_forward_plain.launches == before + 1
    torch.testing.assert_close(out, flash_forward(q, q, q)[0])


@pytest.mark.parametrize("pos_kind", ["vector", "scalar", "none"])
@pytest.mark.parametrize("h,hkv,tq", [(4, 4, 1), (4, 2, 3)])
def test_decode_plain_matches_jax(rng, pos_kind, h, hkv, tq):
    n_layers, b, s_len, d = 2, 3, 24, 16
    q = _randn(rng, b, h, tq, d)
    k = _randn(rng, n_layers, b, hkv, s_len, d)
    v = _randn(rng, n_layers, b, hkv, s_len, d)
    pos = {"vector": np.asarray([0, 9, 20], np.int32), "scalar": 7,
           "none": None}[pos_kind]
    for layer in range(n_layers):
        ref = np.asarray(jax_decode(
            jnp.asarray(q), (jnp.asarray(k), jnp.asarray(v)), layer,
            pos=None if pos is None else jnp.asarray(pos),
            backend="pallas", interpret=True))
        pos_t = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        ours = decode_attention_stacked(
            torch.from_numpy(q), (torch.from_numpy(k), torch.from_numpy(v)),
            layer, pos=pos_t)
        np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


def test_decode_quant_kv_not_in_this_slice(rng):
    """The int8 QuantKV arm, refused before the serving slice, now takes
    its own plain version: int8 codes with unit scales attend exactly as
    the same values in float32 (the JAX parity of the arm is in
    ``test_torch_decode_quant.py``)."""
    q = torch.from_numpy(_randn(rng, 1, 2, 1, 16))
    codes = torch.from_numpy(rng.integers(-127, 128, (1, 1, 2, 4, 16))
                             ).to(torch.int8)
    ones = torch.ones(1, 1, 2, 4)
    got = decode_attention_stacked_plain(q, (codes, ones, codes, ones), 0,
                                         pos=2)
    ref = decode_attention_stacked_plain(q, (codes.float(), codes.float()), 0,
                                         pos=2)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------- backward --

@pytest.mark.parametrize("causal,gqa,ragged", [
    (False, 1, False), (True, 1, False), (True, 4, False), (False, 2, True)])
def test_flash_grads_match_jax_pallas(rng, causal, gqa, ragged):
    """Gradients through the port's differentiable ``flash_attention`` (CPU
    tensors: K2/K7/K8's plain versions) against ``jax.grad`` of the Pallas
    kernels in interpret mode, on the cases of the JAX package's own
    gradient test."""
    tq = 72 if ragged else 64
    tk = tq if causal or not ragged else 50
    q, k, v = (_randn(rng, 2, 4, tq, 32), _randn(rng, 2, 4 // gqa, tk, 32),
               _randn(rng, 2, 4 // gqa, tk, 32))
    w = _randn(rng, 2, 4, tq, 32)          # cotangent-shaping weights

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, interpret=True,
                                 block_q=32, block_k=32) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = (flash_backward_dq_plain.launches,
              flash_backward_dkv_plain.launches)
    out = flash_attention(qt, kt, vt, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt, kt, vt))
    assert (flash_backward_dq_plain.launches,
            flash_backward_dkv_plain.launches) == (before[0] + 1,
                                                   before[1] + 1)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=1e-4, err_msg=f"d{name} mismatch")
    # the plain backward called directly, from the forward's o and lse
    o, lse = flash_forward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal)
    direct = flash_backward_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  o, lse, torch.from_numpy(w), causal=causal)
    for a, b in zip(direct, got):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_flash_backward_casts_like_the_tpu_kernels(rng):
    """bfloat16: dS is rounded to K's dtype before dS K and P to dO's before
    P^T dO, so the plain version's bf16 gradients sit within bf16 rounding
    of the float32 ones and come back in bfloat16."""
    q, k, v, do = (torch.from_numpy(_randn(rng, 1, 2, 32, 16))
                   for _ in range(4))
    o, lse = flash_forward_plain(q, k, v)
    ref = flash_backward_plain(q, k, v, o, lse, do)
    bf = [t.bfloat16() for t in (q, k, v, o)]
    got = flash_backward_plain(*bf, lse, do.bfloat16())
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= 2e-2 * scale


def test_dot_product_attention_dispatch(rng):
    """The flash path wherever ``flash_applicable`` holds (the TPU rule),
    the materialised twin for a mask or fewer than 16 rows; the twin
    matches the JAX ``xla_attention`` with its mask."""
    from audax.ops.attention import xla_attention as jax_xla

    q, k, v = (_randn(rng, 2, 4, 24, 16), _randn(rng, 2, 2, 40, 16),
               _randn(rng, 2, 2, 40, 16))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    n0 = flash_forward_plain.launches
    out = dot_product_attention(qt, kt, vt)
    assert flash_forward_plain.launches == n0 + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), atol=TOL, rtol=0)

    mask = rng.random((2, 1, 24, 40)) > 0.3
    mask[..., 0] = True
    out = dot_product_attention(qt, kt, vt, mask=torch.from_numpy(mask))
    short = dot_product_attention(qt[:, :, :8], kt, vt)
    assert flash_forward_plain.launches == n0 + 1          # both took the twin
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask))), atol=TOL, rtol=0)
    torch.testing.assert_close(short, xla_attention(qt[:, :, :8], kt, vt))
    assert flash_applicable((1, 8, 16, 64), (1, 8, 16, 64), None, True)
    assert not flash_applicable((1, 8, 16, 64), (1, 8, 20, 64), None, True)
