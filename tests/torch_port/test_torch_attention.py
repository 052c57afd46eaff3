"""Port attention plain versions vs the JAX Pallas kernels (interpret mode).

``flash_forward_plain`` (the CPU side of kernel K2) against
``flash_attention(interpret=True)``, and ``decode_attention_stacked_plain``
(K3) against ``decode_attention_stacked(backend="pallas", interpret=True)``,
on the same numpy inputs, at 1e-5 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.ops.attention import decode_attention_stacked as jax_decode
from audax.ops.attention import flash_attention as jax_flash
from audax_torch.ops.attention import (decode_attention_stacked,
                                       decode_attention_stacked_plain,
                                       flash_attention, flash_forward,
                                       flash_forward_plain)

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
    q = torch.from_numpy(_randn(rng, 1, 2, 1, 16))
    kv = torch.zeros(1, 1, 2, 4, 16)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        decode_attention_stacked_plain(q, (kv, kv, kv, kv), 0)
