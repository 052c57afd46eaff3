"""Port int8-KV decode (K3's int8 arm, K6) and ragged decode vs the JAX package.

``quantize_kv`` codes and scales are bit-identical to JAX's. The plain
versions of K3's int8 arm (``decode_attention_stacked`` with a ``QuantKV``)
and of K6 (``decode_attention``, float and int8) are held against the JAX
Pallas kernels in interpret mode at 1e-5 (float32). ``decode_step_ragged``
and ``decode_span`` logits agree with JAX at 1e-4 for float weights with
float KV, for int8 KV, and for int4 weights with int8 KV, with slots at
different depths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.models import quantize as JQ
from audax.models import whisper as JW
from audax.ops.attention import decode_attention as jax_decode1
from audax.ops.attention import decode_attention_stacked as jax_decode
from audax_torch.models import quantize as Q
from audax_torch.models import whisper as W
from audax_torch.ops import attention as A

from .whisper_pair import model as make_model

TOL = 1e-5
TOL_LOGITS = 1e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 3, 4, 7, 32), (3, 5, 16)])
def test_quantize_kv_bit_identical(rng, shape):
    k, v = _randn(rng, *shape), _randn(rng, *shape)
    k[..., 2, :] = 0.0                     # an all-zero vector hits the floor
    ref = JW.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    ours = W.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.k_q.dtype == torch.int8 and ours.k_scale.dtype == torch.float32


def _quant_cache(rng, lead, s_len, d):
    k, v = _randn(rng, *lead, s_len, d), _randn(rng, *lead, s_len, d)
    jq = JW.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    return jq, W.QuantKV(*(_t(a) for a in jq))


@pytest.mark.parametrize("pos_kind", ["vector", "scalar", "none"])
@pytest.mark.parametrize("h,hkv,tq", [(4, 4, 1), (4, 2, 3)],
                         ids=["mha", "gqa"])
def test_decode_stacked_int8_matches_jax(rng, pos_kind, h, hkv, tq):
    n_layers, b, s_len, d = 2, 3, 24, 16
    q = _randn(rng, b, h, tq, d)
    jkv, kv = _quant_cache(rng, (n_layers, b, hkv), s_len, d)
    pos = {"vector": np.asarray([0, 9, 20], np.int32), "scalar": 7,
           "none": None}[pos_kind]
    before = A.decode_attention_stacked_int8_plain.launches
    for layer in range(n_layers):
        ref = np.asarray(jax_decode(
            jnp.asarray(q), tuple(jkv), layer,
            pos=None if pos is None else jnp.asarray(pos),
            backend="pallas", interpret=True))
        pos_t = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        ours = A.decode_attention_stacked(torch.from_numpy(q), kv, layer,
                                          pos=pos_t)
        np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)
    assert A.decode_attention_stacked_int8_plain.launches == before + n_layers


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("pos", [None, 11])
def test_decode_attention_k6_matches_jax(rng, quant, pos):
    b, h, hkv, tq, s_len, d = 2, 4, 2, 2, 20, 32
    q = _randn(rng, b, h, tq, d)
    if quant:
        jkv, kv = _quant_cache(rng, (b, hkv), s_len, d)
        jkv = tuple(jkv)
    else:
        k, v = _randn(rng, b, hkv, s_len, d), _randn(rng, b, hkv, s_len, d)
        jkv, kv = (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))
    ref = np.asarray(jax_decode1(jnp.asarray(q), jkv, pos=pos,
                                 backend="pallas", interpret=True))
    before = A.decode_attention_plain.launches
    ours = A.decode_attention(torch.from_numpy(q), kv, pos=pos)
    assert A.decode_attention_plain.launches == before + 1
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


def test_attention_kv_cached_takes_k6(rng):
    """``whisper.attention(kv_cached=)`` without a mask goes through K6 (on
    CPU tensors its plain version) and matches the JAX package; a QuantKV
    with a mask raises as in JAX."""
    jcfg, jparams, _, cfg, params = make_model(d_model=64, heads=2,
                                               decoder_layers=1)
    x = _randn(rng, 2, 1, 64)
    enc = _randn(rng, 2, 50, 64)
    jkv = JW.precompute_cross_kv(jparams, jcfg, jnp.asarray(enc), quant=True)
    jlayer = {k: {n: a[0] for n, a in v.items()}
              for k, v in jparams["decoder"]["layers"]["cross_attn"].items()}
    one = JW.QuantKV(*(a[0] for a in jkv))
    ref = np.asarray(JW.attention(jlayer, jnp.asarray(x), 2, kv_cached=one))
    layer = W.layer_params(params["decoder"]["layers"]["cross_attn"], 0)
    kv = W.QuantKV(*(_t(a[0]) for a in jkv))
    before = A.decode_attention_plain.launches
    got = W.attention(layer, torch.from_numpy(x), 2, kv_cached=kv)
    assert A.decode_attention_plain.launches == before + 1
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="QuantKV"):
        W.attention(layer, torch.from_numpy(x), 2, kv_cached=kv,
                    mask=torch.ones(1, 1, 1, 50, dtype=torch.bool))


@pytest.fixture(scope="module")
def model():
    return make_model(d_model=64, heads=2, encoder_layers=1,
                      decoder_layers=2, n_text_ctx=32)


def _trees(model, weights):
    jcfg, jparams, _, cfg, params = model
    if weights == "float":
        return jparams, params
    bits = 4 if weights == "int4" else 8
    return (JQ.quantize_tree(jparams, bits=bits),
            Q.quantize_tree(params, bits=bits))


@pytest.mark.parametrize("weights,kv_quant", [("float", False),
                                              ("float", True),
                                              ("int4", True)],
                         ids=["float-floatkv", "float-int8kv", "int4-int8kv"])
def test_decode_step_ragged_and_span_match_jax(model, rng, weights,
                                               kv_quant):
    jcfg, _, _, cfg, _ = model
    jp, tp = _trees(model, weights)
    b, max_len, steps = 3, 16, 6
    enc = _randn(rng, b, cfg.n_audio_ctx, cfg.d_model)
    jkv = JW.precompute_cross_kv(jp, jcfg, jnp.asarray(enc), quant=kv_quant)
    kv = W.precompute_cross_kv(tp, cfg, torch.from_numpy(enc),
                               quant=kv_quant)
    for a, r in zip(kv, jkv):                   # codes equal or float close
        if a.dtype == torch.int8:
            # a code may sit on a rounding edge: allow one step of the code
            assert int((a.long() - _t(r).long()).abs().max()) <= 1
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=TOL,
                                       rtol=1e-5)
    kv = type(kv)(*(_t(a) for a in jkv)) if kv_quant else \
        tuple(_t(a) for a in jkv)            # share the JAX cross K/V
    toks = rng.integers(0, cfg.vocab_size, size=(b, max_len))
    # ragged: slot b starts its request at step start[b]
    start = np.asarray([0, 2, 4])
    jcache = JW.init_kv_cache(jcfg, b, max_len, quant=kv_quant)
    cache = W.init_kv_cache(cfg, b, max_len, device="cpu", quant=kv_quant)
    for step in range(steps):
        pos = np.maximum(step - start, 0).astype(np.int32)
        tok = toks[np.arange(b), pos]
        jl, jcache = JW.decode_step_ragged(jp, jcfg, jnp.asarray(tok),
                                           jnp.asarray(pos), jcache, jkv)
        lg, cache = W.decode_step_ragged(tp, cfg, torch.from_numpy(tok),
                                         torch.from_numpy(pos), cache, kv)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=TOL_LOGITS, rtol=0,
                                   err_msg=f"ragged step {step}")
    # teacher-forced span of 3 tokens per slot after a 2-token prefix
    jcache = JW.init_kv_cache(jcfg, b, max_len, quant=kv_quant)
    cache = W.init_kv_cache(cfg, b, max_len, device="cpu", quant=kv_quant)
    for pos, kk in ((0, 2), (2, 3)):
        span = toks[:, pos: pos + kk]
        jl, jcache = JW.decode_span(jp, jcfg, jnp.asarray(span),
                                    jnp.int32(pos), jcache, jkv)
        lg, cache = W.decode_span(tp, cfg, torch.from_numpy(span), pos,
                                  cache, kv)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=TOL_LOGITS, rtol=0,
                                   err_msg=f"span at {pos}")
