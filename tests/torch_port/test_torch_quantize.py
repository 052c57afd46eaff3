"""Port weight-only quantization (``models/quantize.py``) vs the JAX package.

The port's ``quantize_tree`` of the float tree must equal the JAX package's
leaf for leaf (same keys, equal integer codes and scales), and the bridge
must carry a JAX-quantized tree to the same tensors. ``dense``,
``embed_lookup`` and ``embed_logits`` on quantized leaves agree with JAX at
1e-5 (float32, another summation order); ``tree_bytes`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.models import quantize as JQ
from audax.models import whisper as JW
from audax_torch.models import quantize as Q
from audax_torch.models import whisper as W
from audax_torch.models.bridge import params_from_numpy

from .whisper_pair import model as make_model

TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return make_model(d_model=64, heads=2, encoder_layers=1,
                      decoder_layers=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_jax_leaf_for_leaf(model, bits):
    jcfg, jparams, tree, cfg, params = model
    ref = jax.tree.map(np.asarray, JQ.quantize_tree(jparams, bits=bits))
    ours = Q.quantize_tree(params, bits=bits)
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys()
    for path, t in a.items():
        want = b[path]
        if path.startswith("/encoder/conv"):
            continue              # layout differs by design (bridge test)
        if "_q" in path.rsplit("/", 1)[-1]:
            assert t.dtype == (torch.uint8 if path.endswith("_q4")
                               else torch.int8), path
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
    # the bridge carries the JAX-quantized tree to the same tensors
    bridged = _flat(params_from_numpy(ref, cfg, device="cpu"))
    assert bridged.keys() == a.keys()
    for path, t in a.items():
        assert bridged[path].dtype == t.dtype, path
        torch.testing.assert_close(bridged[path], t, rtol=0, atol=0)
    assert Q.tree_bytes(ours) == JQ.tree_bytes(JQ.quantize_tree(jparams,
                                                                bits=bits))
    assert Q.tree_bytes(params) == JQ.tree_bytes(jparams)


def test_quantize_tree_refuses_other_bits(model):
    with pytest.raises(ValueError, match="bits"):
        Q.quantize_tree(model[4], bits=3)


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_and_embeddings_match_jax(model, rng, bits):
    jcfg, jparams, tree, cfg, params = model
    jq = JQ.quantize_tree(jparams, bits=bits)
    ours = Q.quantize_tree(params, bits=bits)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    for li in range(cfg.decoder_layers):
        for name in ("q", "k"):                       # with and without bias
            jp = jax.tree.map(lambda t: t[li],
                              jq["decoder"]["layers"]["attn"][name])
            ref = np.asarray(JW.dense(jp, jnp.asarray(x)))
            got = W.dense(W.layer_params(ours["decoder"]["layers"]["attn"]
                                         [name], li), torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    idx = rng.integers(0, cfg.vocab_size, size=(2, 4))
    ref = np.asarray(JQ.embed_lookup(jq["decoder"], jnp.asarray(idx),
                                     jnp.float32))
    got = Q.embed_lookup(ours["decoder"], torch.from_numpy(idx),
                         torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    ref = np.asarray(JQ.embed_logits(jq["decoder"], jnp.asarray(x)))
    got = W.embed_logits(ours["decoder"], torch.from_numpy(x))
    assert got.shape == (3, 5, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=TOL * max(1.0, float(np.abs(ref).max())),
                               rtol=0)


def test_quantized_encoder_and_decode_train_match_jax(model, rng):
    """Whole int4 and int8 trees through the encoder and the teacher-forced
    decoder: every dense projection dispatches on its leaves."""
    jcfg, jparams, tree, cfg, params = model
    mel = rng.standard_normal((1, 100, 80)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 6))
    for bits in (8, 4):
        jq = JQ.quantize_tree(jparams, bits=bits)
        ours = Q.quantize_tree(params, bits=bits)
        jenc = JW.encode(jq, jcfg, jnp.asarray(mel))
        enc = W.encode(ours, cfg, torch.from_numpy(mel))
        np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=1e-4,
                                   rtol=0)
        ref = np.asarray(JW.decode_train(jq, jcfg, jnp.asarray(toks), jenc))
        got = W.decode_train(ours, cfg, torch.from_numpy(toks),
                             torch.from_numpy(np.array(jenc)))
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4,
                                   rtol=0)
