"""Port Whisper model and decoding vs the JAX package on the CPU.

Same JAX-initialised parameters (through the weight bridge) and the same
numpy inputs go through both packages at a small width (d_model 32, 2 heads,
2+2 layers, n_audio_ctx 64). Float32 encoder states and logits agree to
1e-4; greedy ``generate`` is token-exact, with suppression, SuppressBlank,
timestamp rules and ``no_speech_prob`` (to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.decode import TimestampRules as JaxRules
from audax.infer.decode import generate as jax_generate
from audax.models import whisper as JW
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer.decode import TimestampRules, generate
from audax_torch.models import whisper as W
from audax_torch.models.bridge import params_from_numpy

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    tok = JaxTokenizer(jax_train_bpe(["hello world how are you"] * 4,
                                     vocab_size=280))
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=64, d_model=32,
                            encoder_layers=2, decoder_layers=2, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=48)
    jparams = JW.init_whisper_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(tree, cfg, device="cpu")
    return tok, jcfg, jparams, tree, cfg, params


def _mel(rng, b=2):
    return rng.standard_normal((b, 128, 80)).astype(np.float32)


def test_bridge_layouts(model):
    _, _, _, tree, cfg, params = model
    conv = tree["encoder"]["conv1"]["kernel"]                 # HIO
    np.testing.assert_array_equal(
        params["encoder"]["conv1"]["kernel"].numpy(), conv.transpose(2, 1, 0))
    q = params["decoder"]["layers"]["cross_attn"]["q"]["kernel"]
    assert q.shape == (cfg.decoder_layers, cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(
        q.numpy(), tree["decoder"]["layers"]["cross_attn"]["q"]["kernel"])
    bad = {"encoder": {"conv1": {"kernel_q": np.zeros(3)}}}
    with pytest.raises(NotImplementedError):
        params_from_numpy(bad, cfg, device="cpu")


def test_own_init_matches_jax_layout(model):
    _, _, _, tree, cfg, params = model
    mine = W.init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    flat = lambda t, p="": ({p: t} if not isinstance(t, dict) else  # noqa: E731
                            {k: v for n, c in t.items()
                             for k, v in flat(c, f"{p}/{n}").items()})
    a, b = flat(mine), flat(params)
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape for k in a)


def test_encode_and_cross_kv_match_jax(model, rng):
    _, jcfg, jparams, _, cfg, params = model
    mel = _mel(rng)
    ref = np.asarray(JW.encode(jparams, jcfg, jnp.asarray(mel)))
    enc = W.encode(params, cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), ref, atol=TOL, rtol=0)
    jk, jv = JW.precompute_cross_kv(jparams, jcfg, jnp.asarray(ref))
    k, v = W.precompute_cross_kv(params, cfg, torch.tensor(ref))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)


def test_decode_step_logits_match_jax(model, rng):
    tok, jcfg, jparams, _, cfg, params = model
    mel = _mel(rng)
    jenc = JW.encode(jparams, jcfg, jnp.asarray(mel))
    enc = torch.tensor(np.asarray(jenc))
    seq = rng.integers(0, tok.vocab_size, size=(2, 6))
    jkv = JW.precompute_cross_kv(jparams, jcfg, jenc)
    jcache = JW.init_kv_cache(jcfg, 2, 8)
    kv = W.precompute_cross_kv(params, cfg, enc)
    cache = W.init_kv_cache(cfg, 2, 8, device="cpu")
    for pos in range(seq.shape[1]):
        jl, jcache = JW.decode_step(jparams, jcfg,
                                    jnp.asarray(seq[:, pos], jnp.int32),
                                    jnp.int32(pos), jcache, jkv)
        lg, cache = W.decode_step(params, cfg, torch.from_numpy(seq[:, pos]),
                                  pos, cache, kv)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("timestamps", [False, True])
def test_greedy_generate_token_exact(model, rng, timestamps):
    tok, jcfg, jparams, _, cfg, params = model
    mel = _mel(rng)
    jenc = JW.encode(jparams, jcfg, jnp.asarray(mel))
    prompt = np.asarray([tok.sot_sequence(timestamps=timestamps)] * 2,
                        np.int32)
    suppress = np.asarray([i for i in tok.special_ids() if i != tok.eot],
                          np.int32)
    first = np.asarray(sorted(set(tok.encode(" ") + [tok.eot])), np.int32)
    kw = dict(max_len=30, eos_id=tok.eot, no_speech_id=tok.no_speech,
              no_speech_pos=0)
    ref = jax_generate(
        jparams, jcfg, jenc, jnp.asarray(prompt), suppress=jnp.asarray(suppress),
        first_suppress=jnp.asarray(first),
        timestamps=(JaxRules(tok.timestamp_begin, tok.eot)
                    if timestamps else None), **kw)
    out = generate(
        params, cfg, torch.tensor(np.asarray(jenc)),
        torch.from_numpy(prompt), suppress=torch.from_numpy(suppress),
        first_suppress=torch.from_numpy(first),
        timestamps=(TimestampRules(tok.timestamp_begin, tok.eot)
                    if timestamps else None), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(out.gen_count.numpy(),
                                  np.asarray(ref.gen_count))
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.sum_logprob.numpy(),
                               np.asarray(ref.sum_logprob), atol=1e-4,
                               rtol=1e-5)
    if timestamps:
        gen = out.tokens[0, prompt.shape[1]]
        assert int(gen) >= tok.timestamp_begin     # opens with a timestamp


def test_sampling_is_deterministic_per_seed(model, rng):
    tok, _, _, _, cfg, params = model
    enc = W.encode(params, cfg, torch.from_numpy(_mel(rng)))
    prompt = torch.tensor([tok.sot_sequence()] * 2)

    def run(seed):
        return generate(params, cfg, enc, prompt, max_len=20, eos_id=tok.eot,
                        temperature=1.0,
                        generator=torch.Generator().manual_seed(seed)).tokens

    assert torch.equal(run(3), run(3))
    greedy = generate(params, cfg, enc, prompt, max_len=20, eos_id=tok.eot)
    assert not torch.equal(run(3), greedy.tokens)
