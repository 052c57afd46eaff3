"""Port ``generate_speculative`` vs the JAX package's, on the CPU.

The target and draft are the JAX speculative tests' (``tests/
test_speculative.py``: d_model 32 with 2+2 layers, and 16 with 1+1, vocab
120), JAX-initialised and bridged. Tokens, lengths and generated counts must
equal the JAX function's and the port's own greedy ``generate``'s exactly;
sum-logprobs within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.speculative import generate_speculative as jax_spec
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer.decode import generate
from audax_torch.infer.speculative import generate_speculative
from audax_torch.infer.transcribe import Transcriber
from audax_torch.models.bridge import params_from_numpy
from audax_torch.models.whisper import encode
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer

TARGET = JaxWhisperConfig(n_mels=8, n_audio_ctx=32, d_model=32,
                          encoder_layers=2, decoder_layers=2, heads=2,
                          vocab_size=120, n_text_ctx=64)
DRAFT = JaxWhisperConfig(n_mels=8, n_audio_ctx=32, d_model=16,
                         encoder_layers=1, decoder_layers=1, heads=2,
                         vocab_size=120, n_text_ctx=64)


def _bridge(jcfg, key):
    jparams = init_whisper_params(jcfg, jax.random.key(key))
    cfg = WhisperConfig(**jcfg.asdict())
    return jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    jt, tcfg, pt = _bridge(TARGET, 0)
    jd, dcfg, pd = _bridge(DRAFT, 1)
    mel = np.random.default_rng(7).standard_normal((1, 64, 8))
    mel = mel.astype(np.float32)
    jenc, jdenc = jencode(jt, TARGET, jnp.asarray(mel)), jencode(
        jd, DRAFT, jnp.asarray(mel))
    enc = encode(pt, tcfg, torch.from_numpy(mel))
    denc = encode(pd, dcfg, torch.from_numpy(mel))
    return dict(jax=(jt, jd, jenc, jdenc), port=(pt, pd, enc, denc),
                cfg=(tcfg, dcfg))


def _run(models, *, perfect=False, spec_tokens=4, prompt=(5, 9), **kw):
    """(JAX result, port result, port greedy generate, accepted per pass)."""
    jt, jd, jenc, jdenc = models["jax"]
    pt, pd, enc, denc = models["port"]
    tcfg, dcfg = models["cfg"]
    if perfect:
        jd, jdenc, pd, denc, dcfg, jdraft = jt, jenc, pt, enc, tcfg, TARGET
    else:
        jdraft = DRAFT
    jkw = {k: (jnp.asarray(v, jnp.int32) if k.endswith("suppress") else v)
           for k, v in kw.items()}
    ref = jax_spec(jd, jt, jdraft, TARGET, jdenc, jenc,
                   jnp.asarray([prompt], jnp.int32), spec_tokens=spec_tokens,
                   **jkw)
    accepted = []
    ours = generate_speculative(pd, pt, dcfg, tcfg, denc, enc,
                                torch.tensor([prompt]),
                                spec_tokens=spec_tokens, accepted=accepted,
                                **kw)
    greedy = generate(pt, tcfg, enc, torch.tensor([prompt]),
                      **{k: v for k, v in kw.items()})
    return ref, ours, greedy, accepted


def _same(ref, ours, greedy):
    n = int(ours.lengths[0])
    assert n == int(ref.lengths[0]) == int(greedy.lengths[0])
    np.testing.assert_array_equal(ours.tokens[0, :n].numpy(),
                                  np.asarray(ref.tokens[0, :n]))
    assert torch.equal(ours.tokens[0, :n], greedy.tokens[0, :n])
    assert int(ours.gen_count[0]) == int(ref.gen_count[0]) == \
        int(greedy.gen_count[0])
    np.testing.assert_allclose(ours.sum_logprob.numpy(),
                               np.asarray(ref.sum_logprob), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(ours.sum_logprob.numpy(),
                               greedy.sum_logprob.numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("spec_tokens", [2, 4, 8])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_kv", "int8_kv"])
def test_speculative_token_exact(models, spec_tokens, kv_quant):
    ref, ours, greedy, accepted = _run(models, spec_tokens=spec_tokens,
                                       max_len=24, eos_id=1,
                                       kv_quant=kv_quant)
    _same(ref, ours, greedy)
    assert sum(accepted) == int(ours.gen_count[0])


def test_speculative_with_suppression(models):
    ref, ours, greedy, _ = _run(models, prompt=(5,), max_len=20, eos_id=1,
                                suppress=[3, 4, 7, 11])
    _same(ref, ours, greedy)
    n = int(ours.lengths[0])
    assert not set(ours.tokens[0, 1:n].tolist()) & {3, 4, 7, 11}


@pytest.mark.parametrize("perfect", [False, True],
                         ids=["small_draft", "perfect_draft"])
def test_speculative_early_eos(models, perfect):
    """An EOS the target really emits mid-run (with its one repeated token
    suppressed, the first token that appears only from the third generated
    position on): in-span EOS acceptance and the lengths contract. With
    the perfect draft the EOS lands inside an accepted span, which must
    stop at it."""
    pt, _, enc, _ = models["port"]
    free = generate(pt, models["cfg"][0], enc, torch.tensor([[5, 9]]),
                    max_len=24, eos_id=1, suppress=torch.tensor([94]))
    gen = free.tokens[0, 2:].tolist()
    eos = next(t for i, t in enumerate(gen) if i >= 2 and t not in gen[:i])
    ref, ours, greedy, accepted = _run(models, perfect=perfect,
                                       spec_tokens=6, max_len=24, eos_id=eos,
                                       suppress=[94])
    assert int(ours.lengths[0]) < 24
    _same(ref, ours, greedy)
    if perfect:
        assert 1 < accepted[-1] < 6


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32_kv", "int8_kv"])
def test_speculative_perfect_draft(models, kv_quant):
    """Draft == target: every pass accepts all its K tokens (the last may
    stop short at EOS or max_len), and the result is still exact."""
    ref, ours, greedy, accepted = _run(models, perfect=True, spec_tokens=6,
                                       prompt=(5,), max_len=24, eos_id=1,
                                       kv_quant=kv_quant)
    _same(ref, ours, greedy)
    if not kv_quant:       # the int8 target and the float draft may differ
        assert all(a == 6 for a in accepted[:-1])


def test_speculative_first_suppress_exact(models):
    """SuppressBlank at absolute position P in draft AND target keeps the
    speculative result token-exact when the first token is rerouted."""
    pt, _, enc, _ = models["port"]
    plain = generate(pt, models["cfg"][0], enc, torch.tensor([[5, 9]]),
                     max_len=24, eos_id=1)
    banned = [int(plain.tokens[0, 2])]
    ref, ours, greedy, _ = _run(models, max_len=24, eos_id=1,
                                first_suppress=banned)
    assert int(ours.tokens[0, 2]) != banned[0]
    _same(ref, ours, greedy)


def test_speculative_position_table_guard(models):
    """max_len + spec_tokens past the position table raises (n_text_ctx 64:
    max_len 60 with K 8 overruns; 57 is the boundary and runs)."""
    pt, pd, enc, denc = models["port"]
    tcfg, dcfg = models["cfg"]
    with pytest.raises(ValueError, match="position table"):
        generate_speculative(pd, pt, dcfg, tcfg, denc, enc,
                             torch.tensor([[5, 9]]), max_len=60, eos_id=1,
                             spec_tokens=8)
    generate_speculative(pd, pt, dcfg, tcfg, denc, enc, torch.tensor([[5, 9]]),
                         max_len=57, eos_id=1, spec_tokens=8)
    with pytest.raises(ValueError, match="B=1"):
        generate_speculative(pd, pt, dcfg, tcfg, denc.expand(2, -1, -1),
                             enc.expand(2, -1, -1),
                             torch.tensor([[5, 9], [5, 9]]), max_len=20,
                             eos_id=1)


def test_transcriber_draft_path_matches(rng):
    """``Transcriber(draft=...)`` transcribes as the plain port Transcriber
    and the JAX one with the same draft do (the draft's n_mels differ, so
    it runs its own frontend)."""
    corpus = ["hello world", "ab cd"] * 3
    jtk = JaxTokenizer(jax_train_bpe(corpus, vocab_size=280))
    tk = WhisperTokenizer(train_bpe(corpus, vocab_size=280))
    common = dict(n_audio_ctx=100, encoder_layers=1, decoder_layers=1,
                  heads=2, vocab_size=tk.vocab_size, n_text_ctx=64)
    jt, tcfg, pt = _bridge(JaxWhisperConfig(n_mels=80, d_model=32, **common),
                           0)
    jd, dcfg, pd = _bridge(JaxWhisperConfig(n_mels=128, d_model=16, **common),
                           1)
    audio = (0.1 * rng.standard_normal(16000 * 3)).astype(np.float32)
    kw = dict(max_new_tokens=8, temperature_fallback=False)
    ref = JaxTranscriber(jt, jcfg_of(tcfg), jtk, backend="xla",
                         draft=(jd, jcfg_of(dcfg)), spec_tokens=4,
                         **kw).transcribe(audio, batch_chunks=1)
    plain = Transcriber(pt, tcfg, tk, device="cpu", **kw)
    spec = Transcriber(pt, tcfg, tk, device="cpu", draft=(pd, dcfg),
                       spec_tokens=4, **kw)
    assert spec.draft_frontend is not None
    a = plain.transcribe(audio, batch_chunks=1)
    b = spec.transcribe(audio, batch_chunks=1)
    assert b.text == a.text == ref.text
    assert [s.text for s in b.segments] == [s.text for s in ref.segments]


def jcfg_of(cfg):
    return JaxWhisperConfig(**cfg.asdict())
