"""Port ``beam_search`` and best-of sampling vs the JAX package, on the CPU.

The model is the JAX beam tests' (``tests/test_beam.py``: d_model 32, 1+2
layers, vocab 90), JAX-initialised and bridged into the port. Tokens and
lengths must be exact, scores within 1e-5 (sum-logprobs within 1e-5
relative). Two of the EOS ids are tokens this model really emits, so the
finished pool fills, patience widens it and finalize pads from the live
beams; the third (2) it never emits.
Best-of is held by its rule (the ranker's best of the tiled samples),
since the port's ``torch.Generator`` and JAX's key streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer import beam as jbeam
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer import beam
from audax_torch.infer.decode import generate
from audax_torch.infer.transcribe import Transcriber
from audax_torch.models.bridge import params_from_numpy
from audax_torch.models.whisper import encode
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer

JCFG = JaxWhisperConfig(n_mels=16, n_audio_ctx=32, d_model=32,
                        encoder_layers=1, decoder_layers=2, heads=2,
                        vocab_size=90, n_text_ctx=32)


@pytest.fixture(scope="module")
def model():
    jparams = init_whisper_params(JCFG, jax.random.key(0))
    cfg = WhisperConfig(**JCFG.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    mel = np.random.default_rng(0).standard_normal((2, 64, 16))
    mel = mel.astype(np.float32)
    jenc = jencode(jparams, JCFG, jnp.asarray(mel))
    enc = encode(params, cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=1e-5)
    return jparams, jenc, cfg, params, enc


def _same(ours, ref):
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.sum_logprob.numpy(),
                               np.asarray(ref.sum_logprob), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("eos", [2, 23, 27])
@pytest.mark.parametrize("kw", [
    dict(beam_width=4),
    dict(beam_width=3, patience=2.0),
    dict(beam_width=2, patience=3.0, length_penalty=0.8),
    dict(beam_width=3, kv_quant=True),
    dict(beam_width=3, suppress=[5, 9, 30]),
    # four tokens left: finfo.min ties fill the first expansion's 2W
    dict(beam_width=4,
         suppress=[i for i in range(90) if i not in (2, 23, 27, 40)]),
], ids=["w4", "patience2", "patience3_gnmt", "int8_kv", "suppress",
        "four_tokens"])
def test_beam_matches_jax(model, kw, eos):
    jparams, jenc, cfg, params, enc = model
    prompts = [[[1, 5, 9], [1, 5, 9]]]
    if kw == dict(beam_width=4):
        prompts.append([[1], [1]])
    for prompt in prompts:
        jkw = {k: (jnp.asarray(v, jnp.int32) if k == "suppress" else v)
               for k, v in kw.items()}
        ref = jbeam.beam_search(jparams, JCFG, jenc,
                                jnp.asarray(prompt, jnp.int32), max_len=16,
                                eos_id=eos, **jkw)
        ours = beam.beam_search(params, cfg, enc, torch.tensor(prompt),
                                max_len=16, eos_id=eos, **kw)
        _same(ours, ref)


@pytest.mark.parametrize("max_len", [10, 12])
def test_beam_finalize_matches_jax(model, max_len):
    """A tight budget with a patience pool that holds at least beam_width
    finished hypotheses, but not all its slots, when ``max_len`` ends the
    search: finalize must pad from the live beams only below beam_width,
    as the JAX function does."""
    jparams, jenc, cfg, params, enc = model
    prompt = [[1, 5, 9], [1, 5, 9]]
    kw = dict(max_len=max_len, eos_id=27, beam_width=2, patience=3.0)
    _same(beam.beam_search(params, cfg, enc, torch.tensor(prompt), **kw),
          jbeam.beam_search(jparams, JCFG, jenc,
                            jnp.asarray(prompt, jnp.int32), **kw))


def test_beam_pool_is_exercised(model):
    """The EOS ids above really finish hypotheses early (the pool and the
    finalize pad both run), and patience changes what is returned."""
    _, _, cfg, params, enc = model
    prompt = torch.tensor([[1], [1]])
    out = beam.beam_search(params, cfg, enc, prompt, max_len=16, eos_id=23,
                           beam_width=3, patience=2.0)
    lengths = out.lengths.numpy()
    assert (lengths < 16).any() and (lengths == 16).any()
    base = beam.beam_search(params, cfg, enc, prompt, max_len=16, eos_id=23,
                            beam_width=3)
    assert not torch.equal(base.tokens, out.tokens)


def test_beam1_equals_greedy(model):
    _, _, cfg, params, enc = model
    prompt = torch.tensor([[1, 3], [1, 3]])
    for eos in (2, 23):
        greedy = generate(params, cfg, enc, prompt, max_len=20, eos_id=eos)
        out = beam.beam_search(params, cfg, enc, prompt, max_len=20,
                               eos_id=eos, beam_width=1)
        assert torch.equal(out.tokens[:, 0], greedy.tokens)
        assert torch.equal(out.lengths[:, 0], greedy.lengths)


def test_patience_below_one_raises(model):
    _, _, cfg, params, enc = model
    with pytest.raises(ValueError, match="patience"):
        beam.beam_search(params, cfg, enc, torch.tensor([[1], [1]]),
                         max_len=16, eos_id=2, beam_width=3, patience=0.5)


def test_fcfs_partition_and_pool_slots_match_jax():
    """The candidate classification and the FCFS slots, on random best-first
    candidate lists with many EOTs, equal the JAX functions'; the openai
    scan-order cases of ``tests/test_beam.py`` hold as well."""
    rng = np.random.default_rng(3)
    v, eos, w, m = 10, 7, 3, 5
    for _ in range(20):
        top_idx = rng.integers(0, 3 * v, (4, 2 * w))
        top_idx[rng.random(top_idx.shape) < 0.4] = eos
        cnt = rng.integers(0, m + 1, 4)
        ref = jbeam._fcfs_partition(jnp.asarray(top_idx), v, eos, w)
        ours = beam._fcfs_partition(torch.from_numpy(top_idx), v, eos, w)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ref_s = jbeam._pool_slots(ref[2], ref[3], jnp.asarray(cnt), m)
        ours_s = beam._pool_slots(ours[2], ours[3], torch.from_numpy(cnt), m)
        for a, b in zip(ours_s, ref_s):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    top_idx = torch.tensor([[0 * v + eos, 0 * v + 3, 1 * v + eos, 1 * v + 4]])
    is_live, lane, is_pooled, pool_rank = beam._fcfs_partition(top_idx, v,
                                                               eos, 2)
    assert is_live[0].tolist() == [False, True, False, True]
    assert lane[0, [1, 3]].tolist() == [0, 1]
    assert is_pooled[0].tolist() == [True, False, True, False]
    assert pool_rank[0, [0, 2]].tolist() == [0, 1]
    # a full pool drops even the step's best candidate (slot == m)
    slot, ok = beam._pool_slots(is_pooled, pool_rank, torch.tensor([3]), 3)
    assert not ok.any() and (slot == 3).all()


@pytest.fixture(scope="module")
def ts_model():
    corpus = ["hello world how are you"] * 4
    jtok = JaxTokenizer(jax_train_bpe(corpus, vocab_size=280),
                        timestamp_count=1501)
    tok = WhisperTokenizer(train_bpe(corpus, vocab_size=280),
                           timestamp_count=1501)
    assert tok.bpe.vocab == jtok.bpe.vocab
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=300, d_model=32,
                            encoder_layers=1, decoder_layers=1, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=48)
    jparams = init_whisper_params(jcfg, jax.random.key(7))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jtok, tok, jcfg, jparams, cfg, params


@pytest.mark.parametrize("kw", [
    dict(beam_width=3, timestamps=True),
    dict(beam_width=2, patience=2.0, length_penalty=1.0),
], ids=["timestamps", "patience_gnmt"])
def test_transcriber_beam_matches_jax(ts_model, rng, kw):
    """``Transcriber(beam_width=K)``: the t = 0 rung runs the beam (with
    the timestamp rules inside it) and yields the JAX Transcriber's ids."""
    jtok, tok, jcfg, jparams, cfg, params = ts_model
    common = dict(max_new_tokens=12, temperature_fallback=False, **kw)
    jtr = JaxTranscriber(jparams, jcfg, jtok, backend="xla", **common)
    tr = Transcriber(params, cfg, tok, device="cpu", **common)
    audio = (0.05 * rng.standard_normal(16000 * 7)).astype(np.float32)
    chunk = audio[: tr.chunk_samples][None]
    (ref, _), ours = jtr._decode_chunk_batch(chunk), tr._decode_chunk_batch(chunk)
    assert ours[0][0] == ref[0][0] and ours[0][2] == 0.0
    assert ours[0][1] == pytest.approx(ref[0][1], abs=1e-5)
    a, b = jtr.transcribe(audio), tr.transcribe(audio)
    assert [s.text for s in b.segments] == [s.text for s in a.segments]
    assert [(s.start, s.end) for s in b.segments] == \
        [(s.start, s.end) for s in a.segments]


def test_transcriber_best_of_picks_ranker_max(ts_model, rng):
    """``Transcriber(best_of=K)`` at a t > 0 rung returns, for each window,
    the ranker's best of its K tiled samples: reproduced by tiling
    ``generate`` by hand with the same seed-0 generator."""
    _, tok, _, _, cfg, params = ts_model
    for lp in (None, 1.0):
        tr = Transcriber(params, cfg, tok, device="cpu", max_new_tokens=8,
                         temperature_fallback=False, best_of=3,
                         temperatures=(0.7,), length_penalty=lp)
        audio = (0.05 * rng.standard_normal((2, tr.chunk_samples)))
        enc = encode(params, cfg, tr.frontend(audio.astype(np.float32)))
        prompt = tr._prompt(2, None, "en")
        out = tr._decode_once(enc, prompt, 0.7)
        assert out.tokens.shape[0] == 2
        hand = generate(params, cfg, enc.repeat_interleave(3, 0),
                        torch.from_numpy(prompt).repeat_interleave(3, 0),
                        max_len=prompt.shape[1] + 8, eos_id=tok.eot,
                        temperature=0.7, suppress=tr.suppress,
                        first_suppress=tr.first_suppress)
        n = np.maximum(hand.gen_count.numpy(), 1)
        lp_sum = hand.sum_logprob.numpy()
        score = lp_sum / (n if lp is None else ((5.0 + n) / 6.0) ** lp)
        pick = score.reshape(2, 3).argmax(1) + np.arange(2) * 3
        assert torch.equal(out.tokens, hand.tokens[pick])
        assert torch.equal(out.sum_logprob, hand.sum_logprob[pick])
        # the kept sample is the maximum of the ranker over its window's 3
        assert (score[pick] >= score.reshape(2, 3).max(1) - 1e-12).all()
