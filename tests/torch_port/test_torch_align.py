"""Port word alignment (``infer/align.py``) vs the JAX package's, on the CPU.

The model is the JAX alignment test's (``tests/test_align.py``: d_model 32,
1+2 layers, n_audio_ctx 300 so a window is 6 s, 1,501 timestamps),
JAX-initialised and bridged. The alignment matrix must agree within 1e-4,
the attention mass within 1e-5, the DTW path exactly and the word timings
equal; ``Transcriber(word_timestamps=True)`` must attach the JAX
Transcriber's words to the same segments, also with its heads cut over a
two-rank tensor-parallel mesh (a gloo world of two processes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer import align as jalign
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer import align
from audax_torch.infer.transcribe import Transcriber
from audax_torch.models.bridge import params_from_numpy
from audax_torch.models.whisper import encode
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer

from .mesh_world import run_world

CORPUS = ["the quick brown fox jumps"] * 4


@pytest.fixture(scope="module")
def small_model():
    jtok = JaxTokenizer(jax_train_bpe(CORPUS, vocab_size=300),
                        timestamp_count=1501)
    tok = WhisperTokenizer(train_bpe(CORPUS, vocab_size=300),
                           timestamp_count=1501)
    assert tok.bpe.vocab == jtok.bpe.vocab
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=300, d_model=32,
                            encoder_layers=1, decoder_layers=2, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=48)
    jparams = init_whisper_params(jcfg, jax.random.key(0))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jtok, tok, jcfg, jparams, cfg, params


def _words(ws):
    return [(w.word, w.start, w.end) for w in ws]


@pytest.mark.parametrize("n_frames,medfilt", [(None, 7), (170, 7), (120, 4),
                                              (300, 1)],
                         ids=["all_frames", "cropped", "even_filter",
                              "no_filter"])
def test_cross_attention_weights_match_jax(small_model, n_frames, medfilt):
    _, tok, jcfg, jparams, cfg, params = small_model
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 600, 80)).astype(np.float32)
    tokens = rng.integers(0, 300, (2, 20))
    tokens[:, :3] = tok.sot_sequence(timestamps=True)[:3]
    jenc = jencode(jparams, jcfg, jnp.asarray(mel))
    enc = encode(params, cfg, torch.from_numpy(mel))
    jw, jmass = jalign.cross_attention_weights(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jenc,
        n_frames=None if n_frames is None else jnp.int32(n_frames),
        medfilt=medfilt)
    w, mass = align.cross_attention_weights(params, cfg,
                                            torch.from_numpy(tokens), enc,
                                            n_frames=n_frames,
                                            medfilt=medfilt)
    assert w.shape == mass.shape == (2, 20, 300)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), atol=1e-5,
                               rtol=0)
    if n_frames is not None:
        assert (w[..., n_frames:] == -1e9).all()
        assert (mass[..., n_frames:] == 0).all()
    # the DTW path and the word timings over the same matrix
    ids = tok.encode(" the quick brown fox jumps")
    nf = n_frames or 300
    for b in range(2):
        rows, jrows = w[b, : len(ids)].numpy(), np.asarray(jw[b, : len(ids)])
        ti, fi = align.dtw_path(-rows[:, :nf])
        jti, jfi = jalign.dtw_path(-jrows[:, :nf])
        np.testing.assert_array_equal(ti, jti)
        np.testing.assert_array_equal(fi, jfi)
        ours = align.word_timings(rows, ids, tok, n_frames=nf,
                                  mass=mass[b, : len(ids)].numpy())
        ref = jalign.word_timings(jrows, ids, tok, n_frames=nf,
                                  mass=np.asarray(jmass[b, : len(ids)]))
        assert _words(ours) == _words(ref) and ours
        np.testing.assert_allclose([x.probability for x in ours],
                                   [x.probability for x in ref], atol=1e-5)


def test_median_filter_takes_jnp_median():
    """The median filter's middle value: exact for odd widths, the mean of
    the two middles for even ones (``torch.median`` takes the lower)."""
    x = np.random.default_rng(2).standard_normal((3, 5, 6)).astype(np.float32)
    for axis_len in (5, 6):
        got = align._median_last(torch.from_numpy(x[..., :axis_len]))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jnp.median(x[..., :axis_len],
                                                         axis=-1)),
                                   atol=1e-7)


def test_dtw_path_matches_jax():
    rng = np.random.default_rng(4)
    for shape in ((5, 10), (12, 40), (30, 31), (1, 7), (9, 1)):
        cost = rng.standard_normal(shape)
        for a, b in zip(align.dtw_path(cost), jalign.dtw_path(cost)):
            np.testing.assert_array_equal(a, b)
    # a clean diagonal ridge is traced exactly and covers every token
    cost = np.ones((5, 10))
    for i in range(5):
        cost[i, 2 * i: 2 * i + 2] = 0.0
    ti, fi = align.dtw_path(cost)
    assert set(ti) == set(range(5)) and set(fi) == set(range(10))
    assert (np.diff(ti) >= 0).all() and (np.diff(fi) >= 0).all()


def test_merge_punctuations_matches_jax():
    W, JW = align.WordTiming, jalign.WordTiming
    cases = [
        [('"', 0.0, 0.1, 0.2), ("hello", 0.1, 0.5, 0.9), (",", 0.5, 0.6, 0.3),
         ("world", 0.6, 1.0, 0.8), (".", 1.0, 1.1, 0.4)],
        [("hi,", 0.0, 0.3, 0.9), ("there", 0.3, 0.6, 0.8)],
        [("hey", 0.0, 0.3, 0.9), ("(", 0.3, 0.4, 0.2)],
        [("(", 0.0, 0.1, 0.1), ("'", 0.1, 0.2, 0.1), ("a", 0.2, 0.3, 0.5),
         ("!", 0.3, 0.4, 0.2), ("?", 0.4, 0.5, 0.2)],
    ]
    for case in cases:
        ours = align.merge_punctuations([W(*c) for c in case])
        ref = jalign.merge_punctuations([JW(*c) for c in case])
        assert [(w.word, w.start, w.end, w.probability) for w in ours] == \
            [(w.word, w.start, w.end, w.probability) for w in ref]
    assert align.PREPEND_PUNCTUATIONS == jalign.PREPEND_PUNCTUATIONS
    assert align.APPEND_PUNCTUATIONS == jalign.APPEND_PUNCTUATIONS


def test_word_timings_grouping_matches_jax(small_model):
    """Byte-level word grouping across BPE pieces, specials skipped without
    a flush, on a block-diagonal matrix: the JAX words exactly."""
    jtok, tok, _, _, _, _ = small_model
    ids = (tok.encode("the quick") + [tok.timestamp_begin + 3]
           + tok.encode(" brown fox jumps"))
    l, s = len(ids), 60
    w = np.zeros((l, s), np.float32)
    span = s // l
    for i in range(l):
        w[i, i * span:(i + 1) * span] = 1.0
    ours = align.word_timings(w, ids, tok, n_frames=s)
    ref = jalign.word_timings(w, ids, jtok, n_frames=s)
    assert _words(ours) == _words(ref) and len(ours) >= 4


@pytest.mark.parametrize("timestamps", [False, True])
def test_transcriber_word_timestamps_match_jax(small_model, rng, timestamps):
    jtok, tok, jcfg, jparams, cfg, params = small_model
    kw = dict(max_new_tokens=10, temperature_fallback=False,
              timestamps=timestamps, word_timestamps=True)
    jtr = JaxTranscriber(jparams, jcfg, jtok, backend="xla", **kw)
    tr = Transcriber(params, cfg, tok, device="cpu", **kw)
    audio = (0.05 * rng.standard_normal(16000 * 8)).astype(np.float32)
    ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
    assert ours.text == ref.text
    assert len(ours.segments) == len(ref.segments)
    n_words = 0
    for a, b in zip(ours.segments, ref.segments):
        assert (a.start, a.end) == pytest.approx((b.start, b.end))
        assert (a.words is None) == (b.words is None)
        if a.words is not None:
            assert _words(a.words) == _words(b.words)
            np.testing.assert_allclose([w.probability for w in a.words],
                                       [w.probability for w in b.words],
                                       atol=1e-5)
            n_words += len(a.words)
    assert n_words > 0


#: the tensor-parallel case: two of four heads a rank over a (1 x 2) mesh;
#: the model's seed is one whose 8 s of noise transcribes to words
TP_HEADS = 4
TP_SEED = 6
TP_KW = dict(max_new_tokens=10, temperature_fallback=False, timestamps=True,
             word_timestamps=True)


@pytest.fixture(scope="module")
def tp_words(small_model, tmp_path_factory):
    """The alignment test's model at 4 heads, and its
    ``Transcriber(word_timestamps=True, mesh=)`` over a two-rank gloo
    mesh (``mesh_cases.tp_words``), by rank."""
    jtok, tok, jcfg, _, _, _ = small_model
    jcfg = dataclasses.replace(jcfg, heads=TP_HEADS)
    jparams = init_whisper_params(jcfg, jax.random.key(TP_SEED))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    audio = (0.05 * np.random.default_rng(3).standard_normal(16000 * 8)
             ).astype(np.float32)
    outs = run_world(2, "tests.torch_port.mesh_cases:tp_words", dict(
        params=params, cfg=cfg, tok=tok, audio=audio, kws={"tp": TP_KW}),
        tmp_path_factory.mktemp("tp_words"))
    return outs, (jtok, jcfg, jparams), audio


def test_transcriber_word_timestamps_under_tp_match_jax(tp_words):
    """Word timestamps with the heads cut over 'model' (each rank
    z-normalises its own heads; the head sums meet in one all-reduce):
    every rank's text, segments and words equal the JAX Transcriber's
    without a mesh, the probabilities within 1e-5."""
    outs, (jtok, jcfg, jparams), audio = tp_words
    ref = JaxTranscriber(jparams, jcfg, jtok, backend="xla",
                         **TP_KW).transcribe(audio)
    for out in outs:
        ours = out["tp"]
        assert ours["text"] == ref.text
        assert len(ours["segments"]) == len(ref.segments)
        n_words = 0
        for (start, end, words), b in zip(ours["segments"], ref.segments):
            assert (start, end) == pytest.approx((b.start, b.end))
            assert (words is None) == (b.words is None)
            if words is not None:
                assert [w[:3] for w in words] == _words(b.words)
                np.testing.assert_allclose([w[3] for w in words],
                                           [w.probability for w in b.words],
                                           atol=1e-5)
                n_words += len(words)
        assert n_words > 0
