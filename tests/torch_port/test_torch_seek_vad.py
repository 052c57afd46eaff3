"""The port Transcriber's seek loop, hallucination filter, energy VAD, clip
ranges and language detection vs the JAX package's, on the CPU.

One small Whisper (d_model 32, 1+2 layers, n_audio_ctx 300 so a window is
6 s, 1,501 timestamps) JAX-initialised and bridged, and tokenizers trained
on the same corpus by both packages. Segments, seeks and words must be
equal; language probabilities within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer import transcribe as jtr_mod
from audax.infer import vad as jvad
from audax.infer.align import WordTiming as JaxWordTiming
from audax.models.whisper import encode as jencode
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer import transcribe as T
from audax_torch.infer import vad
from audax_torch.infer.align import WordTiming
from audax_torch.models.bridge import params_from_numpy
from audax_torch.models.whisper import encode
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer

CORPUS = ["hello world how are you", "hola mundo"] * 3


@pytest.fixture(scope="module")
def model():
    jtok = JaxTokenizer(jax_train_bpe(CORPUS, vocab_size=300),
                        timestamp_count=1501)
    tok = WhisperTokenizer(train_bpe(CORPUS, vocab_size=300),
                           timestamp_count=1501)
    assert tok.bpe.vocab == jtok.bpe.vocab
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=300, d_model=32,
                            encoder_layers=1, decoder_layers=2, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=48)
    jparams = init_whisper_params(jcfg, jax.random.key(2))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jtok, tok, jcfg, jparams, cfg, params


def _pair(model, **kw):
    jtok, tok, jcfg, jparams, cfg, params = model
    return (jtr_mod.Transcriber(jparams, jcfg, jtok, backend="xla", **kw),
            T.Transcriber(params, cfg, tok, device="cpu", **kw))


def _same_segments(ours, ref):
    assert [s.text for s in ours] == [s.text for s in ref]
    assert [(s.start, s.end) for s in ours] == \
        pytest.approx([(s.start, s.end) for s in ref])
    assert [s.temperature for s in ours] == [s.temperature for s in ref]
    for a, b in zip(ours, ref):
        assert (a.words is None) == (b.words is None)
        if a.words is not None:
            assert [(w.word, w.start, w.end) for w in a.words] == \
                [(w.word, w.start, w.end) for w in b.words]


def _windows(tr, attr):
    """Count the window groups a Transcriber decodes, through its method
    ``attr``."""
    seen = []
    orig = getattr(tr, attr)

    def rec(group, **kw):
        seen.append(len(group))
        return orig(group, **kw)

    setattr(tr, attr, rec)
    return seen


def _noise(rng, seconds, scale=0.05):
    return (scale * rng.standard_normal(int(16000 * seconds))
            ).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(timestamps=True, seek_by_timestamps=True),
    dict(timestamps=True, seek_by_timestamps=True, condition_on_previous=True),
    dict(timestamps=True, word_timestamps=True,
         hallucination_silence_threshold=0.5),
    dict(timestamps=True, word_timestamps=True, seek_by_timestamps=True,
         condition_on_previous=True, hallucination_silence_threshold=2.0),
], ids=["seek", "seek_context", "hallucination", "all"])
def test_seek_loop_matches_jax(model, rng, kw):
    """The sequential loop on the model's own output: as many windows as
    the JAX loop, and the same segments and words. (This random model's
    words are all anomalous, so the hallucination filter drops them and
    forces the seeks.)"""
    jtr, tr = _pair(model, max_new_tokens=12, temperature_fallback=False,
                    **kw)
    seen = _windows(tr, "_decode_windows")
    jseen = _windows(jtr, "_decode_chunk_batch")
    audio = _noise(rng, 20.0)
    ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
    assert ours.text == ref.text
    _same_segments(ours.segments, ref.segments)
    assert len(seen) == len(jseen) >= 1


def _scripted(tk, seconds):
    """One window's decode: text between two timestamp pairs, the last
    closing at ``seconds`` (so the next window starts there)."""
    half = tk.timestamp_begin + round(seconds / 0.04)
    end = tk.timestamp_begin + round(seconds / 0.02)
    return ([tk.timestamp_begin] + tk.encode(" hello") + [half, half]
            + tk.encode(" world") + [end])


@pytest.mark.parametrize("close_at", [1.5, 2.4])
def test_seek_moves_to_segment_ends(model, close_at):
    """Scripted window decodes whose last closed segment ends inside the
    window: each next window starts there, in the port as in the JAX loop
    (the same seeks and segments)."""
    jtr, tr = _pair(model, max_new_tokens=12, temperature_fallback=False,
                    timestamps=True, seek_by_timestamps=True,
                    condition_on_previous=True)
    starts = {"jax": [], "port": []}

    def script(key, tk):
        def fake(group, prev=None, lang=None):
            starts[key].append(len(starts[key]))
            ids = _scripted(tk, close_at)
            return [(ids, -0.2, 0.0, 1.0, 0.01)], None
        return fake

    jtr._decode_chunk_batch = script("jax", jtr.tokenizer)
    tr._decode_windows = script("port", tr.tokenizer)
    audio = np.zeros(16000 * 15, np.float32)
    ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
    _same_segments(ours.segments, ref.segments)
    assert [s.tokens for s in ours.segments][:2] == [
        tr.tokenizer.encode(" hello"), tr.tokenizer.encode(" world")]
    assert len(starts["port"]) == len(starts["jax"]) > 15 // 6 + 1
    window_starts = sorted({s.start for s in ours.segments
                            if s.text == " hello"})
    assert window_starts[:3] == pytest.approx([0.0, close_at, 2 * close_at])


def _seg(mod, wt, start, end, probs, dur=0.3):
    n = len(probs)
    step = (end - start) / max(n, 1)
    words = [wt(f"w{i}", round(start + i * step, 3),
                round(start + i * step + min(dur, step), 3), p)
             for i, p in enumerate(probs)]
    return mod.Segment("x", start, end, -0.3, 0.0, words=words)


def test_hallucination_filter_matches_jax():
    """The filter and the anomaly score on random window layouts, and the
    JAX tests' leading-gap and surrounded cases."""
    rng = np.random.default_rng(5)
    cases = [([(38.0, 40.0, [0.01] * 3)], 30.0, 29.0),
             ([(30.0, 33.0, [0.9] * 3), (40.0, 42.0, [0.01] * 3)], 30.0,
              29.5),
             ([(30.0, 33.0, [0.9] * 3), (33.5, 35.0, [0.01] * 3),
               (35.5, 38.0, [0.9] * 2)], 30.0, 29.5)]
    for _ in range(40):
        n = int(rng.integers(1, 5))
        edges = np.sort(rng.uniform(30.0, 60.0, 2 * n)).round(2)
        segs = [(float(edges[2 * i]), float(edges[2 * i + 1]),
                 list(rng.choice([0.01, 0.1, 0.5, 0.9],
                                 int(rng.integers(1, 5)))))
                for i in range(n)]
        cases.append((segs, 30.0, float(rng.uniform(20.0, 31.0))))
    for segs, offset, last in cases:
        for thr in (0.5, 2.0):
            ours = [_seg(T, WordTiming, *s) for s in segs]
            ref = [_seg(jtr_mod, JaxWordTiming, *s) for s in segs]
            kw = dict(offset=offset, window_end=60.0, total_s=120.0,
                      threshold=thr, last_speech_ts=last)
            kept, forced = T.hallucination_filter(ours, **kw)
            jkept, jforced = jtr_mod.hallucination_filter(ref, **kw)
            assert [ours.index(s) for s in kept] == \
                [ref.index(s) for s in jkept]
            assert forced == jforced
            assert [T._is_segment_anomaly(s) for s in ours] == \
                [jtr_mod._is_segment_anomaly(s) for s in ref]
    assert not T._is_segment_anomaly(None)


def test_vad_matches_jax():
    rng = np.random.default_rng(6)
    for n, scale in ((0, 1.0), (100, 1.0), (16000, 1e-6), (48000, 0.01),
                     (50000, 0.3)):
        x = (scale * rng.standard_normal(n)).astype(np.float32)
        assert vad.peak_frame_rms_db(x, 16000) == \
            jvad.peak_frame_rms_db(x, 16000)
        for thr in (-60.0, -45.0, -20.0):
            assert vad.is_silent(x, 16000, thr) == jvad.is_silent(x, 16000,
                                                                  thr)
    assert vad.peak_frame_rms_db(np.zeros(100, np.float32), 16000) == -200.0
    assert vad.peak_frame_rms_db(np.ones(16000, np.float32), 16000) == \
        pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(condition_on_previous=True),
                                dict(timestamps=True,
                                     seek_by_timestamps=True)],
                         ids=["batched", "context", "seek"])
def test_vad_skips_silent_windows(model, rng, kw):
    """A silent window costs no decode and no segment, as in the JAX
    package; on the fixed grid the others keep their true offsets."""
    jtr, tr = _pair(model, max_new_tokens=4, vad_threshold_db=-45.0,
                    temperature_fallback=False, **kw)
    w = tr.chunk_samples
    audio = np.zeros(3 * w, np.float32)
    audio[:w] = _noise(rng, w / 16000, 0.1)
    audio[2 * w:] = _noise(rng, w / 16000, 0.1)
    seen = _windows(tr, "_decode_windows")
    jseen = _windows(jtr, "_decode_chunk_batch")
    ours, ref = tr.transcribe(audio, batch_chunks=1), jtr.transcribe(
        audio, batch_chunks=1)
    _same_segments(ours.segments, ref.segments)
    assert len(seen) == len(jseen)
    if not kw.get("seek_by_timestamps"):
        assert len(seen) == 2
        assert {s.start for s in ours.segments} == {0.0,
                                                    2 * tr.chunk_seconds}
    seen.clear()
    silent = tr.transcribe(np.zeros(2 * w, np.float32))
    assert silent.text == "" and silent.segments == [] and seen == []


def test_clip_timestamps_match_jax(model, rng):
    jtok, tok, jcfg, jparams, cfg, params = model
    win = 6.0
    audio = _noise(rng, 5 * win, 0.1)
    for clips in (f"0,{win},{3 * win},{4 * win}", [4 * win], "2.5,9.25"):
        jtr, tr = _pair(model, max_new_tokens=6, timestamps=True,
                        word_timestamps=True, clip_timestamps=clips,
                        temperature_fallback=False)
        ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
        _same_segments(ours.segments, ref.segments)
        assert ours.segments and ours.audio_seconds == pytest.approx(5 * win)
    _, tr = _pair(model, max_new_tokens=6, clip_timestamps="10,5")
    with pytest.raises(ValueError, match="ascending"):
        tr.transcribe(audio)
    with pytest.raises(ValueError, match="word_timestamps"):
        T.Transcriber(params, cfg, tok, device="cpu",
                      hallucination_silence_threshold=2.0)


def test_detect_language_matches_jax(model, rng):
    jtok, tok, jcfg, jparams, cfg, params = model
    mel = rng.standard_normal((3, 600, 80)).astype(np.float32)
    jlangs, jprobs = jtr_mod.detect_language(
        jparams, jcfg, jtok, jencode(jparams, jcfg, jnp.asarray(mel)))
    langs, probs = T.detect_language(params, cfg, tok,
                                     encode(params, cfg,
                                            __import__("torch").from_numpy(mel)))
    assert langs == jlangs
    assert probs.shape == (3, tok.num_languages)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)


def test_auto_lang_matches_jax_per_call(model, rng, monkeypatch):
    """lang='auto' detects on each call's first window (the JAX result and
    its segments), and leaves ``Transcriber.lang`` as it was."""
    jtr, tr = _pair(model, lang="auto", max_new_tokens=8,
                    temperature_fallback=False)
    calls = []
    real = T.detect_language

    def counting(*a, **k):
        out = real(*a, **k)
        calls.append(out[0][0])
        return out

    monkeypatch.setattr(T, "detect_language", counting)
    for seed in (0, 1):
        audio = _noise(np.random.default_rng(seed), 8.0)
        ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
        _same_segments(ours.segments, ref.segments)
        best, probs = tr.detect(audio)
        jbest, jprobs = jtr.detect(audio)
        assert best == jbest and set(probs) == set(tok_langs(tr))
        assert max(abs(probs[c] - jprobs[c]) for c in probs) < 1e-5
    assert len(calls) == 4 and tr.lang == "auto"


def tok_langs(tr):
    return tr.tokenizer.languages
