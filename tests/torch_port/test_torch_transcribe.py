"""Port ``Transcriber`` vs the JAX package's, on the CPU.

A small Whisper (d_model 32, 2 heads, 1+1 layers, n_audio_ctx 64, so a
window is 1.28 s) with JAX-initialised weights, and tokenizers trained on
the same corpus by both packages. With the ladder held at t=0 the port must
emit the same token ids, text and segments; a ladder forced past t=0 must
visit the same rungs, and its sampled result must be deterministic for the
port's seed-0 generator (jax.random streams cannot be matched bit for
bit).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax_torch.core.config import WhisperConfig
from audax_torch.infer import transcribe as T
from audax_torch.models.bridge import params_from_numpy
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer

REPO = Path(__file__).resolve().parents[2]
CORPUS = ["hello world how are you", "the cat sat on the mat"] * 3


@pytest.fixture(scope="module")
def model():
    jtok = JaxTokenizer(jax_train_bpe(CORPUS, vocab_size=300))
    tok = WhisperTokenizer(train_bpe(CORPUS, vocab_size=300))
    assert tok.bpe.vocab == jtok.bpe.vocab and tok.vocab_size == jtok.vocab_size
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=64, d_model=32,
                            encoder_layers=1, decoder_layers=1, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=64)
    jparams = init_whisper_params(jcfg, jax.random.key(2))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jtok, tok, jcfg, jparams, cfg, params


def _clip(rng, seconds):
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _pair(model, **kw):
    jtok, tok, jcfg, jparams, cfg, params = model
    jtr = JaxTranscriber(jparams, jcfg, jtok, backend="xla", **kw)
    tr = T.Transcriber(params, cfg, tok, device="cpu", **kw)
    return jtr, tr


def _same_segments(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.text == b.text
        assert a.start == pytest.approx(b.start) and a.end == pytest.approx(b.end)
        assert a.temperature == b.temperature
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.compression_ratio == pytest.approx(b.compression_ratio)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(timestamps=True),
    dict(condition_on_previous=True, initial_prompt="hello world"),
], ids=["plain", "timestamps", "condition_on_previous"])
def test_transcriber_matches_jax_at_t0(model, rng, kw):
    jtr, tr = _pair(model, max_new_tokens=10, temperature_fallback=False, **kw)
    for seconds in (1.0, 2.0):                 # one window, then two
        audio = _clip(rng, seconds)
        ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
        assert ours.text == ref.text
        _same_segments(ours.segments, ref.segments)
    chunks = np.stack([_clip(rng, 1.28), _clip(rng, 1.28)])
    ref_res, _ = jtr._decode_chunk_batch(chunks)
    ours_res = tr._decode_chunk_batch(chunks)
    assert [r[0] for r in ours_res] == [r[0] for r in ref_res]   # token ids
    assert any(r[0] for r in ours_res)


def test_fallback_ladder_visits_same_rungs(model, rng, monkeypatch):
    kw = dict(max_new_tokens=8, temperatures=(0.0, 0.5, 1.0),
              logprob_threshold=0.0)          # random weights never pass
    jtr, tr = _pair(model, **kw)
    rungs = {"jax": [], "torch": []}
    jax_once, torch_once = jtr._decode_once, tr._decode_once

    def jax_rec(enc, prompt, temperature, denc=None):
        rungs["jax"].append(temperature)
        return jax_once(enc, prompt, temperature, denc=denc)

    def torch_rec(enc, prompt, temperature):
        rungs["torch"].append(temperature)
        return torch_once(enc, prompt, temperature)

    monkeypatch.setattr(jtr, "_decode_once", jax_rec)
    monkeypatch.setattr(tr, "_decode_once", torch_rec)
    audio = _clip(rng, 2.0)
    ref = jtr.transcribe(audio)
    first = tr.transcribe(audio)
    assert rungs["torch"] == rungs["jax"] == [0.0, 0.5, 1.0]
    assert [s.temperature for s in first.segments] == \
        [s.temperature for s in ref.segments] == [1.0, 1.0]
    again = tr.transcribe(audio)
    assert [s.tokens for s in again.segments] == \
        [s.tokens for s in first.segments]


def test_device_none_needs_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, tok, _, _, cfg, params = model
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Transcriber(params, cfg, tok)


@pytest.mark.parametrize("knob,value", [
    ("beam_width", 4), ("best_of", 5), ("patience", 1.5),
    ("length_penalty", 1.0), ("word_timestamps", True), ("draft", ("p", "c")),
    ("mesh", "mesh"),
    ("clip_timestamps", "0,1"), ("hallucination_silence_threshold", 2.0),
    ("seek_by_timestamps", True), ("vad_threshold_db", -50.0),
    ("lang", "auto"),
])
def test_later_slice_knobs_raise(model, knob, value):
    _, tok, _, _, cfg, params = model
    with pytest.raises(NotImplementedError, match="later slice"):
        T.Transcriber(params, cfg, tok, device="cpu", **{knob: value})


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import audax_torch\n"
        "for m in pkgutil.walk_packages(audax_torch.__path__, 'audax_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'audax' or n.startswith('audax.'))\n"
        "assert not bad, bad\n"
        "need = {'audax_torch.cli.http_server', 'audax_torch.infer.continuous',"
        " 'audax_torch.models.quantize', 'audax_torch.ops.int4_matmul',"
        " 'audax_torch.ops.direct_mel', 'audax_torch.data.synth',"
        " 'audax_torch.data.batching', 'audax_torch.data.urbansound',"
        " 'audax_torch.eval.metrics', 'audax_torch.models.classifiers',"
        " 'audax_torch.train.steps', 'audax_torch.train.loops',"
        " 'audax_torch.utils.profiling', 'audax_torch.tools.int4_layout_ab',"
        " 'audax_torch.tools.int4_plane_probe', 'audax_torch.tools.w4a8_probe',"
        " 'audax_torch.tools.int4_unpack_probe'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "heavy = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('pandas', 'pyarrow'))\n"
        "assert not heavy, heavy\n"
        "print(len([n for n in sys.modules if n.startswith('audax_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
