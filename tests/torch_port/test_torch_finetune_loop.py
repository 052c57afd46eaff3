"""The port's fine-tune loop and its helpers vs the JAX package, on the CPU.

``finetune_whisper(device="cpu")`` and the JAX ``finetune_whisper`` train
the same JAX-initialised tiny Whisper on the same three wavs (written by
the port's ``write_wav``): they draw the same batches and their loss
histories agree at rel 1e-4. SpecAugment, WER, the WAV codec and the
entry point's device and parallelism rules are checked on their own.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from audax.core.config import FineTuneConfig as JaxFineTuneConfig
from audax.core.config import MelConfig as JaxMelConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.data import audio_io as JIO
from audax.eval.wer import word_error_rate as jax_wer
from audax.models.whisper import init_whisper_params
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax.train import finetune_loop as JF
from audax_torch.core.config import FineTuneConfig, MelConfig, WhisperConfig
from audax_torch.data import audio_io as IO
from audax_torch.eval.wer import edit_distance, word_error_rate
from audax_torch.models.bridge import params_from_numpy
from audax_torch.models.whisper import tree_leaves
from audax_torch.ops.augment import spec_augment
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer
from audax_torch.train import finetune_loop as F
from audax_torch.train.metrics_sink import MetricsSink

CORPUS = ["hello world how are you", "the cat sat on the mat"] * 3
TEXTS = ["hello world", "the cat sat", "how are you on the mat"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    audio_dir = str(tmp_path_factory.mktemp("audio"))
    r = np.random.default_rng(0)
    for i, text in enumerate(TEXTS):
        t = np.arange(16000) / 16000.0
        x = (0.2 * np.sin(2 * np.pi * (200 + 100 * i) * t)
             + 0.05 * r.standard_normal(t.size)).astype(np.float32)
        IO.write_wav(os.path.join(audio_dir, f"m{i}.wav"), x, 16000)
        with open(os.path.join(audio_dir, f"m{i}.txt"), "w") as fh:
            fh.write(text)
    jtok = JaxTokenizer(jax_train_bpe(CORPUS, vocab_size=300))
    tok = WhisperTokenizer(train_bpe(CORPUS, vocab_size=300))
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=50, d_model=32,
                            encoder_layers=1, decoder_layers=1, heads=2,
                            vocab_size=tok.vocab_size, n_text_ctx=24)
    jparams = init_whisper_params(jcfg, jax.random.key(0))
    cfg = WhisperConfig(**jcfg.asdict())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return audio_dir, jtok, tok, jcfg, jparams, cfg, params


def test_finetune_whisper_matches_jax(setup, monkeypatch):
    audio_dir, jtok, tok, jcfg, jparams, cfg, params = setup
    jex = JF.build_speech_dataset(audio_dir, jtok, JaxMelConfig.whisper(80),
                                  chunk_seconds=1.0)
    ex = F.build_speech_dataset(audio_dir, tok, MelConfig.whisper(80),
                                chunk_seconds=1.0)
    assert [e["labels"] for e in ex] == [e["labels"] for e in jex]
    for a, b in zip(ex, jex):
        np.testing.assert_array_equal(a["audio"], np.asarray(b["audio"]))

    # record the label rows of every batch each loop draws
    drawn = {"jax": [], "torch": []}
    for key, mod in (("jax", JF), ("torch", F)):
        real = mod.collate_seq2seq

        def rec(rows, *, _real=real, _key=key, **kw):
            drawn[_key].append([list(r) for r in rows])
            return _real(rows, **kw)
        monkeypatch.setattr(mod, "collate_seq2seq", rec)

    kw = dict(learning_rate=1e-3, warmup_steps=1, max_steps=5, eval_every=5,
              batch_size=2, loss_fetch_every=2)
    _, ref = JF.finetune_whisper(jparams, jcfg, jtok, jex,
                                 JaxFineTuneConfig(**kw), eval_examples=jex[:1])
    before = [t.clone() for t in tree_leaves(params)]
    state, hist = F.finetune_whisper(params, cfg, tok, ex,
                                     FineTuneConfig(**kw),
                                     eval_examples=ex[:1], device="cpu")
    assert drawn["torch"] == drawn["jax"] and len(drawn["torch"]) == 5
    np.testing.assert_allclose(hist["loss"], ref["loss"], rtol=1e-4)
    assert hist["loss"][-1] < hist["loss"][0]
    assert [w["step"] for w in hist["wer"]] == [w["step"] for w in ref["wer"]]
    assert np.isfinite(hist["wer"][0]["wer"])
    assert hist["best_params"] is not None and state.step == 5
    for a, b in zip(tree_leaves(params), before):   # trained on a copy
        assert torch.equal(a, b)


def test_finetune_whisper_lora_ema_and_sink(setup, tmp_path):
    """LoRA with EMA and SpecAugment through the loop: the base stays
    bit-unchanged, the adapters move, every loss reaches the JSONL sink,
    and the EMA serving weights exist."""
    audio_dir, _, tok, _, _, cfg, params = setup
    ex = F.build_speech_dataset(audio_dir, tok, MelConfig.whisper(80),
                                chunk_seconds=1.0)
    before = [t.clone() for t in tree_leaves(params)]
    sink = MetricsSink("ft", out_dir=str(tmp_path))
    ft = FineTuneConfig(learning_rate=1e-2, warmup_steps=1, max_steps=5,
                        eval_every=10, batch_size=3, lora_rank=4,
                        ema_decay=0.9, spec_augment=True, sa_max_time_width=8,
                        sa_max_freq_width=8, loss_fetch_every=3)
    state, hist = F.finetune_whisper(params, cfg, tok, ex, ft, sink=sink,
                                     device="cpu")
    sink.close()
    assert len(hist["loss"]) == 5 and hist["wer"] == []
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)
    assert any(float(ab["b"].detach().abs().max()) > 0
               for ab in state.trainable.values())
    assert set(hist["ema_params"]) == set(params)
    with open(sink.path) as fh:
        steps = [r["step"] for r in map(json.loads, fh) if "loss" in r]
    assert steps == [0, 1, 2, 3, 4]


def test_spec_augment_properties(rng):
    mel = torch.from_numpy(rng.standard_normal((4, 100, 32)).astype(np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    out = spec_augment(gen(0), mel)
    assert out.shape == mel.shape
    assert torch.equal(out, spec_augment(gen(0), mel))       # seeded
    assert not torch.equal(out, spec_augment(gen(1), mel))
    changed = (out != mel).float().mean()
    assert 0.0 < changed < 0.9
    means = mel.mean(dim=(1, 2), keepdim=True).expand_as(mel)
    torch.testing.assert_close(out[out != mel], means[out != mel])
    # widths never exceed the maxima: each masked run of frames (rows
    # whose every bin changed) is at most 2 masks x 10 frames long
    out = spec_augment(gen(2), mel, freq_masks=0, max_time_width=10)
    for b in range(4):
        rows = (out[b] != mel[b]).all(-1)
        assert int(rows.sum()) <= 20
    out = spec_augment(gen(3), mel, time_masks=0, max_freq_width=5)
    for b in range(4):
        assert int((out[b] != mel[b]).all(0).sum()) <= 10
    assert torch.equal(spec_augment(gen(0), mel, time_masks=0, freq_masks=0),
                       mel)


def test_wer_matches_jax():
    cases = [(["a b c"], ["a b c"]), (["a b c"], ["a x c"]), (["a b"], ["a b c"]),
             (["a b c d"], [""]), (["a b", "c d"], ["a b", "c x"]),
             ([""], [""]), ([""], ["x y"]),
             (["the cat sat on the mat"], ["cat sat in the the mat"])]
    for refs, hyps in cases:
        assert word_error_rate(refs, hyps) == jax_wer(refs, hyps)
    assert edit_distance("kitten", "sitting") == 3
    with pytest.raises(ValueError):
        word_error_rate(["a"], [])


def test_wav_codec_and_resample_match_jax(tmp_path, rng):
    x = (0.5 * rng.standard_normal((4000, 2))).astype(np.float32)
    for bits in (16, 32):
        path = str(tmp_path / f"x{bits}.wav")
        IO.write_wav(path, x, 22050, bits=bits)
        ours, rate = IO.read_wav(path)
        ref, jrate = JIO.read_wav(path)
        assert rate == jrate == 22050
        np.testing.assert_array_equal(ours, ref)
    mono = IO.to_mono(ours)
    np.testing.assert_array_equal(mono, JIO.to_mono(ref))
    np.testing.assert_array_equal(IO.resample(mono, 22050, 16000),
                                  JIO.resample(mono, 22050, 16000))


def test_entry_point_device_and_parallel_rules(setup):
    _, _, tok, _, _, cfg, params = setup
    ft = FineTuneConfig(max_steps=1, batch_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            F.finetune_whisper(params, cfg, tok, [], ft)
    for kw in (dict(mesh="m"), dict(fsdp=True), dict(sp_mesh="m")):
        with pytest.raises(NotImplementedError, match="parallelism"):
            F.finetune_whisper(params, cfg, tok, [], ft, device="cpu", **kw)
