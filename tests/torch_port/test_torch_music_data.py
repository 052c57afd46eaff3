"""The port's MIDI datagen and music data pipeline (``audax_torch/data/
synth.py``'s MIDI half, ``music_dataset.py``, ``quality.py``) vs the JAX
package's, on the CPU.

Tolerances: the additive synth (``render_simple``, numpy) against the JAX
package's native C++ ``render_simple`` at 1e-5 (float64 sines from two
libms, rounded to float32); WAVs read back at one 16-bit step (1/32768:
a float that rounds the other way crosses a PCM step); everything else
exact -- MIDI bytes, labels, ABC, vocabularies, Parquet columns but the
waveform, ``MusicDataset`` ids and masks, the quality reports and their
formatted text.
"""

import csv
import json
import os

import numpy as np
import pytest

from audax.core.config import DataGenConfig as JaxDataGenConfig
from audax.data import music_dataset as JD
from audax.data import quality as JQ
from audax.data import synth as JSynth
from audax.native import bindings as JNative
from audax.symbolic.bpe import BPE as JaxBPE
from audax_torch.core.config import DataGenConfig
from audax_torch.data import music_dataset as PD
from audax_torch.data import quality as PQ
from audax_torch.data import synth as PSynth
from audax_torch.data.audio_io import read_wav
from audax_torch.symbolic.bpe import BPE

PCM = 1.0 / 32768


def _wav(path):
    return read_wav(path)[0]


@pytest.mark.parametrize("poly", [1, 3])
@pytest.mark.parametrize("seed", [0, 5])
def test_render_simple_matches_native(seed, poly):
    rng = np.random.default_rng(seed)
    for n in (1, 4, 9):
        mf, _ = PSynth._random_melody(rng, n, 100, max_poly=poly)
        ours = PSynth.render_simple(mf)
        ref = JNative.render_simple(mf)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(PSynth.render_midi(mf, 16000), ours)
        np.testing.assert_array_equal(
            PSynth._numpy_fallback_synth(mf, 16000),
            JSynth._numpy_fallback_synth(mf, 16000))


def test_soundfont_raises(tmp_path):
    """A soundfont that does not parse raises: the SF2 synth has no
    fallback voice (the JAX package falls back to its additive synth)."""
    mf = PSynth.piano_full_range("")
    with pytest.raises(ValueError, match="soundfont"):
        PSynth.render_midi(mf, soundfont="piano.sf2")
    with pytest.raises(ValueError, match="soundfont"):
        PSynth.make_midi_dataset(DataGenConfig(num_items=1,
                                               out_dir=str(tmp_path),
                                               soundfont="piano.sf2"))


def test_piano_full_range_matches_jax(tmp_path):
    assert PSynth.piano_full_range("").to_bytes() == \
        JSynth.piano_full_range("").to_bytes()


JITTER = dict(velocity_jitter=20, gain_jitter_db=6.0, noise_snr_db=25.0)


@pytest.mark.parametrize("jitter", [False, True])
def test_make_midi_dataset_matches_jax(tmp_path, jitter):
    kw = dict(num_items=4, notes_per_item=3, seed=7,
              **(JITTER if jitter else {}))
    ours = PSynth.make_midi_dataset(DataGenConfig(
        out_dir=str(tmp_path / "p"), **kw))
    ref = JSynth.make_midi_dataset(JaxDataGenConfig(
        out_dir=str(tmp_path / "j"), **kw))

    def rows(path):
        with open(path, newline="") as fh:
            return [(os.path.basename(r["filename"]), r["labels"])
                    for r in csv.DictReader(fh)]
    assert rows(ours) == rows(ref)
    for name, _ in rows(ours):
        p, j = (os.path.join(os.path.dirname(c), "wavs", name)
                for c in (ours, ref))
        with open(p[:-4] + ".mid", "rb") as a, open(j[:-4] + ".mid",
                                                    "rb") as b:
            assert a.read() == b.read()
        np.testing.assert_allclose(_wav(p), _wav(j), atol=PCM, rtol=0)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """Both packages' four stages over the same MIDI folder (eight random
    melodies, the last four polyphonic; one empty file, one ABC without a
    WAV)."""
    root = tmp_path_factory.mktemp("stages")
    midi = root / "midi"
    (midi / "sub").mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i in range(8):
        mf, _ = PSynth._random_melody(rng, 4 + i, 100,
                                      max_poly=1 if i < 4 else 3)
        mf.save(str((midi / "sub" if i % 2 else midi) / f"m{i}.mid"))
    PSynth.piano_full_range("").__class__().save(str(midi / "empty.mid"))
    out = {}
    for tag, mod, cfg in (("p", PD, DataGenConfig(chunk_duration_s=2.0)),
                          ("j", JD, JaxDataGenConfig(chunk_duration_s=2.0))):
        d = root / tag
        mod.stage_midi2wav(str(midi), str(d / "wav"), cfg, workers=1)
        mod.stage_midi2abc(str(d / "wav"), str(d / "abc"), workers=1)
        with open(d / "abc" / "orphan.abc", "w") as fh:
            fh.write("X:1\nT:orphan\nK:C\nCDE|\n")
        vocab = mod.stage_gentokens_raw(str(d / "abc"),
                                        str(d / "raw.json"))
        bpe = mod.stage_gentokens_bpe(str(d / "abc"), str(d / "bpe"), 200)
        pq = mod.stage_genparquet(str(d / "wav"), str(d / "abc"),
                                  str(d / "music.parquet"), batch_rows=3)
        out[tag] = dict(dir=d, vocab=vocab, bpe=bpe, parquet=pq)
    return out


def test_stage_files_match_jax(stages):
    p, j = stages["p"]["dir"], stages["j"]["dir"]
    for sub in ("wav", "abc"):
        assert sorted(os.listdir(p / sub)) == sorted(os.listdir(j / sub))
    assert "empty.wav" not in os.listdir(p / "wav")
    for name in os.listdir(p / "wav"):
        if name.endswith(".mid"):
            assert (p / "wav" / name).read_bytes() == \
                (j / "wav" / name).read_bytes()
        else:
            np.testing.assert_allclose(_wav(p / "wav" / name),
                                       _wav(j / "wav" / name), atol=PCM)
    for name in os.listdir(p / "abc"):
        assert (p / "abc" / name).read_text() == \
            (j / "abc" / name).read_text()
    assert stages["p"]["vocab"] == stages["j"]["vocab"]
    assert (p / "raw.json").read_text() == (j / "raw.json").read_text()
    for name in ("vocab.json", "merges.txt"):
        assert (p / "bpe" / name).read_text() == \
            (j / "bpe" / name).read_text()


def test_parquet_rows_match_jax(stages):
    import pyarrow.parquet as pq
    ours = pq.read_table(stages["p"]["parquet"])
    ref = pq.read_table(stages["j"]["parquet"])
    assert ours.schema == ref.schema
    assert ours.column("filename").to_pylist() == \
        ref.column("filename").to_pylist()
    for col in ref.column_names:
        if col != "waveform":
            assert ours.column(col).to_pylist() == \
                ref.column(col).to_pylist(), col
    for a, b in zip(ours.column("waveform").to_pylist(),
                    ref.column("waveform").to_pylist()):
        np.testing.assert_allclose(a, b, atol=PCM)
    assert ours.column("processing_success").to_pylist().count(False) == 1


@pytest.mark.parametrize("max_tokens", [16, 512])
def test_music_dataset_items_match_jax(stages, max_tokens):
    ours = PD.MusicDataset(stages["p"]["parquet"],
                           BPE.load(str(stages["p"]["dir"] / "bpe")),
                           max_tokens=max_tokens)
    ref = JD.MusicDataset(stages["j"]["parquet"],
                          JaxBPE.load(str(stages["j"]["dir"] / "bpe")),
                          max_tokens=max_tokens)
    assert len(ours) == len(ref) == 8
    assert (ours.start_id, ours.end_id, ours.pad_id) == \
        (ref.start_id, ref.end_id, ref.pad_id)
    for a, b in zip(ours.examples(), ref.examples()):
        assert (a.filename, a.abc, a.sample_rate) == \
            (b.filename, b.abc, b.sample_rate)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
        assert a.waveform.dtype == np.float32
        np.testing.assert_allclose(a.waveform, b.waveform, atol=PCM)


def test_music_quality_report_matches_jax(stages):
    ours = PQ.music_quality_report(stages["p"]["parquet"])
    ref = JQ.music_quality_report(stages["j"]["parquet"])
    assert ours == ref
    assert PQ.format_report(ours, "music quality") == \
        JQ.format_report(ref, "music quality")


def test_urbansound_quality_report_matches_jax(tmp_path):
    """A hand-written feature Parquet: a failed row, a duplicate file name,
    a NaN feature, two shapes and uneven classes (ties among them)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from audax_torch.data.urbansound import _schema
    rng = np.random.default_rng(0)
    rows = [("a.wav", 1, 0, "dog", (4, 5)), ("b.wav", 2, 1, "siren", (4, 5)),
            ("c.wav", 2, 1, "siren", (4, 6)), ("a.wav", 3, 2, "drill", (4, 5)),
            ("e.wav", 1, 2, "drill", (4, 5)), ("f.wav", 3, 3, "horn", (4, 5)),
            ("g.wav", 2, 0, "dog", None)]
    feats = []
    for i, r in enumerate(rows):
        x = (rng.standard_normal(int(np.prod(r[4]))).astype(np.float32)
             if r[4] else np.zeros(0, np.float32))
        if i == 4:
            x[2] = np.nan
        feats.append(x)
    table = pa.table({
        "slice_file_name": [r[0] for r in rows],
        "fold": [r[1] for r in rows], "class_id": [r[2] for r in rows],
        "class_name": [r[3] for r in rows], "log_mel": feats,
        "mel_shape": [list(r[4] or ()) for r in rows],
        "processing_success": [r[4] is not None for r in rows]},
        schema=_schema())
    path = str(tmp_path / "us.parquet")
    pq.write_table(table, path)
    ours, ref = PQ.urbansound_quality_report(path), \
        JQ.urbansound_quality_report(path)
    assert json.dumps(ours, default=str) == json.dumps(ref, default=str)
    assert PQ.format_report(ours) == JQ.format_report(ref)
