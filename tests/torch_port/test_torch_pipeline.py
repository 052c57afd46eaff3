"""The port's host input pipelines (``audax_torch/data/pipeline.py``)
against the JAX package's grain pipelines (``audax/data/grain_pipeline.py``)
on the same Parquet files, with ``tests/test_grain.py``'s cases.

Without shuffling the batches are JAX's exactly. grain's permutation is
grain's own, so with shuffling the port holds what the JAX tests hold:
the shapes, the same order for the same seed, another order for another
seed, and (beyond them) every row once in each pass.
"""

import itertools
import os

import numpy as np
import pytest

from audax.core.config import DataGenConfig, MelConfig, UrbanSoundConfig
from audax.data import grain_pipeline as G
from audax_torch.data import pipeline as P


def _same(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def us_parquet(tmp_path_factory):
    import pandas as pd

    from audax.data.audio_io import write_wav
    from audax.data.urbansound import preprocess_to_parquet
    tmp = tmp_path_factory.mktemp("us")
    rng = np.random.default_rng(0)
    root = tmp / "US"
    rows = []
    for fold in (1, 2):
        d = root / "audio" / f"fold{fold}"
        os.makedirs(d)
        for i in range(5):
            name = f"f{fold}_{i}.wav"
            write_wav(str(d / name),
                      (0.2 * rng.standard_normal(8000)).astype(np.float32),
                      16000)
            rows.append({"slice_file_name": name, "fold": fold,
                         "classID": i % 3, "class": f"c{i % 3}"})
    os.makedirs(root / "metadata")
    pd.DataFrame(rows).to_csv(root / "metadata" / "UrbanSound8K.csv",
                              index=False)
    cfg = UrbanSoundConfig(dataset_root=str(root),
                           parquet_dir=str(tmp / "art"))
    return preprocess_to_parquet(cfg, MelConfig(n_fft=256, hop_length=256,
                                                n_mels=8))


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    """A three-item music Parquet and the BPE of both packages over its
    ABC (the same vocabulary)."""
    from audax.data.music_dataset import (ABC_SPECIALS, stage_genparquet,
                                          stage_midi2abc, stage_midi2wav)
    from audax.symbolic.bpe import train_bpe as jtrain_bpe
    from audax.symbolic.midi import MidiFile, Note, Tempo
    from audax_torch.symbolic.bpe import train_bpe
    tmp = tmp_path_factory.mktemp("music")
    midi_dir = tmp / "m"
    os.makedirs(midi_dir)
    for i in range(3):
        mf = MidiFile()
        mf.tempos.append(Tempo(0, 500000))
        for j in range(4):
            mf.notes.append(Note(j * 480, 480, 60 + i + j, 100))
        mf.save(str(midi_dir / f"x{i}.mid"))
    wav_dir, abc_dir = str(tmp / "w"), str(tmp / "a")
    stage_midi2wav(str(midi_dir), wav_dir, DataGenConfig(chunk_duration_s=3),
                   workers=1)
    stage_midi2abc(wav_dir, abc_dir, workers=1)
    parquet = stage_genparquet(wav_dir, abc_dir, str(tmp / "m.parquet"))
    abcs = [open(os.path.join(abc_dir, f)).read()
            for f in sorted(os.listdir(abc_dir))]
    jbpe = jtrain_bpe(abcs, vocab_size=300, special_tokens=list(ABC_SPECIALS))
    bpe = train_bpe(abcs, vocab_size=300, special_tokens=list(ABC_SPECIALS))
    assert bpe.vocab == jbpe.vocab
    return parquet, jbpe, bpe


@pytest.mark.parametrize("batch_size,epochs,drop", [
    (4, 1, True), (5, 3, True), (4, 2, True), (3, 1, False)])
def test_urbansound_unshuffled_matches_grain(us_parquet, batch_size, epochs,
                                             drop):
    """Batches across the epochs' seams and the remainder rule, as
    grain batches them."""
    kw = dict(folds=[1, 2], batch_size=batch_size, shuffle=False,
              epochs=epochs, drop_remainder=drop)
    _same(P.urbansound_dataset(us_parquet, **kw),
          G.urbansound_dataset(us_parquet, **kw))


def test_urbansound_batches_and_seeds(us_parquet):
    """``tests/test_grain.py``'s shapes and seed rules."""
    ds = P.urbansound_dataset(us_parquet, folds=[1, 2], batch_size=4, seed=0)
    batches = list(ds)
    assert len(batches) == 2                 # 10 rows, drop remainder
    assert batches[0]["x"].shape[0] == 4 and batches[0]["x"].ndim == 3
    assert batches[0]["y"].shape == (4,)
    again = list(P.urbansound_dataset(us_parquet, folds=[1, 2],
                                      batch_size=4, seed=0))
    for a, b in zip(batches, again):
        np.testing.assert_array_equal(a["x"], b["x"])
    other = list(P.urbansound_dataset(us_parquet, folds=[1, 2],
                                      batch_size=4, seed=7))
    assert not all(np.array_equal(a["y"], b["y"])
                   for a, b in zip(batches, other))
    assert len(list(ds)) == 2                # re-iterable
    jb = list(G.urbansound_dataset(us_parquet, folds=[1, 2], batch_size=4,
                                   seed=0))
    assert [b["x"].shape for b in jb] == [b["x"].shape for b in batches]


@pytest.mark.parametrize("seed", [0, 3])
def test_urbansound_shuffled_epochs_hold_every_row(us_parquet, seed):
    """Each pass a permutation of the unshuffled rows: the same multiset
    of rows (x with its y) every epoch."""
    plain = next(iter(P.urbansound_dataset(
        us_parquet, folds=[1, 2], batch_size=10, shuffle=False)))
    shuffled = list(P.urbansound_dataset(
        us_parquet, folds=[1, 2], batch_size=10, seed=seed, epochs=3))
    assert len(shuffled) == 3

    def rows(b):
        return sorted((float(x.sum()), int(y)) for x, y in zip(b["x"],
                                                              b["y"]))
    for b in shuffled:
        assert rows(b) == rows(plain)
    assert not np.array_equal(shuffled[0]["x"], shuffled[1]["x"])


def test_urbansound_forever(us_parquet):
    """``epochs=None`` repeats without end, as grain's ``repeat()``."""
    kw = dict(folds=[1, 2], batch_size=5, shuffle=False, epochs=None)
    _same(itertools.islice(P.urbansound_dataset(us_parquet, **kw), 7),
          itertools.islice(G.urbansound_dataset(us_parquet, **kw), 7))


@pytest.mark.parametrize("max_tokens", [64, 6])
def test_waveform_with_tokenizer_matches_grain(music, max_tokens):
    """Waveforms pad-or-trimmed, the ids, the masks and (at 6 tokens) the
    end token kept on truncation, batch for batch."""
    parquet, jbpe, bpe = music
    kw = dict(batch_size=3, n_samples=16000, max_tokens=max_tokens,
              shuffle=False)
    ours = list(P.waveform_dataset(parquet, tokenizer=bpe, **kw))
    _same(ours, G.waveform_dataset(parquet, tokenizer=jbpe, **kw))
    batch = ours[0]
    assert batch["waveform"].shape == (3, 16000)
    assert batch["input_ids"].shape == (3, max_tokens)
    assert (batch["input_ids"][:, 0] == bpe.vocab["<abc_start>"]).all()
    if max_tokens == 6:
        assert (batch["input_ids"][:, -1] == bpe.vocab["<abc_end>"]).all()


def test_waveform_without_tokenizer_matches_grain(music):
    parquet, _, _ = music
    kw = dict(batch_size=2, n_samples=80000, shuffle=False, epochs=2,
              drop_remainder=False)
    _same(P.waveform_dataset(parquet, **kw), G.waveform_dataset(parquet,
                                                                **kw))
