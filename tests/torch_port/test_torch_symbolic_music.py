"""The port's symbolic music modules (``audax_torch/symbolic/midi.py``,
``abc.py``, ``abc_parse.py``, ``chords.py``) and music metrics
(``eval/music_metrics.py``) vs the JAX package's, on seeded random
melodies (mono and polyphonic, with key and time signatures and tempo
changes). Everything is exact: MIDI bytes, ABC strings, parsed notes,
tokens, metadata and the note P/R/F1 numbers."""

import dataclasses

import numpy as np
import pytest

from audax.data import synth as JSynth
from audax.eval import music_metrics as JM
from audax.symbolic import abc as JA
from audax.symbolic import abc_parse as JP
from audax.symbolic import chords as JC
from audax.symbolic import midi as JMidi
from audax_torch.data import synth as PSynth
from audax_torch.eval import music_metrics as PM
from audax_torch.symbolic import abc as PA
from audax_torch.symbolic import abc_parse as PP
from audax_torch.symbolic import chords as PC
from audax_torch.symbolic import midi as PMidi

SEEDS = [0, 1, 2, 3]


def _melodies(mod, seed, n=6):
    """Six random melodies (the last three polyphonic); the fourth gains a
    key and time signature, the fifth a tempo change."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mf, names = mod._random_melody(rng, 3 + i, 90 + i,
                                       max_poly=1 if i < 3 else 3)
        midi = JMidi if mod is JSynth else PMidi
        if i == 3:
            mf.key_signatures.append(midi.KeySignature(0, -2, False))
            mf.time_signatures.append(midi.TimeSignature(0, 3, 4))
        if i == 4:
            mf.tempos.append(midi.Tempo(960, 400000))
        out.append((mf, names))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_midi_bytes_and_round_trip_match_jax(seed):
    for (jm, jn), (pm, pn) in zip(_melodies(JSynth, seed),
                                  _melodies(PSynth, seed)):
        assert pn == jn
        data = pm.to_bytes()
        assert data == jm.to_bytes()
        back, jback = PMidi.MidiFile.from_bytes(data), \
            JMidi.MidiFile.from_bytes(data)
        assert [dataclasses.astuple(n) for n in back.notes] == \
            [dataclasses.astuple(n) for n in jback.notes]
        assert back.duration_seconds == jback.duration_seconds
        assert back.cut(1.3).to_bytes() == jback.cut(1.3).to_bytes()


def test_note_names_match_jax():
    for n in range(128):
        name = PMidi.note_number_to_name(n)
        assert name == JMidi.note_number_to_name(n)
        assert PMidi.note_name_to_number(name) == \
            JMidi.note_name_to_number(name)


@pytest.mark.parametrize("seed", SEEDS)
def test_abc_round_trip_matches_jax(seed):
    """midi_to_abc strings, their tokens and metadata, and abc_to_midi's
    notes."""
    for (jm, _), (pm, _) in zip(_melodies(JSynth, seed),
                                _melodies(PSynth, seed)):
        abc = PA.midi_to_abc(pm, title=f"s{seed}")
        assert abc == JA.midi_to_abc(jm, title=f"s{seed}")
        assert PA.extract_tokens(abc) == JA.extract_tokens(abc)
        assert PA.extract_tokens(abc, drop_path_tokens=False) == \
            JA.extract_tokens(abc, drop_path_tokens=False)
        assert dataclasses.asdict(PA.extract_abc_metadata(abc)) == \
            dataclasses.asdict(JA.extract_abc_metadata(abc))
        assert PP.abc_to_midi(abc).to_bytes() == \
            JP.abc_to_midi(abc).to_bytes()


@pytest.mark.parametrize("key", ["C", "G", "F", "Bb", "D", "Am", "Ebm",
                                 "F#", "Cb"])
def test_key_accidentals_match_jax(key):
    assert PA.key_accidentals(key) == JA.key_accidentals(key)


@pytest.mark.parametrize("token", ["C", "^c'", "_B,,", "=e2", "G3/2",
                                   "a/", "z", "^^F", "c//"])
def test_parse_abc_note_matches_jax(token):
    def parse(mod):
        try:
            return mod.parse_abc_note(token)
        except ValueError as e:          # AbcParseError, in both
            return type(e).__name__
    assert parse(PP) == parse(JP)


@pytest.mark.parametrize("text", ["", "X:1\nK:C\n[CEG", "not abc at all",
                                  "X:1\nK:Q\nC"])
def test_bad_abc_raises_like_jax(text):
    def parse(mod):
        try:
            return mod.abc_to_midi(text).to_bytes()
        except ValueError as e:
            return type(e).__name__
    assert parse(PP) == parse(JP)


CHORDS = ["C", "Am", "F#7", "Bbmaj7", "Dm7", "G6", "Ebm", "E"]


def test_chords_match_jax():
    for sym in CHORDS:
        assert PC.parse_chord(sym) == JC.parse_chord(sym)
        assert PC.parse_chord(sym, octave=3) == JC.parse_chord(sym, octave=3)
    chart = [(s, 0.75 * i) for i, s in enumerate(CHORDS)]
    for kw in ({}, dict(total_seconds=8.0, bpm=96.0, velocity=70)):
        assert PC.chords_to_midi(chart, **kw).to_bytes() == \
            JC.chords_to_midi(chart, **kw).to_bytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_note_metrics_match_jax(seed):
    """note_prf between melodies and their ABC round trips, abc_note_prf on
    the ABC (and on a truncated, unparseable one), abc_validity_rate."""
    mels = _melodies(PSynth, seed)
    abcs = [PA.midi_to_abc(m, title="x") for m, _ in mels]
    texts = abcs + [a[: len(a) // 2] for a in abcs] + ["garbage"]
    for (m, _), (h, _) in zip(mels, mels[1:] + mels[:1]):
        for tol in (0.05, 0.3):
            assert PM.note_prf(m, h, onset_tolerance=tol) == \
                JM.note_prf(m, h, onset_tolerance=tol)
    for (m, _), text in zip(mels * 2, texts):
        assert PM.abc_note_prf(m, text) == JM.abc_note_prf(m, text)
    assert PM.abc_validity_rate(texts) == JM.abc_validity_rate(texts)
