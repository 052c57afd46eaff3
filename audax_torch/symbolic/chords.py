"""Chord-symbol parsing and chord-chart -> MIDI.

Rebuilds .charles/chords2midi.py (parse_chord :41-87,
create_midi_from_chords :92-166): chord symbols with maj/min/6/7/maj7/m7
qualities plus timestamps become a MidiFile.

Port of ``audax/symbolic/chords.py``: an own copy
(pure Python, the same behaviour), so the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from audax_torch.symbolic.midi import MidiFile, Note, Tempo, TimeSignature, note_name_to_number

__all__ = ["parse_chord", "chords_to_midi"]

_QUALITIES = {
    "": (0, 4, 7),
    "maj": (0, 4, 7),
    "m": (0, 3, 7),
    "min": (0, 3, 7),
    "dim": (0, 3, 6),
    "aug": (0, 4, 8),
    "sus2": (0, 2, 7),
    "sus4": (0, 5, 7),
    "6": (0, 4, 7, 9),
    "m6": (0, 3, 7, 9),
    "7": (0, 4, 7, 10),
    "maj7": (0, 4, 7, 11),
    "m7": (0, 3, 7, 10),
    "m7b5": (0, 3, 6, 10),
    "dim7": (0, 3, 6, 9),
}


def parse_chord(symbol: str, *, octave: int = 4) -> List[int]:
    """'Am7' -> MIDI pitches. Root note + optional #/b + quality suffix."""
    symbol = symbol.strip()
    i = 1
    while i < len(symbol) and symbol[i] in "#b":
        i += 1
    root_name, quality = symbol[:i], symbol[i:]
    root = note_name_to_number(f"{root_name}{octave}")
    if quality not in _QUALITIES:
        raise ValueError(f"unknown chord quality {quality!r} in {symbol!r}")
    return [root + iv for iv in _QUALITIES[quality]]


def chords_to_midi(
    chords: Sequence[Tuple[str, float]],
    *,
    total_seconds: float | None = None,
    bpm: float = 120.0,
    velocity: int = 80,
    ticks_per_beat: int = 480,
) -> MidiFile:
    """[(symbol, start_seconds)] -> MidiFile; each chord sustains until the
    next one (last until total_seconds or +2 beats)."""
    mf = MidiFile(ticks_per_beat=ticks_per_beat)
    us_per_beat = int(round(60e6 / bpm))
    mf.tempos.append(Tempo(0, us_per_beat))
    mf.time_signatures.append(TimeSignature(0, 4, 4))

    def to_tick(sec: float) -> int:
        return int(round(sec * 1e6 / us_per_beat * ticks_per_beat))

    ordered = sorted(chords, key=lambda c: c[1])
    for i, (symbol, start) in enumerate(ordered):
        if i + 1 < len(ordered):
            end = ordered[i + 1][1]
        elif total_seconds is not None:
            end = total_seconds
        else:
            end = start + 2 * 60.0 / bpm
        start_t, end_t = to_tick(start), to_tick(end)
        for pitch in parse_chord(symbol):
            mf.notes.append(Note(start_t, max(end_t - start_t, 1), pitch,
                                 velocity))
    return mf
