"""ABC -> MIDI parser (the reverse of symbolic/abc.py's emitter).

Closes the symbolic round-trip the reference never had (it only consumed
ABC as LM targets; playback went through external `abc2midi`-class tools).
Parsing generated ABC back into MIDI enables validity checking and
note-level evaluation of the music-transcription model
(eval/music_metrics.py) — a real metric where the reference could only
eyeball degenerate outputs (AB/midiDatasetResults.csv).

Supported subset = everything the emitter produces plus common variants:
headers (X/T/M/L/Q/K), notes with accidentals/octave marks/fractional
durations, chords ``[CEG]``, rests, barlines, ties.

Port of ``audax/symbolic/abc_parse.py``: an own copy
(pure Python, the same behaviour), so the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Optional, Tuple

from audax_torch.symbolic.abc import extract_tokens
from audax_torch.symbolic.midi import (KeySignature, MidiFile, Note, Tempo,
                                 TimeSignature)

__all__ = ["abc_to_midi", "parse_abc_note", "AbcParseError"]


class AbcParseError(ValueError):
    pass


_NOTE_RE = re.compile(
    r"^(?P<acc>[_^=]{0,2})(?P<letter>[a-gA-G])(?P<oct>[,']*)"
    r"(?P<dur>\d*(?:/\d*)?)$")
_REST_RE = re.compile(r"^[zZxX](?P<dur>\d*(?:/\d*)?)$")

# shared with the emitter (abc.py) so both sides agree on what a key
# signature implies for unmarked letters
from audax_torch.symbolic.abc import (_KEY_SHARPS,  # noqa: E402
                                _LETTER_PC as _LETTER_PITCH,
                                key_accidentals as _key_accidentals)


def _parse_duration(text: str) -> Fraction:
    if not text:
        return Fraction(1)
    if "/" in text:
        num, _, den = text.partition("/")
        return Fraction(int(num) if num else 1, int(den) if den else 2)
    return Fraction(int(text))


def parse_abc_note(token: str, key_accidentals: Optional[dict] = None
                   ) -> Tuple[int, Fraction]:
    """'^c'2' -> (midi pitch, duration in unit-note-lengths)."""
    m = _NOTE_RE.match(token)
    if not m:
        raise AbcParseError(f"not a note token: {token!r}")
    letter = m.group("letter")
    upper = letter.upper()
    octave = 4 if letter.isupper() else 5
    for ch in m.group("oct"):
        octave += 1 if ch == "'" else -1
    pitch = (octave + 1) * 12 + _LETTER_PITCH[upper]
    acc = m.group("acc")
    if acc:
        pitch += acc.count("^") - acc.count("_")
        # '=' natural: no offset
    elif key_accidentals and upper in key_accidentals:
        pitch += key_accidentals[upper]
    return pitch, _parse_duration(m.group("dur"))


def abc_to_midi(abc_text: str, *, ticks_per_beat: int = 480,
                velocity: int = 90) -> MidiFile:
    """Parse ABC text into a MidiFile (tempo/key/meter honored)."""
    meter_num, meter_den = 4, 4
    unit: Optional[Fraction] = None
    bpm = 120
    key = "C"
    lines = abc_text.splitlines()
    key_line = None
    for i, line in enumerate(lines):
        if line.strip().startswith("K:"):
            # the FIRST K: ends the header (a later K: is a legal mid-tune
            # key change; splitting there would discard every earlier note)
            key_line = i
            break
    if key_line is None:
        # ABC requires K: as the final header; without it this is not a tune
        raise AbcParseError("missing K: header")
    for line in lines[: key_line + 1]:      # headers end at the first K:
        s = line.strip()
        if s.startswith("M:"):
            try:
                num, _, den = s[2:].strip().partition("/")
                meter_num, meter_den = int(num), int(den)
            except ValueError:
                pass
        elif s.startswith("L:"):
            try:
                num, _, den = s[2:].strip().partition("/")
                unit = Fraction(int(num), int(den or 1))
            except ValueError:
                pass
        elif s.startswith("Q:"):
            m = re.search(r"=\s*(\d+)", s) or re.match(r"Q:\s*(\d+)\s*$", s)
            if m:
                bpm = int(m.group(1))
        elif s.startswith("K:"):
            key = s[2:].strip() or "C"
    if unit is None:
        # ABC standard default: L=1/16 when the meter is below 3/4, else 1/8
        unit = (Fraction(1, 16) if Fraction(meter_num, meter_den)
                < Fraction(3, 4) else Fraction(1, 8))

    key_acc = _key_accidentals(key)
    mf = MidiFile(ticks_per_beat=ticks_per_beat)
    mf.tempos.append(Tempo(0, int(round(60e6 / bpm))))
    mf.time_signatures.append(TimeSignature(0, meter_num, meter_den))
    mf.key_signatures.append(KeySignature(0, _KEY_SHARPS.get(key, 0),
                                          key.endswith("m")))

    units_per_beat = Fraction(1, 4) / unit

    def to_ticks(units: Fraction) -> int:
        return int(round(units / units_per_beat * ticks_per_beat))

    cursor = Fraction(0)
    pending_tie: dict = {}
    tie_next = False
    n_parsed = 0
    body = "\n".join(lines[key_line + 1:])      # tune body starts after K:
    for tok in extract_tokens(body):
        if re.match(r"^[A-Za-z]:", tok):        # header line token
            continue
        if tok.startswith('"'):                 # chord symbol annotation
            continue
        if tok in ("|", "|]", "||", "[|", "|:", ":|", "::"):
            continue
        if tok == "-":
            tie_next = True
            continue
        if tok.startswith("("):                 # tuplet marker: unsupported,
            continue                            # durations stay literal
        rest = _REST_RE.match(tok)
        if rest:
            cursor += _parse_duration(rest.group("dur"))
            tie_next = False    # a rest breaks a tie ('C- z C' = two notes)
            continue
        if tok.startswith("["):                 # chord
            inner = tok[1:-1]
            sub = re.findall(r"[_^=]{0,2}[a-gA-G][,']*\d*(?:/\d*)?", inner)
            dur = Fraction(0)
            for s in sub:
                pitch, d = parse_abc_note(s, key_acc)
                _emit(mf, pending_tie, pitch, cursor, d, to_ticks, velocity,
                      tie_next)
                dur = max(dur, d)
                n_parsed += 1
            cursor += dur
            tie_next = False
            continue
        pitch, dur = parse_abc_note(tok, key_acc)
        _emit(mf, pending_tie, pitch, cursor, dur, to_ticks, velocity,
              tie_next)
        cursor += dur
        tie_next = False
        n_parsed += 1
    # flush ties left open
    for pitch, (start_u, dur_u) in pending_tie.items():
        mf.notes.append(Note(to_ticks(start_u),
                             max(to_ticks(dur_u), 1), pitch, velocity))
    if n_parsed == 0:
        raise AbcParseError("no notes found in ABC text")
    mf.notes.sort(key=lambda n: (n.start_tick, n.pitch))
    return mf


def _emit(mf, pending_tie, pitch, cursor, dur, to_ticks, velocity, tied):
    if tied and pitch in pending_tie:
        start_u, dur_u = pending_tie.pop(pitch)
        pending_tie[pitch] = (start_u, dur_u + dur)
        return
    if pitch in pending_tie:
        start_u, dur_u = pending_tie.pop(pitch)
        mf.notes.append(Note(to_ticks(start_u), max(to_ticks(dur_u), 1),
                             pitch, velocity))
    pending_tie[pitch] = (cursor, dur)
