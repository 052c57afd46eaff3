"""ABC notation: emitter (MIDI -> ABC), metadata extraction, tokenization.

In-framework replacement for the external ``midi2abc`` C binary and the
reference's regex layers (reference: midi2abc subprocess at
.charles/music2midi/preprocess_data.py:150-168; token regex :176-211;
metadata extraction :213-248).

The emitter is tempo-map aware: note times come from MidiFile's tick domain,
quantized to the unit note length, grouped into chords, barred by the time
signature.

Port of ``audax/symbolic/abc.py``: an own copy
(pure Python, the same behaviour), so the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from audax_torch.symbolic.midi import KeySignature, MidiFile

__all__ = ["midi_to_abc", "extract_abc_metadata", "extract_tokens",
           "AbcMetadata", "key_accidentals"]

_SHARP_NAMES = ["C", "^C", "D", "^D", "E", "F", "^F", "G", "^G", "A", "^A", "B"]
_FLAT_NAMES = ["C", "_D", "D", "_E", "E", "F", "_G", "G", "_A", "A", "_B", "B"]

_LETTER_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
# key signature -> letters sharpened (positive) / flattened (negative);
# the parser (abc_parse.py) imports these so emitter and parser can never
# disagree about what a key signature implies
_SHARP_ORDER = "FCGDAEB"
_FLAT_ORDER = "BEADGCF"
_KEY_SHARPS = {"C": 0, "G": 1, "D": 2, "A": 3, "E": 4, "B": 5, "F#": 6,
               "C#": 7, "F": -1, "Bb": -2, "Eb": -3, "Ab": -4, "Db": -5,
               "Gb": -6, "Cb": -7,
               "Am": 0, "Em": 1, "Bm": 2, "F#m": 3, "C#m": 4, "G#m": 5,
               "D#m": 6, "A#m": 7, "Dm": -1, "Gm": -2, "Cm": -3, "Fm": -4,
               "Bbm": -5, "Ebm": -6, "Abm": -7}


def key_accidentals(key: str) -> dict:
    """Key name -> {letter: ±1} accidental map (ABC key-signature rule)."""
    sharps = _KEY_SHARPS.get(key.strip(), 0)
    out = {}
    if sharps > 0:
        for letter in _SHARP_ORDER[:sharps]:
            out[letter] = 1
    elif sharps < 0:
        for letter in _FLAT_ORDER[:-sharps]:
            out[letter] = -1
    return out


def _pitch_to_abc(pitch: int, *, flats: bool = False,
                  key_acc: Optional[dict] = None) -> str:
    """MIDI pitch -> ABC note, KEY-AWARE. ABC middle C (C4, MIDI 60) is
    ``C``; octave up is lowercase, further octaves use ' and , marks.

    Under a key signature, unmarked letters are read with the key's
    accidentals (abc_parse.py applies them), so the emitter must spell
    accordingly: a pitch the key already covers emits the plain letter, a
    natural the key would alter emits ``=``, everything else an explicit
    ``^``/``_`` (explicit accidentals override the key in the parser) —
    otherwise every natural note in a non-C tune round-trips a semitone
    off."""
    key_acc = key_acc or {}
    pc = pitch % 12
    letter = acc = None
    delta = 0
    # 1. a key-altered letter already lands on this pitch: plain spelling
    for lt, base_pc in _LETTER_PC.items():
        d = key_acc.get(lt, 0)
        if d and (base_pc + d) % 12 == pc:
            letter, acc, delta = lt, "", d
            break
    if letter is None:
        # 2. a natural letter: '=' if the key would alter it
        for lt, base_pc in _LETTER_PC.items():
            if base_pc == pc:
                letter = lt
                acc = "=" if key_acc.get(lt, 0) else ""
                break
    if letter is None:
        # 3. chromatic: explicit accidental (overrides the key)
        name = (_FLAT_NAMES if flats else _SHARP_NAMES)[pc]
        acc, letter = name[0], name[1]
        delta = 1 if acc == "^" else -1
    # octave of the LETTER's natural pitch (a wrapped spelling like Cb for
    # B shifts the written octave)
    octave = (pitch - delta) // 12 - 1             # MIDI octave (C4 = 60)
    if octave >= 5:
        return acc + letter.lower() + "'" * (octave - 5)
    return acc + letter + "," * (4 - octave)


def _dur_to_abc(units: Fraction) -> str:
    """Duration in unit-note-lengths -> ABC suffix ('' for 1, '2', '/2',
    '3/2', ...)."""
    if units == 1:
        return ""
    if units.denominator == 1:
        return str(units.numerator)
    if units.numerator == 1 and units.denominator == 2:
        return "/"
    return f"{units.numerator}/{units.denominator}"


def midi_to_abc(
    mf: MidiFile,
    *,
    title: str = "untitled",
    unit: Fraction = Fraction(1, 8),
    index: int = 1,
    max_denominator: int = 4,
) -> str:
    """Render a MidiFile as single-voice ABC (simultaneous notes become
    chords ``[CEG]``). Quantization grid = unit/max_denominator."""
    ts = mf.time_signatures[0] if mf.time_signatures else None
    meter_num, meter_den = (ts.numerator, ts.denominator) if ts else (4, 4)
    key = mf.key_signatures[0] if mf.key_signatures else KeySignature(0, 0)
    tempo = mf.tempos[0] if mf.tempos else None
    bpm = round(tempo.bpm) if tempo else 120
    flats = key.sharps < 0
    key_acc = key_accidentals(key.name)

    # quantize to grid in unit-note-lengths
    beat_units = Fraction(1, 4) / unit             # units per quarter note
    grid = Fraction(1, max_denominator)

    def to_units(tick: int) -> Fraction:
        beats = Fraction(tick, mf.ticks_per_beat)
        return (beats * beat_units).limit_denominator(max_denominator * 8)

    def snap(u: Fraction) -> Fraction:
        return Fraction(round(u / grid)) * grid

    events: Dict[Fraction, List[Tuple[int, Fraction]]] = {}
    for n in mf.notes:
        start = snap(to_units(n.start_tick))
        dur = max(snap(to_units(n.duration_tick)), grid)
        events.setdefault(start, []).append((n.pitch, dur))

    bar_units = Fraction(meter_num, meter_den) / unit   # units per measure
    body: List[str] = []
    cursor = Fraction(0)
    bar_fill = Fraction(0)

    def emit_bars(advance: Fraction):
        nonlocal bar_fill
        bar_fill += advance
        while bar_fill >= bar_units:
            body.append("|")
            bar_fill -= bar_units

    # single-voice ABC cannot hold a note across the next onset; truncate
    # durations at the following event's start so every note still BEGINS
    # at its true time — advancing the cursor by the full duration instead
    # would time-shift all later notes and barlines (rhythmic drift)
    starts = sorted(events)
    for i, start in enumerate(starts):
        if start > cursor:                          # rest gap
            gap = start - cursor
            body.append("z" + _dur_to_abc(gap))
            emit_bars(gap)
            cursor = start
        group = events[start]
        if i + 1 < len(starts):
            allowed = starts[i + 1] - start
            group = [(p, max(min(d, allowed), grid)) for p, d in group]
        dur = min(d for _, d in group)
        if len(group) == 1:
            body.append(_pitch_to_abc(group[0][0], flats=flats,
                                      key_acc=key_acc)
                        + _dur_to_abc(group[0][1]))
            dur = group[0][1]
        else:
            inner = "".join(_pitch_to_abc(p, flats=flats, key_acc=key_acc)
                            + _dur_to_abc(d)
                            for p, d in sorted(group))
            body.append(f"[{inner}]")
        cursor += dur
        emit_bars(dur)
    if body and body[-1] == "|":
        body.pop()                                  # '|]' closes the bar
    body.append("|]")

    header = [
        f"X:{index}",
        f"T:{title}",
        f"M:{meter_num}/{meter_den}",
        f"L:{unit.numerator}/{unit.denominator}",
        f"Q:1/4={bpm}",
        f"K:{key.name}",
    ]
    # wrap body ~ 16 tokens per line
    lines, line = [], []
    for tok in body:
        line.append(tok)
        if tok in ("|", "|]") and len(line) >= 16:
            lines.append(" ".join(line))
            line = []
    if line:
        lines.append(" ".join(line))
    return "\n".join(header + lines) + "\n"


@dataclass
class AbcMetadata:
    title: Optional[str] = None
    meter: Optional[str] = None
    unit_length: Optional[str] = None
    tempo: Optional[int] = None
    key: Optional[str] = None


def extract_abc_metadata(abc_text: str) -> AbcMetadata:
    """Parse header fields (reference: preprocess_data.py:213-248)."""
    md = AbcMetadata()
    for line in abc_text.splitlines():
        line = line.strip()
        if line.startswith("T:"):
            md.title = line[2:].strip()
        elif line.startswith("M:"):
            md.meter = line[2:].strip()
        elif line.startswith("L:"):
            md.unit_length = line[2:].strip()
        elif line.startswith("Q:"):
            m = re.search(r"=\s*(\d+)", line)
            md.tempo = int(m.group(1)) if m else None
            if md.tempo is None:
                m = re.match(r"Q:\s*(\d+)\s*$", line)
                md.tempo = int(m.group(1)) if m else None
        elif line.startswith("K:"):
            md.key = line[2:].strip()
    return md


_TOKEN_PATTERN = re.compile(
    r"(?P<header>^[XTMLQKVPZNRSOWmw]:[^\n]*$)"
    r"|(?P<chordsym>\"[^\"]*\")"
    r"|(?P<chord>\[[^\]\n|]+\])"  # no '|': '[| ... |]' is a barline span,
                                  # not one chord of the whole measure
    r"|(?P<note>[_^=]{0,2}[a-gA-G][,']*\d*(?:/\d*)?)"
    r"|(?P<rest>[zZxX]\d*(?:/\d*)?)"
    r"|(?P<bar>\|\]|\[\||\|\||:\||\|:|::|\|)"
    r"|(?P<tuplet>\(\d)"
    r"|(?P<tie>-)",
    re.MULTILINE,
)


def extract_tokens(abc_text: str, *, drop_path_tokens: bool = True
                   ) -> List[str]:
    """ABC text -> token list: header lines whole, chords, annotated notes
    (accidental+octave+duration), rests, barlines, tuplet markers, ties
    (reference regex semantics, preprocess_data.py:176-211 including the
    path-pollution filter :200-209)."""
    tokens = []
    for m in _TOKEN_PATTERN.finditer(abc_text):
        tok = m.group(0)
        if drop_path_tokens and ("/" in tok and any(
                s in tok for s in (".mid", ".abc", "/home", "/tmp", "\\"))):
            continue
        tokens.append(tok)
    return tokens
