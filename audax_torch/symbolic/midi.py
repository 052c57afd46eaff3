"""MIDI data model + Standard MIDI File codec + tempo-aware cutting.

Owns the capability the reference assembled from mido + pretty_midi +
music21 (reference: AB/midiDatasetGen.py, AB/synthDataset.py,
.charles/chords2midi.py:92-166, and the thrice-attempted tempo-aware cut in
.charles/music2midi/preprocess_data.py:54-116 / test/music21_tests.py:117-196).

Design: notes live in *ticks*; a tempo map (also in ticks) converts to
seconds exactly, handling mid-score tempo changes — the failure mode that
broke the reference's first two cut attempts (test/README.md:44-75: local vs
global offsets, multi-track, tempo changes).

Port of ``audax/symbolic/midi.py``: an own copy
(pure Python, the same behaviour), so the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field, replace
from typing import List, Tuple

__all__ = ["Note", "Tempo", "TimeSignature", "KeySignature", "MidiFile",
           "NOTE_NAMES", "note_number_to_name", "note_name_to_number"]

NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")


def note_number_to_name(n: int) -> str:
    """60 -> 'C4' (reference: AB/synthDataset.py:17-20 convention)."""
    return f"{NOTE_NAMES[n % 12]}{n // 12 - 1}"


def note_name_to_number(name: str) -> int:
    i = 1
    while i < len(name) and name[i] in "#b":
        i += 1
    pitch = NOTE_NAMES.index(name[0].upper())
    for ch in name[1:i]:
        pitch += 1 if ch == "#" else -1
    return (int(name[i:]) + 1) * 12 + pitch


@dataclass(frozen=True)
class Note:
    start_tick: int
    duration_tick: int
    pitch: int
    velocity: int = 100
    channel: int = 0

    @property
    def end_tick(self) -> int:
        return self.start_tick + self.duration_tick


@dataclass(frozen=True)
class Tempo:
    tick: int
    us_per_beat: int            # microseconds per quarter note

    @property
    def bpm(self) -> float:
        return 60e6 / self.us_per_beat


@dataclass(frozen=True)
class TimeSignature:
    tick: int
    numerator: int
    denominator: int


@dataclass(frozen=True)
class KeySignature:
    tick: int
    sharps: int                 # -7..7
    minor: bool = False

    @property
    def name(self) -> str:
        majors = ["Cb", "Gb", "Db", "Ab", "Eb", "Bb", "F", "C", "G", "D",
                  "A", "E", "B", "F#", "C#"]
        minors = ["Abm", "Ebm", "Bbm", "Fm", "Cm", "Gm", "Dm", "Am", "Em",
                  "Bm", "F#m", "C#m", "G#m", "D#m", "A#m"]
        return (minors if self.minor else majors)[self.sharps + 7]


DEFAULT_TEMPO = 500000          # 120 BPM


@dataclass
class MidiFile:
    ticks_per_beat: int = 480
    notes: List[Note] = field(default_factory=list)
    tempos: List[Tempo] = field(default_factory=list)
    time_signatures: List[TimeSignature] = field(default_factory=list)
    key_signatures: List[KeySignature] = field(default_factory=list)

    # -- tempo map --------------------------------------------------------
    def _tempo_spans(self) -> List[Tuple[int, float, int]]:
        """[(start_tick, start_seconds, us_per_beat)] sorted by tick."""
        tempos = sorted(self.tempos, key=lambda t: t.tick)
        if not tempos or tempos[0].tick > 0:
            tempos = [Tempo(0, DEFAULT_TEMPO)] + tempos
        spans = []
        sec = 0.0
        for i, t in enumerate(tempos):
            if i > 0:
                prev_tick, prev_sec, prev_us = spans[-1]
                sec = prev_sec + (t.tick - prev_tick) * prev_us / (
                    1e6 * self.ticks_per_beat)
            spans.append((t.tick, sec, t.us_per_beat))
        return spans

    def tick_to_seconds(self, tick: int) -> float:
        spans = self._tempo_spans()
        ticks = [s[0] for s in spans]
        i = bisect.bisect_right(ticks, tick) - 1
        start_tick, start_sec, us = spans[i]
        return start_sec + (tick - start_tick) * us / (1e6 * self.ticks_per_beat)

    def seconds_to_tick(self, seconds: float) -> int:
        spans = self._tempo_spans()
        i = 0
        for j, (tick, sec, us) in enumerate(spans):
            if sec <= seconds:
                i = j
            else:
                break
        start_tick, start_sec, us = spans[i]
        return int(round(start_tick + (seconds - start_sec) * 1e6
                         * self.ticks_per_beat / us))

    @property
    def duration_seconds(self) -> float:
        if not self.notes:
            return 0.0
        return self.tick_to_seconds(max(n.end_tick for n in self.notes))

    def notes_with_times(self) -> List[Tuple[float, float, Note]]:
        """[(start_s, end_s, note)] — exact under tempo changes. Builds the
        tempo map once and bisects per note (tick_to_seconds would re-sort
        the tempo list 2N times on this synthesis hot path)."""
        spans = self._tempo_spans()
        ticks = [s[0] for s in spans]
        tpb = 1e6 * self.ticks_per_beat

        def to_sec(tick: int) -> float:
            i = bisect.bisect_right(ticks, tick) - 1
            start_tick, start_sec, us = spans[i]
            return start_sec + (tick - start_tick) * us / tpb

        return [(to_sec(n.start_tick), to_sec(n.end_tick), n)
                for n in self.notes]

    # -- tempo-aware cut (the reference's hard part) ----------------------
    def cut(self, duration_seconds: float) -> "MidiFile":
        """Truncate to ``duration_seconds`` of *wall-clock* time: drop notes
        starting at/after the boundary, clip sustained notes at it, keep all
        tempo/signature events before it (preprocess_data.py:84-116 goal)."""
        boundary_tick = self.seconds_to_tick(duration_seconds)
        notes = []
        for n in self.notes:
            if n.start_tick >= boundary_tick:
                continue
            if n.end_tick > boundary_tick:
                n = replace(n, duration_tick=boundary_tick - n.start_tick)
            if n.duration_tick > 0:
                notes.append(n)
        keep = lambda evs: [e for e in evs if e.tick < boundary_tick]
        return MidiFile(self.ticks_per_beat, notes, keep(self.tempos),
                        keep(self.time_signatures), keep(self.key_signatures))

    # -- SMF codec --------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(self.to_bytes())

    def to_bytes(self) -> bytes:
        events: List[Tuple[int, int, bytes]] = []   # (tick, order, payload)
        for t in self.tempos:
            events.append((t.tick, 0, b"\xff\x51\x03"
                           + t.us_per_beat.to_bytes(3, "big")))
        for ts in self.time_signatures:
            denom_pow = max(0, ts.denominator.bit_length() - 1)
            events.append((ts.tick, 0, bytes([0xFF, 0x58, 0x04, ts.numerator,
                                              denom_pow, 24, 8])))
        for ks in self.key_signatures:
            events.append((ks.tick, 0, bytes([0xFF, 0x59, 0x02,
                                              ks.sharps & 0xFF,
                                              1 if ks.minor else 0])))
        # note-offs sort before note-ons at the same tick, otherwise a
        # repeated pitch across adjacent notes swallows the second note
        for n in self.notes:
            events.append((n.start_tick, 2,
                           bytes([0x90 | n.channel, n.pitch, n.velocity])))
            events.append((n.end_tick, 1,
                           bytes([0x80 | n.channel, n.pitch, 0])))
        events.sort(key=lambda e: (e[0], e[1]))

        track = bytearray()
        last = 0
        for tick, _, payload in events:
            track += _varint(tick - last) + payload
            last = tick
        track += _varint(0) + b"\xff\x2f\x00"

        out = bytearray()
        out += b"MThd" + struct.pack(">IHHH", 6, 0, 1, self.ticks_per_beat)
        out += b"MTrk" + struct.pack(">I", len(track)) + bytes(track)
        return bytes(out)

    @classmethod
    def load(cls, path: str) -> "MidiFile":
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "MidiFile":
        if data[:4] != b"MThd":
            raise ValueError("not a Standard MIDI File")
        _, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        mf = cls(ticks_per_beat=division)
        pos = 14
        for _ in range(ntracks):
            if data[pos: pos + 4] != b"MTrk":
                # skip unknown chunk
                size = struct.unpack(">I", data[pos + 4: pos + 8])[0]
                pos += 8 + size
                continue
            size = struct.unpack(">I", data[pos + 4: pos + 8])[0]
            _parse_track(memoryview(data)[pos + 8: pos + 8 + size], mf)
            pos += 8 + size
        mf.notes.sort(key=lambda n: (n.start_tick, n.pitch))
        mf.tempos.sort(key=lambda t: t.tick)
        return mf


def _varint(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _read_varint(data, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _parse_track(data, mf: MidiFile) -> None:
    pos = 0
    tick = 0
    running = 0
    active: dict = {}           # (channel, pitch) -> (start_tick, velocity)
    while pos < len(data):
        delta, pos = _read_varint(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running = status
        else:
            status = running
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90:            # note on (vel 0 == off)
            pitch, vel = data[pos], data[pos + 1]
            pos += 2
            if vel > 0:
                # retrigger before release (sustain-pedal MIDI): close the
                # sounding note here instead of dropping it (pretty_midi/
                # mido semantics) — its note-off then matches nothing
                _close(active, mf, ch, pitch, tick)
                active[(ch, pitch)] = (tick, vel)
            else:
                _close(active, mf, ch, pitch, tick)
        elif kind == 0x80:
            pitch = data[pos]
            pos += 2
            _close(active, mf, ch, pitch, tick)
        elif kind in (0xA0, 0xB0, 0xE0):
            pos += 2
        elif kind in (0xC0, 0xD0):
            pos += 1
        elif status == 0xFF:        # meta
            meta = data[pos]
            pos += 1
            length, pos = _read_varint(data, pos)
            body = bytes(data[pos: pos + length])
            pos += length
            if meta == 0x51 and length == 3:
                mf.tempos.append(Tempo(tick, int.from_bytes(body, "big")))
            elif meta == 0x58 and length >= 2:
                mf.time_signatures.append(
                    TimeSignature(tick, body[0], 1 << body[1]))
            elif meta == 0x59 and length >= 2:
                sharps = body[0] - 256 if body[0] > 127 else body[0]
                mf.key_signatures.append(
                    KeySignature(tick, sharps, body[1] == 1))
            elif meta == 0x2F:
                break
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varint(data, pos)
            pos += length
        else:
            raise ValueError(f"unhandled MIDI status 0x{status:02x}")
    # close any dangling notes at end of track
    for (ch, pitch), (start, vel) in list(active.items()):
        mf.notes.append(Note(start, max(tick - start, 1), pitch, vel, ch))


def _close(active, mf: MidiFile, ch: int, pitch: int, tick: int) -> None:
    key = (ch, pitch)
    if key in active:
        start, vel = active.pop(key)
        mf.notes.append(Note(start, max(tick - start, 1), pitch, vel, ch))
