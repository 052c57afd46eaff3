"""ctypes bindings of the port's host C++ (port of
``audax/native/bindings.py``).

  * ``Sf2Synth`` -- the soundfont renderer (the reference's fluidsynth);
  * ``decode_audio_file`` / ``encode_audio_file`` -- compressed audio
    (m4a/AAC, mp3, ogg, flac, ...) through the libav-linked module, in
    process (the reference ran an ffmpeg subprocess per file,
    AB/memoToWav.py:11-26).

Audio in and out is float32 numpy. Each library is built at first use
(``native/build.py``); a failed build raises. The JAX package's quiet
``available()`` / ``decode_available()`` are not ported, nor its native
``render_simple``: the port's additive synth is numpy
(``data/synth.py:render_simple``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from audax_torch.core.logging import get_logger
from audax_torch.native.build import build
from audax_torch.symbolic.midi import MidiFile

__all__ = ["Sf2Synth", "decode_audio_file", "encode_audio_file",
           "load_library", "load_decode_library"]

log = get_logger("audax_torch.native")


class _NoteEvent(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_double),
        ("duration", ctypes.c_double),
        ("pitch", ctypes.c_int32),
        ("velocity", ctypes.c_int32),
        ("program", ctypes.c_int32),
    ]


_LOCK = threading.Lock()
_LOADED = {}


def _load(name: str, signatures) -> ctypes.CDLL:
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
        return lib


def load_library() -> ctypes.CDLL:
    """The SF2 synth library, built first if needed."""
    c_int_p = ctypes.POINTER(ctypes.c_int)
    render = ([ctypes.c_void_p, ctypes.POINTER(_NoteEvent), ctypes.c_int,
               ctypes.c_double, ctypes.POINTER(ctypes.c_float),
               ctypes.c_int64], ctypes.c_int)
    return _load("sf2synth", {
        "sf2_open": ([ctypes.c_char_p], ctypes.c_void_p),
        "sf2_close": ([ctypes.c_void_p], None),
        "sf2_preset_count": ([ctypes.c_void_p], ctypes.c_int),
        "sf2_preset_info": ([ctypes.c_void_p, ctypes.c_int, c_int_p, c_int_p,
                             c_int_p], ctypes.c_int),
        "sf2_render": render})


def load_decode_library() -> ctypes.CDLL:
    """The compressed-audio library, built first if needed (raises where
    the system libav headers or libraries are missing)."""
    c_float_p = ctypes.POINTER(ctypes.c_float)
    return _load("audio_decode", {
        "audax_decode_audio": ([ctypes.c_char_p, ctypes.POINTER(c_float_p),
                                ctypes.POINTER(ctypes.c_long),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
        "audax_encode_audio": ([ctypes.c_char_p, c_float_p, ctypes.c_long,
                                ctypes.c_int, ctypes.c_int], ctypes.c_int),
        "audax_audio_free": ([c_float_p], None)})


def decode_audio_file(path: str):
    """Decode any file libav reads -> (float32 [n, channels], rate)."""
    lib = load_decode_library()
    buf = ctypes.POINTER(ctypes.c_float)()
    n, ch, sr = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
    rc = lib.audax_decode_audio(path.encode(), ctypes.byref(buf),
                                ctypes.byref(n), ctypes.byref(ch),
                                ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"decode failed (rc={rc}): {path}")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value, ch.value)).copy()
    finally:
        lib.audax_audio_free(buf)
    return out, sr.value


def encode_audio_file(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Encode float32 audio ([n] or [n, channels]) to ``path``, the
    container and codec chosen by its extension (AAC for .m4a)."""
    lib = load_decode_library()
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[:, None]
    a = np.ascontiguousarray(a)
    rc = lib.audax_encode_audio(
        path.encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a.shape[0], a.shape[1], int(sample_rate))
    if rc != 0:
        raise ValueError(f"encode failed (rc={rc}): {path}")


def _events_from_midi(mf: MidiFile, program: int) -> "ctypes.Array":
    notes = mf.notes_with_times()
    arr = (_NoteEvent * len(notes))()
    for i, (start, end, n) in enumerate(notes):
        arr[i] = _NoteEvent(start, max(end - start, 1e-3), n.pitch,
                            n.velocity, program)
    return arr


class Sf2Synth:
    """A soundfont opened by the C++ synth; ``render`` plays a MIDI file
    through its zones."""

    def __init__(self, sf2_path: str):
        self._lib = load_library()
        self._handle = self._lib.sf2_open(sf2_path.encode())
        if not self._handle:
            raise ValueError(f"failed to parse soundfont: {sf2_path}")
        self.path = sf2_path

    @property
    def preset_count(self) -> int:
        return self._lib.sf2_preset_count(self._handle)

    def presets(self):
        out = []
        for i in range(self.preset_count):
            bank, program, zones = ctypes.c_int(), ctypes.c_int(), \
                ctypes.c_int()
            self._lib.sf2_preset_info(self._handle, i, ctypes.byref(bank),
                                      ctypes.byref(program),
                                      ctypes.byref(zones))
            out.append({"bank": bank.value, "program": program.value,
                        "zones": zones.value})
        return out

    def render(self, mf: MidiFile, sample_rate: int = 16000, *,
               program: int = 0, tail_s: float = 0.3) -> np.ndarray:
        """``mf`` -> float32 waveform at ``sample_rate`` (16 kHz, the
        reference's contract, AB/synthDataset.py:36), its peak held at
        0.99 at most."""
        events = _events_from_midi(mf, program)
        frames = int((mf.duration_seconds + tail_s) * sample_rate) + 1
        out = np.zeros(max(frames, 1), dtype=np.float32)
        n = self._lib.sf2_render(
            self._handle, events, len(events), float(sample_rate),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if n < 0:
            raise RuntimeError(f"sf2_render failed on {self.path}")
        if n < len(events):
            log.warning("rendered %d/%d notes (missing zones)", n,
                        len(events))
        peak = float(np.abs(out).max()) if out.size else 0.0
        if peak > 0.99:
            out *= 0.99 / peak
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.sf2_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
