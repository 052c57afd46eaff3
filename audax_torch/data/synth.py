"""Synthetic datasets: MIDI melodies rendered to audio, and the
UrbanSound8K stand-in (port of ``audax/data/synth.py``).

  * ``make_midi_dataset`` -- N random short piano melodies rendered to
    16 kHz wavs + ``mididataset.csv`` with ``<|MIDI|> <note names>
    <|/MIDI|>`` labels (reference: AB/synthDataset.py:43-91);
    ``piano_full_range`` -- the 88-key sweep (synthDataset.py:111-137).
  * ``make_synthetic_urbansound`` -- ten synthetic sound classes written in
    the exact UrbanSound8K layout, so the whole fold protocol runs without
    the real dataset.

Rendering: without a soundfont the JAX package renders through its native
additive synth (``synth_render_simple`` in ``audax/native/src/
sf2synth.cpp``: four decaying harmonics, a 5 ms attack, a 40/s release over
a 50 ms tail). ``render_simple`` here is that synth in numpy, vectorised
over each note's samples (float64 phase and envelope, each note's samples
rounded to float32 and added in note order, as the C++ loop adds them), so
it needs no host compiler. A soundfont renders through the port's C++
SF2 synth (``native/bindings.py:Sf2Synth``, built by ``g++`` at first
use; a failed build or an unreadable soundfont raises -- no fallback
voice).
``_numpy_fallback_synth`` is the JAX package's own last-resort voice (one
sine), used there only when its native library fails to load.

The numpy draws are the JAX package's, in the same order, so both packages
write identical MIDI files and labels, and WAVs within the synths' float
rounding, for the same seed. CSVs are written with the stdlib ``csv``
module (no pandas).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from typing import List, Optional, Tuple

from audax_torch.core.config import DataGenConfig
from audax_torch.core.logging import get_logger
from audax_torch.data.audio_io import write_wav
from audax_torch.symbolic.midi import (MidiFile, Note, Tempo,
                                       note_number_to_name)

__all__ = ["make_midi_dataset", "piano_full_range", "render_midi",
           "render_simple", "MIDI_LABEL_START", "MIDI_LABEL_END",
           "SYNTH_CLASSES", "make_synthetic_urbansound"]

log = get_logger("audax_torch.datagen")

MIDI_LABEL_START = "<|MIDI|>"
MIDI_LABEL_END = "<|/MIDI|>"

# duration / gap grids in the reference's style (longer than
# AB/synthDataset.py:50-51's so the note envelopes are fully audible)
_DURATIONS = (0.25, 0.5, 0.75, 1.0)
_GAPS = (0.0, 0.125, 0.25)
#: the additive voice's harmonic gains (sf2synth.cpp:synth_render_simple)
_HARMONICS = (1.0, 0.5, 0.25, 0.125)


def _normalize(out: np.ndarray) -> np.ndarray:
    peak = float(np.abs(out).max()) if out.size else 0.0
    if peak > 0.99:
        out *= 0.99 / peak
    return out


def render_simple(mf: MidiFile, sample_rate: int = 16000, *,
                  tail_s: float = 0.3) -> np.ndarray:
    """The soundfont-free additive synth: each note four harmonics (gains
    1, 1/2, 1/4, 1/8) under ``min(1, t / 5 ms) * exp(-2 t)``, held for the
    note's duration and released at exp(-40/s) over a 50 ms tail; peak
    normalised to 0.99. The buffer holds the score plus ``tail_s``."""
    sr = float(sample_rate)
    frames_out = int((mf.duration_seconds + tail_s) * sample_rate) + 1
    out = np.zeros(max(frames_out, 1), dtype=np.float32)
    tail = int(0.05 * sr)
    for start, end, n in mf.notes_with_times():
        f0 = 440.0 * 2.0 ** ((n.pitch - 69) / 12.0)
        amp = 0.2 * (n.velocity / 127.0)
        first = int(start * sr)
        frames = int(max(end - start, 1e-3) * sr)
        count = min(frames + tail, out.size - first)
        if first < 0 or count <= 0:
            continue
        t = np.arange(count, dtype=np.int64)
        sec = t / sr
        env = np.minimum(1.0, t / (0.005 * sr)) * np.exp(-2.0 * sec)
        rel = t >= frames
        env[rel] *= np.exp(-40.0 * (t[rel] - frames) / sr)
        v = np.zeros(count)
        for h, g in enumerate(_HARMONICS):
            v += g * np.sin(2.0 * np.pi * f0 * (h + 1) * sec)
        out[first: first + count] += (amp * env * v).astype(np.float32)
    return _normalize(out)


def _numpy_fallback_synth(mf: MidiFile, sample_rate: int) -> np.ndarray:
    """The JAX package's last-resort voice: one decaying sine a note."""
    out = np.zeros(int((mf.duration_seconds + 0.3) * sample_rate) + 1,
                   np.float32)
    for start, end, n in mf.notes_with_times():
        f0 = 440.0 * 2 ** ((n.pitch - 69) / 12)
        t = np.arange(int((end - start + 0.05) * sample_rate)) / sample_rate
        env = np.minimum(1.0, t / 0.005) * np.exp(-2.0 * t)
        sig = 0.2 * (n.velocity / 127.0) * env * np.sin(2 * np.pi * f0 * t)
        i0 = int(start * sample_rate)
        out[i0: i0 + len(sig)] += sig.astype(np.float32)
    peak = np.abs(out).max()
    if peak > 0.99:
        out *= 0.99 / peak
    return out


def render_midi(mf: MidiFile, sample_rate: int = 16000,
                soundfont: Optional[str] = None,
                program: int = 0) -> np.ndarray:
    """Render ``mf`` through ``soundfont``'s preset ``program`` (the SF2
    synth), or with the additive synth when no soundfont is given."""
    if soundfont:
        from audax_torch.native.bindings import Sf2Synth
        return Sf2Synth(soundfont).render(mf, sample_rate, program=program)
    return render_simple(mf, sample_rate)


#: chord shapes for polyphonic datagen: intervals stacked above the root
#: (major / minor triads, bare fifth, octave double), the vocabulary
#: symbolic/chords.py emits
_CHORD_SHAPES = ((4, 7), (3, 7), (7,), (12,))


def _random_melody(rng: np.random.Generator, n_notes: int, velocity: int,
                   *, low: int = 36, high: int = 96,
                   ticks_per_beat: int = 480,
                   velocity_jitter: int = 0,
                   jitter_rng: Optional[np.random.Generator] = None,
                   max_poly: int = 1,
                   ) -> Tuple[MidiFile, List[str]]:
    """A random melody at 120 BPM and its note names. ``max_poly`` > 1
    turns events into chords: each event keeps its root draw, then with
    probability 1/2 stacks a random ``_CHORD_SHAPES`` subset (up to
    ``max_poly`` pitches). At ``max_poly=1`` no extra draws happen.
    Velocity jitter draws from ``jitter_rng`` (its own stream), so turning
    augmentation on or off never changes which melodies a seed draws."""
    mf = MidiFile(ticks_per_beat=ticks_per_beat)
    mf.tempos.append(Tempo(0, 500000))              # 120 BPM: 1 beat = 0.5 s
    tick = 0
    names = []

    def to_ticks(sec: float) -> int:
        return int(round(sec / 0.5 * ticks_per_beat))

    for _ in range(n_notes):
        pitch = int(rng.integers(low, high + 1))
        dur = float(rng.choice(_DURATIONS))
        gap = float(rng.choice(_GAPS))
        vel = velocity
        if velocity_jitter > 0:
            vel = int(np.clip(velocity + (jitter_rng or rng).integers(
                -velocity_jitter, velocity_jitter + 1), 1, 127))
        pitches = [pitch]
        if max_poly > 1 and rng.random() < 0.5:
            shape = _CHORD_SHAPES[int(rng.integers(len(_CHORD_SHAPES)))]
            for iv in shape[: max_poly - 1]:
                q = pitch + iv
                if q <= high and q not in pitches:
                    pitches.append(q)
        for q in pitches:
            mf.notes.append(Note(tick, to_ticks(dur), q, vel))
        names.append("+".join(note_number_to_name(q) for q in pitches))
        tick += to_ticks(dur + gap)
    return mf, names


def _apply_audio_jitter(audio: np.ndarray, rng: np.random.Generator,
                        gain_jitter_db: float,
                        noise_snr_db: float) -> np.ndarray:
    """Per-item gain jitter + white noise at a fixed SNR (label-preserving
    augmentations), then a headroom clamp to 0.99."""
    out = audio
    if gain_jitter_db > 0.0:
        db = rng.uniform(-gain_jitter_db, gain_jitter_db)
        out = out * np.float32(10.0 ** (db / 20.0))
    if noise_snr_db > 0.0:
        rms = float(np.sqrt(np.mean(out ** 2))) or 1e-6
        noise_rms = rms / (10.0 ** (noise_snr_db / 20.0))
        out = out + noise_rms * rng.standard_normal(out.shape).astype(
            np.float32)
    peak = float(np.max(np.abs(out))) if out.size else 0.0
    if peak > 0.99:
        out = out * (0.99 / peak)
    return out.astype(np.float32)


def make_midi_dataset(cfg: DataGenConfig, *,
                      write_midi: bool = True) -> str:
    """Generate ``cfg.num_items`` melodies; write wav (+ optional .mid)
    files and ``mididataset.csv`` (columns: filename, labels). Returns the
    CSV path. ``cfg.soundfont`` renders every item through that soundfont
    (opened once)."""
    synth = None
    if cfg.soundfont:
        from audax_torch.native.bindings import Sf2Synth
        synth = Sf2Synth(cfg.soundfont)
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    wav_dir = os.path.join(cfg.out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    csv_path = os.path.join(cfg.out_dir, "mididataset.csv")
    rows = []
    jit_rng = np.random.default_rng(cfg.seed + 104729)   # jitter-only stream
    for i in range(cfg.num_items):
        mf, names = _random_melody(rng, cfg.notes_per_item, cfg.velocity,
                                   velocity_jitter=cfg.velocity_jitter,
                                   jitter_rng=jit_rng)
        wav_path = os.path.join(wav_dir, f"midi_{i:05d}.wav")
        audio = (synth.render(mf, cfg.sample_rate) if synth
                 else render_midi(mf, cfg.sample_rate))
        if cfg.gain_jitter_db > 0.0 or cfg.noise_snr_db > 0.0:
            audio = _apply_audio_jitter(audio, jit_rng, cfg.gain_jitter_db,
                                        cfg.noise_snr_db)
        write_wav(wav_path, audio, cfg.sample_rate)
        if write_midi:
            mf.save(os.path.splitext(wav_path)[0] + ".mid")
        label = f"{MIDI_LABEL_START} {' '.join(names)} {MIDI_LABEL_END}"
        rows.append({"filename": wav_path, "labels": label})
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["filename", "labels"])
        w.writeheader()
        w.writerows(rows)
    log.success("wrote %s (%d items)", csv_path, len(rows))
    return csv_path


def piano_full_range(path: str, *, note_seconds: float = 0.5,
                     ticks_per_beat: int = 480) -> MidiFile:
    """88-key ascending sweep A0..C8 (reference: synthDataset.py:111-137)."""
    mf = MidiFile(ticks_per_beat=ticks_per_beat)
    mf.tempos.append(Tempo(0, 500000))
    ticks = int(round(note_seconds / 0.5 * ticks_per_beat))
    for i, pitch in enumerate(range(21, 109)):      # A0..C8
        mf.notes.append(Note(i * ticks, ticks, pitch, 100))
    if path:
        mf.save(path)
    return mf

SYNTH_CLASSES = ("low_tone", "high_tone", "chirp_up", "chirp_down",
                 "noise_bursts", "pink_noise", "am_tone", "square_stack",
                 "click_train", "siren")


def _synth_clip(class_id: int, rng: np.random.Generator,
                sample_rate: int = 16000, seconds: float = 4.0) -> np.ndarray:
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    jit = float(rng.uniform(0.85, 1.15))
    amp = float(rng.uniform(0.25, 0.6))
    x = np.zeros(n)
    if class_id == 0:      # low tone + harmonics
        f0 = 180.0 * jit
        for h, g in ((1, 1.0), (2, 0.4), (3, 0.2)):
            x += g * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28))
    elif class_id == 1:    # high tone
        f0 = 3000.0 * jit
        x = np.sin(2 * np.pi * f0 * t)
    elif class_id == 2:    # up-chirp
        f = 200.0 * jit + (3800.0 / seconds) * t
        x = np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
    elif class_id == 3:    # down-chirp
        f = 4000.0 * jit - (3800.0 / seconds) * t
        x = np.sin(2 * np.pi * np.cumsum(np.maximum(f, 50)) / sample_rate)
    elif class_id == 4:    # gated white-noise bursts (5 Hz)
        gate = (np.sin(2 * np.pi * 5.0 * jit * t) > 0).astype(np.float64)
        x = rng.standard_normal(n) * gate
    elif class_id == 5:    # pink-ish noise (one-pole lowpass)
        w = rng.standard_normal(n)
        a = 0.97
        for i in range(1, n):
            w[i] = a * w[i - 1] + (1 - a) * w[i]
        x = w / (np.abs(w).max() + 1e-9)
    elif class_id == 6:    # AM tone (8 Hz tremolo)
        x = (0.5 + 0.5 * np.sin(2 * np.pi * 8.0 * jit * t)) \
            * np.sin(2 * np.pi * 1000.0 * jit * t)
    elif class_id == 7:    # odd-harmonic stack (square-ish)
        f0 = 440.0 * jit
        for h in (1, 3, 5, 7):
            x += np.sin(2 * np.pi * f0 * h * t) / h
    elif class_id == 8:    # click train (10 Hz impulses through a resonance)
        period = int(sample_rate / (10.0 * jit))
        x = np.zeros(n)
        x[::period] = 1.0
        ring = np.exp(-np.arange(200) / 30.0) \
            * np.sin(2 * np.pi * 1500.0 * np.arange(200) / sample_rate)
        x = np.convolve(x, ring)[:n]
    else:                  # siren: 1 Hz sinusoidal FM 500-1500 Hz
        f = 1000.0 + 500.0 * np.sin(2 * np.pi * 1.0 * jit * t)
        x = np.sin(2 * np.pi * np.cumsum(f) / sample_rate)
    x = amp * x / (np.abs(x).max() + 1e-9)
    x += 0.01 * rng.standard_normal(n)                  # noise floor
    return x.astype(np.float32)


def make_synthetic_urbansound(root: str, *, per_fold: int = 10,
                              sample_rate: int = 16000,
                              seed: int = 0) -> str:
    """Write a synthetic dataset in the exact UrbanSound8K layout
    (audio/fold{1..10}/<name>.wav as 16-bit PCM + metadata/UrbanSound8K.csv
    with slice_file_name/fold/classID/class columns, the contract
    ``data/urbansound.py`` reads). Returns ``root``."""
    rng = np.random.default_rng(seed)
    rows = []
    for fold in range(1, 11):
        d = os.path.join(root, "audio", f"fold{fold}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_fold):
            cid = int(rng.integers(0, len(SYNTH_CLASSES))) \
                if per_fold < len(SYNTH_CLASSES) else i % len(SYNTH_CLASSES)
            name = f"f{fold}_{i:03d}_{cid}.wav"
            write_wav(os.path.join(d, name),
                      _synth_clip(cid, rng, sample_rate), sample_rate)
            rows.append((name, fold, cid, SYNTH_CLASSES[cid]))
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)
    with open(os.path.join(root, "metadata", "UrbanSound8K.csv"), "w",
              newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(("slice_file_name", "fold", "classID", "class"))
        writer.writerows(rows)
    log.success("synthetic urbansound: %d clips -> %s", len(rows), root)
    return root
