"""Synthetic UrbanSound8K stand-in (own copy of the synthetic-classes part
of ``audax/data/synth.py``: ``SYNTH_CLASSES``, ``_synth_clip``,
``make_synthetic_urbansound``).

Ten synthetic sound classes with distinct spectro-temporal signatures,
written in the exact UrbanSound8K layout so the whole fold protocol runs
without the real dataset. The numpy draws are the JAX package's, in the
same order, so both packages write identical WAVs for the same seed. The
metadata CSV is written with the stdlib ``csv`` module (no pandas), with
the same columns, quoting and line ends as ``DataFrame.to_csv``.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from audax_torch.core.logging import get_logger
from audax_torch.data.audio_io import write_wav

__all__ = ["SYNTH_CLASSES", "make_synthetic_urbansound"]

log = get_logger("audax_torch.datagen")

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
