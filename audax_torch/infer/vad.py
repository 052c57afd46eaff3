"""Energy-based voice-activity test shared by the serving surfaces (own copy
of ``audax/infer/vad.py``).

Beyond the reference (openai decodes every window and gates afterwards via
<|nospeech|> mass, reproduced in infer/decode.py): windows that carry no
energy at all are answered as silence WITHOUT a decode, so long quiet
stretches cost zero device work. Host-side numpy on purpose — the test runs
before any device transfer and must stay free for skipped windows.
"""

from __future__ import annotations

import numpy as np

__all__ = ["peak_frame_rms_db", "is_silent"]


def peak_frame_rms_db(chunk: np.ndarray, sample_rate: int,
                      frame_seconds: float = 0.1) -> float:
    """Peak RMS over ``frame_seconds`` frames, in dBFS (0 dB = full-scale
    unit amplitude). Empty input floors at -200 dB."""
    frame = max(1, int(sample_rate * frame_seconds))
    m = len(chunk) - len(chunk) % frame
    if m == 0:
        return -200.0
    rms = np.sqrt((np.asarray(chunk[:m], np.float64) ** 2)
                  .reshape(-1, frame).mean(1))
    return 20.0 * np.log10(max(float(rms.max()), 1e-10))


def is_silent(chunk: np.ndarray, sample_rate: int,
              threshold_db: float) -> bool:
    """True when every frame's RMS sits below ``threshold_db`` dBFS
    (zero-padding never raises energy, so padded windows test the same)."""
    return peak_frame_rms_db(chunk, sample_rate) < threshold_db
