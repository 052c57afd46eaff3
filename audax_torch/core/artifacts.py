"""Config-stamped artifact naming (the port's own copy of
``audax/core/artifacts.py``).

The reference identifies artifacts by embedding hyperparameters in filenames,
e.g. ``urbansound8k_cnn_final_mels128_hop128_batch16_epochs20_lr0.0003_dropout0.3.pt``
(reference: .charles/spectrogram.py:94-118). We reproduce that contract so runs
remain self-identifying, plus glob-based legacy fallback at load
(spectrogram.py:848-858).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

__all__ = ["stamped_name", "find_latest"]


def stamped_name(
    prefix: str,
    *,
    n_mels: int,
    hop_length: int,
    batch_size: Optional[int] = None,
    epochs: Optional[int] = None,
    learning_rate: Optional[float] = None,
    dropout: Optional[float] = None,
    ext: str = "",
) -> str:
    """Build a hyperparameter-stamped artifact name, reference-compatible."""
    parts = [prefix, f"mels{n_mels}", f"hop{hop_length}"]
    if batch_size is not None:
        parts.append(f"batch{batch_size}")
    if epochs is not None:
        parts.append(f"epochs{epochs}")
    if learning_rate is not None:
        parts.append(f"lr{learning_rate}")
    if dropout is not None:
        parts.append(f"dropout{dropout}")
    return "_".join(parts) + ext


def find_latest(directory: str, pattern: str) -> Optional[str]:
    """Most-recently-modified artifact matching ``pattern`` (legacy fallback)."""
    matches = glob.glob(os.path.join(directory, pattern))
    if not matches:
        return None
    return max(matches, key=os.path.getmtime)
