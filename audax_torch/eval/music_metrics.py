"""Note-level transcription metrics (mir_eval-style, simplified).

The reference could only eyeball its music-transcription outputs (the
documented mode collapse in AB/midiDatasetResults.csv). With the ABC parser
(symbolic/abc_parse.py) closing the round-trip, generated ABC becomes
comparable to ground-truth MIDI: onset-tolerance note matching gives
precision/recall/F1, and validity rate quantifies how often the model emits
parseable notation at all.

Port of ``audax/eval/music_metrics.py``: an own copy
(pure Python, the same behaviour), so the PyTorch package imports
nothing of the JAX one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from audax_torch.symbolic.midi import MidiFile

__all__ = ["note_prf", "abc_note_prf", "abc_validity_rate"]


def _note_events(mf: MidiFile) -> List[Tuple[float, int]]:
    return sorted((start, n.pitch) for start, _, n in mf.notes_with_times())


def note_prf(reference: MidiFile, hypothesis: MidiFile,
             *, onset_tolerance: float = 0.05) -> Dict[str, float]:
    """Greedy one-to-one matching on (onset within tolerance, exact pitch).

    Returns precision/recall/f1 plus match counts.
    """
    ref = _note_events(reference)
    hyp = _note_events(hypothesis)
    used = [False] * len(hyp)
    matches = 0
    for r_on, r_pitch in ref:
        for j, (h_on, h_pitch) in enumerate(hyp):
            if used[j] or h_pitch != r_pitch:
                continue
            if abs(h_on - r_on) <= onset_tolerance:
                used[j] = True
                matches += 1
                break
    precision = matches / len(hyp) if hyp else 0.0
    recall = matches / len(ref) if ref else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "matches": matches, "n_ref": len(ref), "n_hyp": len(hyp)}


def abc_note_prf(reference: MidiFile, abc_text: str,
                 *, onset_tolerance: float = 0.05) -> Dict[str, float]:
    """Score generated ABC against ground-truth MIDI; unparseable ABC scores
    zero (with valid=0)."""
    from audax_torch.symbolic.abc_parse import AbcParseError, abc_to_midi
    try:
        hyp = abc_to_midi(abc_text)
    except (AbcParseError, Exception):
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0, "matches": 0,
                "n_ref": len(reference.notes), "n_hyp": 0, "valid": 0.0}
    out = note_prf(reference, hyp, onset_tolerance=onset_tolerance)
    out["valid"] = 1.0
    return out


def abc_validity_rate(abc_texts: Sequence[str]) -> float:
    """Fraction of generated ABC strings that parse to >=1 note."""
    from audax_torch.symbolic.abc_parse import abc_to_midi
    ok = 0
    for text in abc_texts:
        try:
            abc_to_midi(text)
            ok += 1
        except Exception:
            pass
    return ok / len(abc_texts) if abc_texts else 0.0
