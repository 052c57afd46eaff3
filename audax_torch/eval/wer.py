"""Word error rate, the fine-tune selection metric (own copy of
``audax/eval/wer.py``): Levenshtein distance over words, pooled over the
corpus as jiwer does."""

from __future__ import annotations

from typing import Sequence

__all__ = ["word_error_rate", "edit_distance"]


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with substitution/insertion/deletion cost 1."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1,        # deletion
                         cur[j - 1] + 1,     # insertion
                         prev[j - 1] + cost) # substitution
        prev = cur
    return prev[n]


def word_error_rate(references: Sequence[str], hypotheses: Sequence[str]
                    ) -> float:
    """Corpus-level WER: total edits / total reference words (jiwer
    convention). Returns 0.0 for an empty reference corpus with empty
    hypotheses; insertions against empty references count per word."""
    if len(references) != len(hypotheses):
        # a silently zip-truncated corpus would underreport WER
        raise ValueError(f"{len(references)} references vs "
                         f"{len(hypotheses)} hypotheses")
    total_edits = 0
    total_words = 0
    extra = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        total_edits += edit_distance(r, h)
        total_words += len(r)
        if not r:
            extra += len(h)
    if total_words == 0:
        return 0.0 if extra == 0 else float("inf")
    return total_edits / total_words
