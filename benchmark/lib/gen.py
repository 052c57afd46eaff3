"""The one traffic generator: it reads a mix's parameters (``traffic/*.json``)
and draws every size from ``--seed``.

Sizes and budgets are stratified: a set of ``n`` draws is the ``n``
quantiles ``(k + 0.5) / n`` of the mix's distribution, put in an order the
seed chooses. Every seed then offers the same work in another order, so
two seeds differ by the order of the requests and not by the amount of
work.
The audio content (where in the bank a clip starts) is drawn freely.

Audio comes from one bank of speech-like sound (gliding harmonics under a
syllable envelope, with noise), made once from the seed: a clip is a slice
of it, so a run makes its inputs in milliseconds and the reference reads
the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

SAMPLE_RATE = 16000
BANK_SECONDS = 90.0


@dataclass
class Request:
    index: int
    offset: int           # first sample in the bank
    n_samples: int
    budget: int

    @property
    def audio_seconds(self) -> float:
        return self.n_samples / SAMPLE_RATE


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of draws for one purpose of one seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def speech_bank(seed: int, seconds: float = BANK_SECONDS) -> np.ndarray:
    """Float32 audio in [-1, 1]: harmonics of a gliding pitch, gated into
    syllables, plus a little noise."""
    rng = rng_for(seed, 1)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
    pitch = 120.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6.3))
    phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
    x = sum(np.sin(h * phase) / h for h in range(1, 8))
    syll = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.3))
    x = 0.3 * x * syll + 0.02 * rng.standard_normal(n)
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def uniform_ints(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n stratified integers in [lo, hi], in the seed's order."""
    v = lo + np.floor(quantiles(n) * (hi - lo + 1)).astype(np.int64)
    return rng.permutation(np.minimum(v, hi))


def uniform_reals(lo: float, hi: float, n: int, rng) -> np.ndarray:
    return rng.permutation(lo + quantiles(n) * (hi - lo))


def requests(mix: dict, seed: int, n: int, *, first: int = 0,
             block: int = 0) -> List[Request]:
    """``n`` requests of ``mix`` from ``seed``; ``block`` > 0 draws the
    sizes block by block (every block the same stratified set), for a
    stream of unknown length."""
    out: List[Request] = []
    size = block or n
    start = first
    while len(out) < n:
        b = start // size
        rng = rng_for(seed, 100 + b)
        lo_s, hi_s = mix["clip_seconds"]
        secs = uniform_reals(lo_s, hi_s, size, rng)
        lo_b, hi_b = mix["budget_tokens"]
        budgets = uniform_ints(lo_b, hi_b, size, rng)
        bank_n = int(BANK_SECONDS * SAMPLE_RATE)
        for k in range(start - b * size, size):
            ns = int(round(secs[k] * SAMPLE_RATE))
            off = int(rng_for(seed, 10_000 + b * size + k).integers(
                0, bank_n - ns + 1))
            out.append(Request(b * size + k, off, ns, int(budgets[k])))
            if len(out) == n:
                break
        start = (b + 1) * size
    return out


def label_rows(lengths: np.ndarray, prompt: List[int], eot: int,
               rng) -> List[List[int]]:
    """Label rows of the given total lengths: the start sequence, random
    text ids below end-of-text, and end-of-text."""
    rows = []
    for n in lengths:
        body = rng.integers(0, eot, size=max(int(n) - len(prompt) - 1, 0))
        rows.append(list(prompt) + [int(t) for t in body] + [eot])
    return rows


def train_batch(mix: dict, seed: int, step: int, batch: int, prompt,
                eot: int):
    """Step ``step``'s batch: bank offsets of its rows (all different) and
    its label rows (lengths stratified over the mix's range)."""
    rng = rng_for(seed, 1_000_000 + step)
    lo, hi = mix["label_tokens"]
    lengths = uniform_ints(lo, hi, batch, rng)
    n = int(mix["clip_seconds"][1] * SAMPLE_RATE)
    bank_n = int(BANK_SECONDS * SAMPLE_RATE)
    offsets = rng.choice(bank_n - n + 1, size=batch, replace=False)
    return offsets.astype(np.int64), label_rows(lengths, prompt, eot, rng)


def clip(bank: np.ndarray, r: Request) -> np.ndarray:
    return bank[r.offset: r.offset + r.n_samples]


