"""Fixed-size batching: shuffled train batches, padded + masked eval batches
(own copy of ``audax/data/batching.py``).

Training drops the trailing partial batch; evaluation pads the final batch
with row 0 and carries a weight mask (``w``) so padded rows add no loss and
are stripped from the predictions. The shuffle is
``np.random.default_rng((seed, epoch))``, the JAX package's, so both
packages see the same batches in the same order.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["train_batches", "eval_batches", "num_train_batches"]


def num_train_batches(n: int, batch_size: int) -> int:
    return n // batch_size


def train_batches(arrays: Dict[str, np.ndarray], batch_size: int,
                  seed: int, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled fixed-size batches; partial tail dropped. Deterministic in
    (seed, epoch)."""
    n = len(next(iter(arrays.values())))
    order = np.random.default_rng((seed, epoch)).permutation(n)
    for start in range(0, n - batch_size + 1, batch_size):
        idx = order[start:start + batch_size]
        yield {k: v[idx] for k, v in arrays.items()}


def eval_batches(arrays: Dict[str, np.ndarray], batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """In-order fixed-size batches; final batch padded with row 0 and masked
    via the 'w' key (1.0 = real, 0.0 = padding)."""
    n = len(next(iter(arrays.values())))
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        batch = {k: v[start:end] for k, v in arrays.items()}
        w = np.ones(end - start, dtype=np.float32)
        if end - start < batch_size:
            pad = batch_size - (end - start)
            batch = {k: np.concatenate([v] + [v[:1]] * pad, axis=0)
                     for k, v in batch.items()}
            w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
        batch["w"] = w
        yield batch
