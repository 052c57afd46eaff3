"""Host input pipelines: shuffled, epoched, batched numpy batches (port of
``audax/data/grain_pipeline.py``, which builds them on ``grain``).

Two sources, with the JAX functions' arguments and batch dicts:

  * ``urbansound_dataset`` -- the precomputed-feature Parquet (the
    classifier loop): {"x": [B, T, M], "y": [B]};
  * ``waveform_dataset`` -- the music Parquet's raw waveforms,
    pad-or-trimmed to ``n_samples`` (the two-tower and fine-tune loops,
    which featurize on the device): {"waveform": [B, n_samples]} and,
    with a tokenizer, "input_ids"/"attention_mask" [B, max_tokens], the
    end token kept on truncation.

Each returns a re-iterable dataset: every ``iter()`` replays the same
batches. The rows stream through ``epochs`` passes (``None``: forever)
and are batched across the passes' seams; ``drop_remainder`` drops the
final short batch. Both read the Parquet with ``pyarrow`` alone.

``shuffle`` permutes the rows of each pass with ``np.random.default_rng``
seeded by (``seed``, pass): the same seed gives the same order, and each
pass holds every row once. grain's permutation cannot be reproduced
without grain, so the order differs from the JAX package's; with
``shuffle=False`` the batches are the JAX package's exactly.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["urbansound_dataset", "waveform_dataset", "BatchDataset"]


class BatchDataset:
    """Batches of ``prepare(row)`` dicts over ``n`` rows: ``passes``
    passes (None: forever), each in file order or a seeded permutation,
    stacked ``batch_size`` at a time."""

    def __init__(self, n: int, prepare: Callable[[int], Dict], *,
                 batch_size: int, seed: int, shuffle: bool,
                 epochs: Optional[int], drop_remainder: bool):
        if batch_size < 1:
            raise ValueError(f"batch_size={batch_size}")
        self.n = n
        self.prepare = prepare
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.epochs = epochs
        self.drop_remainder = drop_remainder

    def _order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        return np.random.default_rng([self.seed, epoch]).permutation(self.n)

    def _rows(self) -> Iterator[int]:
        passes = (itertools.count() if self.epochs is None
                  else range(self.epochs))
        for epoch in passes:
            if self.n == 0:
                return
            yield from (int(i) for i in self._order(epoch))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        group: List[Dict] = []
        for i in self._rows():
            group.append(self.prepare(i))
            if len(group) == self.batch_size:
                yield _stack(group)
                group = []
        if group and not self.drop_remainder:
            yield _stack(group)


def _stack(rows: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def urbansound_dataset(
    parquet_path: str,
    folds: Sequence[int],
    *,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    epochs: Optional[int] = 1,
    drop_remainder: bool = True,
) -> BatchDataset:
    """Fold-filtered UrbanSound features -> batched {"x": [B, T, M],
    "y": [B]}. The rows are read once (the feature Parquet is small)."""
    from audax_torch.data.urbansound import load_split

    split = load_split(parquet_path, folds)
    x, y = split["x"], split["y"]
    return BatchDataset(len(y), lambda i: {"x": x[i], "y": y[i]},
                        batch_size=batch_size, seed=seed, shuffle=shuffle,
                        epochs=epochs, drop_remainder=drop_remainder)


def waveform_dataset(
    parquet_path: str,
    *,
    batch_size: int,
    n_samples: int,
    seed: int = 0,
    shuffle: bool = True,
    epochs: Optional[int] = 1,
    drop_remainder: bool = True,
    tokenizer=None,
    max_tokens: int = 512,
) -> BatchDataset:
    """The music Parquet's successful rows -> batched {"waveform": [B,
    n_samples]}, and with a tokenizer "input_ids"/"attention_mask" [B,
    max_tokens]: <abc_start> + the ABC's ids + <abc_end>, padded with
    <abc_pad>, and on truncation the end token kept as the last id."""
    import pyarrow.parquet as pq

    from audax_torch.data.music_dataset import ABC_SPECIALS

    table = pq.read_table(parquet_path)
    table = table.filter(table.column("processing_success"))
    wave = table.column("waveform").combine_chunks()
    offsets = wave.offsets.to_numpy()
    samples = wave.values.to_numpy(zero_copy_only=False)
    abcs = table.column("abc_string").to_pylist()

    start_id = end_id = pad_id = 0
    if tokenizer is not None:
        start_id, end_id, pad_id = (tokenizer.vocab.get(s, 0)
                                    for s in ABC_SPECIALS)

    def prepare(i: int) -> Dict[str, np.ndarray]:
        w = samples[offsets[i]: offsets[i + 1]][:n_samples]
        wav = np.zeros(n_samples, np.float32)
        wav[: len(w)] = w
        out = {"waveform": wav}
        if tokenizer is not None:
            ids = [start_id] + tokenizer.encode(
                abcs[i], with_specials=False) + [end_id]
            if len(ids) > max_tokens:
                ids = ids[: max_tokens - 1] + [end_id]
            padded = np.full(max_tokens, pad_id, np.int32)
            padded[: len(ids)] = ids
            mask = np.zeros(max_tokens, np.int32)
            mask[: len(ids)] = 1
            out["input_ids"] = padded
            out["attention_mask"] = mask
        return out

    return BatchDataset(len(abcs), prepare, batch_size=batch_size, seed=seed,
                        shuffle=shuffle, epochs=epochs,
                        drop_remainder=drop_remainder)
