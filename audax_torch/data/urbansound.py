"""UrbanSound8K dataset: device featurization, Parquet preprocessing and
loading (port of ``audax/data/urbansound.py``).

The Parquet output contract is the JAX package's, so datasets interoperate:

    columns: slice_file_name (str), fold (int32), class_id (int32),
             class_name (str), log_mel (list<float32> flattened),
             mel_shape (list<int32> = [n_mels, T]), processing_success (bool)

``featurize_clips`` reads the metadata CSV (stdlib ``csv``), decodes, pads
or trims each clip to the 4 s contract on the host and featurizes device
batches through ``LogMelFrontend``. When every clip of a batch is mono
16-bit PCM at the target rate, the batch goes to the device as int16 (half
the bytes) and is dequantized there by ``/ 32768``, which is exact, so the
features equal the float32 path's. A clip that fails to decode is yielded
as a row of its own, with no features.

``preprocess_to_parquet`` writes those batches to one Parquet file from one
writer thread (the fetch and write of batch k-1 overlap the reading and
featurizing of batch k; one job in flight bounds memory). ``load_split``
reads a fold subset back. Both need ``pyarrow``, imported inside them only:
``featurize_clips`` needs neither pyarrow nor pandas.
"""

from __future__ import annotations

import csv
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audax_torch.core.config import MelConfig, UrbanSoundConfig
from audax_torch.core.logging import get_logger
from audax_torch.data.audio_io import read_wav, resample, to_mono
from audax_torch.eval.metrics import URBANSOUND8K_CLASSES

__all__ = ["parquet_name", "read_metadata", "featurize_clips",
           "preprocess_to_parquet", "load_split"]

log = get_logger("audax_torch.data.urbansound")


def parquet_name(mel: MelConfig, split: str = "") -> str:
    """Config-stamped parquet filename."""
    tag = f"_{split}" if split else ""
    return (f"urbansound8k{tag}_mels{mel.n_mels}_hop{mel.hop_length}"
            f"_fft{mel.n_fft}.parquet")


def read_metadata(cfg: UrbanSoundConfig,
                  limit: Optional[int] = None) -> List[Dict[str, object]]:
    """The rows of ``metadata/UrbanSound8K.csv``: slice_file_name, fold,
    class_id and class_name (the ``class`` column, or the UrbanSound8K name
    of ``classID`` where the column is missing)."""
    path = os.path.join(cfg.dataset_root, cfg.metadata_csv)
    with open(path, newline="", encoding="utf-8") as fh:
        rows = list(csv.DictReader(fh))
    if limit:
        rows = rows[:limit]
    out = []
    for r in rows:
        cid = int(r["classID"])
        out.append({"slice_file_name": r["slice_file_name"],
                    "fold": int(r["fold"]), "class_id": cid,
                    "class_name": str(r.get("class",
                                            URBANSOUND8K_CLASSES[cid]))})
    return out


def _read_clip(path: str, mel: MelConfig, n_samples: int
               ) -> Tuple[np.ndarray, bool]:
    """(float32 mono clip of exactly ``n_samples``, whether it is untouched
    PCM-16 at the target rate, so an int16 upload stays exact)."""
    x, rate, bits = read_wav(path, with_bits=True)
    mono = x.shape[1] == 1
    x = to_mono(x)
    if rate != mel.sample_rate:
        x = resample(x, rate, mel.sample_rate)
    if len(x) >= n_samples:
        x = x[:n_samples]
    else:
        x = np.pad(x, (0, n_samples - len(x)))
    return (x.astype(np.float32),
            bits == 16 and mono and rate == mel.sample_rate)


def featurize_clips(cfg: UrbanSoundConfig, mel: MelConfig, *,
                    batch_size: int = 64, frontend=None,
                    limit: Optional[int] = None
                    ) -> Iterator[Tuple[list, Optional[torch.Tensor]]]:
    """Yield ``(rows, feats)`` in metadata order: a batch of decoded clips
    with their ``[B, n_mels, T]`` float32 features on the frontend's device,
    or ``([row], None)`` for a clip that failed to decode (yielded when it
    fails, before the batch it would have joined). ``frontend`` defaults to
    ``LogMelFrontend(mel)`` on the CUDA card."""
    from audax_torch.frontend.features import LogMelFrontend

    frontend = frontend or LogMelFrontend(mel)
    n_samples = int(cfg.duration_s * mel.sample_rate)
    rows: list = []
    wavs: list = []
    exact16 = True

    def flush():
        batch = np.stack(wavs)                          # [B, n_samples]
        if exact16:
            q = np.clip(np.rint(batch * 32768.0), -32768, 32767) \
                .astype(np.int16)
            audio = torch.from_numpy(q).to(frontend.device).float() / 32768.0
        else:
            audio = torch.from_numpy(batch)
        return frontend(audio, mel_first=True)

    for rec in read_metadata(cfg, limit):
        path = os.path.join(cfg.dataset_root, "audio", f"fold{rec['fold']}",
                            rec["slice_file_name"])
        try:
            x, exact = _read_clip(path, mel, n_samples)
        except Exception as e:  # noqa: BLE001 - any unreadable clip is a row
            log.warning("skip %s: %s", path, e)
            yield [rec], None
            continue
        exact16 = exact16 and exact
        wavs.append(x)
        rows.append(rec)
        if len(wavs) >= batch_size:
            yield rows, flush()
            rows, wavs, exact16 = [], [], True
    if wavs:
        yield rows, flush()


def _schema():
    import pyarrow as pa
    return pa.schema([
        ("slice_file_name", pa.string()),
        ("fold", pa.int32()),
        ("class_id", pa.int32()),
        ("class_name", pa.string()),
        ("log_mel", pa.list_(pa.float32())),
        ("mel_shape", pa.list_(pa.int32())),
        ("processing_success", pa.bool_()),
    ])


def _table(rows: list, feats: Optional[np.ndarray]):
    """One Arrow table of a featurized batch (the ``log_mel`` column built
    zero-copy from the ``[B, n_mels, T]`` block) or of one failed row."""
    import pyarrow as pa

    b = len(rows)
    if feats is None:
        log_mel = pa.array([np.zeros(0, np.float32)] * b,
                           pa.list_(pa.float32()))
        mel_shape = pa.array([np.zeros(0, np.int32)] * b,
                             pa.list_(pa.int32()))
    else:
        per = feats.shape[1] * feats.shape[2]
        flat = np.ascontiguousarray(feats, np.float32).ravel()
        log_mel = pa.ListArray.from_arrays(
            pa.array(np.arange(b + 1, dtype=np.int32) * per), pa.array(flat))
        shp = np.tile(np.asarray(feats.shape[1:], np.int32), b)
        mel_shape = pa.ListArray.from_arrays(
            pa.array(np.arange(b + 1, dtype=np.int32) * 2), pa.array(shp))
    return pa.table({
        "slice_file_name": [r["slice_file_name"] for r in rows],
        "fold": [r["fold"] for r in rows],
        "class_id": [r["class_id"] for r in rows],
        "class_name": [r["class_name"] for r in rows],
        "log_mel": log_mel,
        "mel_shape": mel_shape,
        "processing_success": [feats is not None] * b,
    }, schema=_schema())


def preprocess_to_parquet(
    cfg: UrbanSoundConfig,
    mel: MelConfig,
    out_path: Optional[str] = None,
    *,
    batch_size: int = 64,
    frontend=None,
    limit: Optional[int] = None,
) -> str:
    """Featurize the dataset (``featurize_clips``) and write one Parquet
    file. Clips that fail to decode are recorded with
    ``processing_success=False`` rather than dropped. Needs pyarrow."""
    import pyarrow.parquet as pq

    out_path = out_path or os.path.join(cfg.parquet_dir, parquet_name(mel))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = pq.ParquetWriter(out_path, _schema())
    pool = ThreadPoolExecutor(max_workers=1)
    jobs: deque = deque()

    def fetch_write(rows, feats_dev):
        feats = None if feats_dev is None else feats_dev.cpu().numpy()
        writer.write_table(_table(rows, feats))

    n_rows = failed = 0
    try:
        for rows, feats in featurize_clips(cfg, mel, batch_size=batch_size,
                                           frontend=frontend, limit=limit):
            n_rows += len(rows)
            if feats is None:
                failed += 1
            else:
                while len(jobs) > 1:    # keep one fetch + write in flight
                    jobs.popleft().result()
            jobs.append(pool.submit(fetch_write, rows, feats))
        while jobs:
            jobs.popleft().result()
    finally:
        pool.shutdown(wait=True)
        writer.close()
    log.success("wrote %s (%d rows, %d failed)", out_path, n_rows, failed)
    return out_path


def load_split(parquet_path: str, folds: Sequence[int], *,
               time_major: bool = True) -> Dict[str, np.ndarray]:
    """Read a fold subset into dict arrays for the train loop.

    Returns {"x": [N, T, n_mels] (time_major) float32, "y": [N] int64,
    "file": [N] str}, from the rows that were featurized. Needs pyarrow."""
    import pyarrow.parquet as pq

    table = pq.read_table(parquet_path)
    ok = table.column("processing_success").to_pylist()
    fold = table.column("fold").to_pylist()
    wanted = set(int(f) for f in folds)
    keep = [i for i in range(table.num_rows) if ok[i] and fold[i] in wanted]
    mels = table.column("log_mel").combine_chunks()
    shapes = table.column("mel_shape").combine_chunks()
    values = mels.values.to_numpy(zero_copy_only=False)
    offsets = mels.offsets.to_numpy()
    shape_values = shapes.values.to_numpy(zero_copy_only=False)
    shape_offsets = shapes.offsets.to_numpy()
    xs = []
    for i in keep:
        shape = tuple(shape_values[shape_offsets[i]: shape_offsets[i + 1]])
        feat = values[offsets[i]: offsets[i + 1]].astype(np.float32)
        feat = feat.reshape(shape)
        xs.append(feat.T if time_major else feat)
    class_id = table.column("class_id").to_pylist()
    names = table.column("slice_file_name").to_pylist()
    return {
        "x": np.stack(xs) if xs else np.zeros((0, 0, 0), np.float32),
        "y": np.asarray([class_id[i] for i in keep], np.int64),
        "file": np.asarray([names[i] for i in keep], dtype=object),
    }
