"""The music2midi 4-stage preprocessing pipeline and its dataset loader
(port of ``audax/data/music_dataset.py``).

  stage 1  midi2wav    -- tempo-aware cut to ``chunk_duration_s``, then the
                          synth render (``data/synth.py:render_midi``)
  stage 2  midi2abc    -- ABC emission (``symbolic/abc.py:midi_to_abc``)
  stage 3  gentokens   -- a raw token vocab, or BPE training
  stage 4  genparquet  -- a typed pyarrow schema with waveform + abc +
                          metadata + ``processing_success``

(reference: .charles/music2midi/preprocess_data.py:54-632). Host
parallelism keeps the reference's Pool shape, with workers started by
``spawn``. ``MusicDataset`` mirrors music2midi/dataset.py:22-93: the
``processing_success`` rows in file order, ABC tokenized to fixed-length
padded ids. It reads the Parquet with ``pyarrow`` alone (the JAX loader
goes through pandas, which the port does not use).
"""

from __future__ import annotations

import glob
import json
import multiprocessing
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from audax_torch.core.config import DataGenConfig
from audax_torch.core.logging import get_logger
from audax_torch.data.audio_io import read_wav, to_mono, write_wav
from audax_torch.data.synth import render_midi
from audax_torch.symbolic.abc import (extract_abc_metadata, extract_tokens,
                                      midi_to_abc)
from audax_torch.symbolic.bpe import BPE, train_bpe
from audax_torch.symbolic.midi import MidiFile

log = get_logger("audax_torch.music2midi")

__all__ = ["stage_midi2wav", "stage_midi2abc", "stage_gentokens_raw",
           "stage_gentokens_bpe", "stage_genparquet", "MusicExample",
           "MusicDataset", "ABC_SPECIALS"]

ABC_SPECIALS = ("<abc_start>", "<abc_end>", "<abc_pad>")


def _run(fn, args: list, workers: int) -> list:
    if workers > 1 and len(args) > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            return list(pool.imap_unordered(fn, args))
    return [fn(a) for a in args]


def _midis(midi_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(midi_dir, "**", "*.mid"),
                            recursive=True))


# ---------------------------------------------------------------- stage 1 --
def _midi2wav_one(args) -> Tuple[str, bool, str]:
    path, out_dir, chunk_s, sample_rate, soundfont = args
    try:
        mf = MidiFile.load(path)
        if chunk_s and mf.duration_seconds > chunk_s:
            mf = mf.cut(chunk_s)
        if not mf.notes:
            return path, False, "no notes"
        audio = render_midi(mf, sample_rate, soundfont)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, f"{stem}.wav")
        write_wav(out, audio, sample_rate)
        # the cut midi beside it, so stage 2 sees the same content
        mf.save(os.path.join(out_dir, f"{stem}.mid"))
        return path, True, out
    except Exception as e:                  # per-file: logged and skipped
        return path, False, str(e)


def stage_midi2wav(midi_dir: str, out_dir: str, cfg: DataGenConfig,
                   *, workers: Optional[int] = None) -> List[str]:
    """Cut every .mid to ``cfg.chunk_duration_s`` and render it at
    ``cfg.sample_rate`` (through ``cfg.soundfont`` when one is set); a
    file that fails is logged and skipped."""
    os.makedirs(out_dir, exist_ok=True)
    paths = _midis(midi_dir)
    args = [(p, out_dir, cfg.chunk_duration_s, cfg.sample_rate,
             cfg.soundfont or None) for p in paths]
    results = _run(_midi2wav_one, args,
                   workers or max(1, multiprocessing.cpu_count() // 2))
    ok = [r[2] for r in results if r[1]]
    for path, success, msg in results:
        if not success:
            log.warning("midi2wav failed %s: %s", path, msg)
    log.success("midi2wav: %d/%d rendered -> %s", len(ok), len(paths), out_dir)
    return ok


# ---------------------------------------------------------------- stage 2 --
def _midi2abc_one(args) -> Tuple[str, bool, str]:
    path, out_dir = args
    try:
        mf = MidiFile.load(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        abc = midi_to_abc(mf, title=stem)
        out = os.path.join(out_dir, f"{stem}.abc")
        with open(out, "w") as fh:
            fh.write(abc)
        return path, True, out
    except Exception as e:                  # per-file: logged and skipped
        return path, False, str(e)


def stage_midi2abc(midi_dir: str, out_dir: str,
                   *, workers: Optional[int] = None) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = _midis(midi_dir)
    results = _run(_midi2abc_one, [(p, out_dir) for p in paths],
                   workers or max(1, multiprocessing.cpu_count() // 4))
    ok = [r[2] for r in results if r[1]]
    log.success("midi2abc: %d/%d converted -> %s", len(ok), len(paths),
                out_dir)
    return ok


# ---------------------------------------------------------------- stage 3 --
def _abc_paths(abc_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(abc_dir, "*.abc")))


def stage_gentokens_raw(abc_dir: str, out_json: str) -> Dict[str, int]:
    """Raw token vocab over all ABC files -> token->id JSON
    (reference :311-361)."""
    vocab: Dict[str, int] = {}
    for sp in ("<pad>", "<s>", "</s>", "<unk>", *ABC_SPECIALS):
        vocab[sp] = len(vocab)
    for path in _abc_paths(abc_dir):
        with open(path) as fh:
            for tok in extract_tokens(fh.read()):
                if tok not in vocab:
                    vocab[tok] = len(vocab)
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as fh:
        json.dump(vocab, fh, ensure_ascii=False, indent=0)
    log.success("gentokens-raw: %d tokens -> %s", len(vocab), out_json)
    return vocab


def stage_gentokens_bpe(abc_dir: str, out_dir: str,
                        vocab_size: int = 2000) -> BPE:
    """Byte-level BPE over the ABC corpus with the reference's special
    tokens (vocab 2000, <abc_start/end/pad>; reference :363-472)."""
    corpus = []
    for path in _abc_paths(abc_dir):
        with open(path) as fh:
            corpus.append(fh.read())
    bpe = train_bpe(corpus, vocab_size, special_tokens=list(ABC_SPECIALS),
                    min_frequency=2)
    bpe.save(out_dir)
    log.success("gentokens-bpe: vocab %d (%d merges) -> %s",
                len(bpe), len(bpe.merges), out_dir)
    return bpe


# ---------------------------------------------------------------- stage 4 --
def _music_schema():
    import pyarrow as pa
    return pa.schema([
        ("filename", pa.string()),
        ("waveform", pa.list_(pa.float32())),
        ("sample_rate", pa.int32()),
        ("duration", pa.float32()),
        ("abc_string", pa.string()),
        ("abc_tokens", pa.int32()),
        ("tempo", pa.int32()),
        ("key_signature", pa.string()),
        ("time_signature", pa.string()),
        ("processing_success", pa.bool_()),
    ])


def _music_row(stem: str, wav: Optional[str], abc_path: Optional[str]
               ) -> dict:
    """One Parquet row; ``processing_success`` False (and the other
    fields empty) when the pair is incomplete or unreadable."""
    row = {"filename": stem, "waveform": np.zeros(0, np.float32),
           "sample_rate": 0, "duration": 0.0, "abc_string": "",
           "abc_tokens": 0, "tempo": 0, "key_signature": "",
           "time_signature": "", "processing_success": False}
    try:
        if wav is None or abc_path is None:
            raise FileNotFoundError("missing wav or abc")
        x, rate = read_wav(wav)
        x = to_mono(x).astype(np.float32)
        with open(abc_path) as fh:
            abc = fh.read()
        md = extract_abc_metadata(abc)
        row.update({
            "waveform": x, "sample_rate": rate,
            "duration": len(x) / rate, "abc_string": abc,
            "abc_tokens": len(extract_tokens(abc)),
            "tempo": md.tempo or 0, "key_signature": md.key or "",
            "time_signature": md.meter or "",
            "processing_success": True,
        })
    except Exception as e:                  # per-row: a failed row
        log.warning("genparquet %s: %s", stem, e)
    return row


def stage_genparquet(wav_dir: str, abc_dir: str, out_parquet: str,
                     *, batch_rows: int = 64) -> str:
    """Pair wavs and ABCs by stem into the typed Parquet (reference schema
    :487-501; batched writer :534-608). Needs pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    def stems(pattern):
        return {os.path.splitext(os.path.basename(p))[0]: p
                for p in glob.glob(pattern)}

    wavs = stems(os.path.join(wav_dir, "*.wav"))
    abcs = stems(os.path.join(abc_dir, "*.abc"))
    names = sorted(set(wavs) | set(abcs))
    os.makedirs(os.path.dirname(out_parquet) or ".", exist_ok=True)
    schema = _music_schema()
    n_ok = 0
    with pq.ParquetWriter(out_parquet, schema) as writer:
        for i in range(0, len(names), batch_rows):
            rows = [_music_row(s, wavs.get(s), abcs.get(s))
                    for s in names[i: i + batch_rows]]
            n_ok += sum(r["processing_success"] for r in rows)
            writer.write_table(pa.table(
                {k: [r[k] for r in rows] for k in rows[0]}, schema=schema))
    log.success("genparquet: %d/%d ok -> %s", n_ok, len(names), out_parquet)
    return out_parquet


# ----------------------------------------------------------------- loader --
@dataclass
class MusicExample:
    waveform: np.ndarray
    sample_rate: int
    input_ids: np.ndarray
    attention_mask: np.ndarray
    abc: str
    filename: str


class MusicDataset:
    """Parquet-backed dataset: the ``processing_success`` rows in file
    order; ABC -> fixed-length padded ids with <abc_start>/<abc_end>
    wrapping (reference dataset.py:48-94). Needs pyarrow."""

    def __init__(self, parquet_path: str, tokenizer: BPE, *,
                 max_tokens: int = 512):
        import pyarrow.parquet as pq
        table = pq.read_table(parquet_path)
        table = table.filter(table.column("processing_success"))
        wave = table.column("waveform").combine_chunks()
        self._offsets = wave.offsets.to_numpy()
        self._samples = wave.values.to_numpy(zero_copy_only=False)
        self._rates = table.column("sample_rate").to_pylist()
        self._abc = table.column("abc_string").to_pylist()
        self._names = table.column("filename").to_pylist()
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        vocab = tokenizer.vocab
        self.start_id = vocab.get(ABC_SPECIALS[0], 0)
        self.end_id = vocab.get(ABC_SPECIALS[1], 0)
        self.pad_id = vocab.get(ABC_SPECIALS[2], 0)

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, i: int) -> MusicExample:
        abc = self._abc[i]
        ids = [self.start_id] + self.tokenizer.encode(
            abc, with_specials=False) + [self.end_id]
        ids = ids[: self.max_tokens]
        mask = np.zeros(self.max_tokens, np.int32)
        mask[: len(ids)] = 1
        padded = np.full(self.max_tokens, self.pad_id, np.int32)
        padded[: len(ids)] = ids
        lo, hi = self._offsets[i], self._offsets[i + 1]
        return MusicExample(
            waveform=np.asarray(self._samples[lo:hi], np.float32),
            sample_rate=int(self._rates[i]),
            input_ids=padded, attention_mask=mask,
            abc=abc, filename=self._names[i])

    def examples(self):
        for i in range(len(self)):
            yield self[i]
