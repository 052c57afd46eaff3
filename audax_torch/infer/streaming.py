"""Batched streaming transcription (port of ``audax/infer/streaming.py``:
``StreamingTranscriber``, ``Segment``).

N independent audio streams feed per-stream buffers on the host; whenever
streams hold a full window (or are flushed), up to ``batch_slots`` windows
are packed into ONE fixed-shape batch -- empty slots zero-filled -- and
run through the frontend (K1), the encoder (K2) and greedy ``generate``
(K3) in one pass. A short final window is zero-padded to the window
(Whisper's own convention). With ``vad_threshold_db`` a window below that
energy is answered as an empty segment without taking a slot or a decode.
With ``mesh`` (a (data, model) mesh) the parameters are cut over 'model'
(``parallel/sharding.py:shard_params``), the window batch's mel rows go
over 'data' when they divide (else every rank encodes them all), and the
decode runs ``generate(mesh=)``; every rank feeds the same streams and
returns the same segments.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.infer.decode import generate
from audax_torch.infer.vad import is_silent
from audax_torch.models.whisper import encode, tree_map
from audax_torch.parallel.comm import all_gather_cat
from audax_torch.parallel.mesh import (batch_group, batch_size, shard_batch,
                                       use_mesh)
from audax_torch.parallel.sharding import shard_params
from audax_torch.symbolic.tokenizer import WhisperTokenizer

log = get_logger("audax_torch.streaming")

__all__ = ["StreamingTranscriber", "Segment"]


@dataclass
class Segment:
    stream_id: str
    index: int                  # chunk index within the stream
    text: str
    audio_seconds: float


@dataclass
class _Stream:
    buffer: np.ndarray
    filled: int = 0
    chunk_index: int = 0
    #: (chunk index, window-sized samples, valid sample count)
    pending: List[Tuple[int, np.ndarray, int]] = field(default_factory=list)


class StreamingTranscriber:
    """Fixed-slot batched streaming ASR.

    Usage::

        st = StreamingTranscriber(params, cfg, tokenizer, batch_slots=8)
        st.feed("mic0", samples)          # any sample counts, any time
        for seg in st.step():             # one batched device pass
            print(seg.stream_id, seg.text)
        st.flush("mic0")                  # emit trailing partial chunk
    """

    def __init__(self, params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, *,
                 batch_slots: int = 8, window_seconds: float = 30.0,
                 lang: str = "en", max_new_tokens: int = 224,
                 mesh=None, dtype=torch.float32, device: DeviceLike = None,
                 kv_quant: bool = False,
                 vad_threshold_db: Optional[float] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_slots = batch_slots
        self.lang = lang
        self.max_new_tokens = max_new_tokens
        self.dtype = dtype
        #: int8 KV caches: half the per-slot decode cache bytes
        self.kv_quant = kv_quant
        self.params = tree_map(lambda t: t.detach(), params)
        self.mesh = mesh
        if mesh is not None:
            self.params = shard_params(self.params, mesh, heads=cfg.heads)
        self.frontend = LogMelFrontend.whisper(cfg.n_mels, device=self.device)
        self.window = int(window_seconds * self.frontend.cfg.sample_rate)
        self.streams: Dict[str, _Stream] = {}
        prompt = tokenizer.sot_sequence(lang=lang)
        self._prompt = torch.tensor([prompt] * batch_slots, dtype=torch.long,
                                    device=self.device)
        self._max_len = min(len(prompt) + max_new_tokens, cfg.n_text_ctx)
        # control tokens are never emitted (whisper SuppressTokens)
        self._suppress = torch.tensor(
            [i for i in tokenizer.special_ids() if i != tokenizer.eot],
            dtype=torch.long, device=self.device)
        #: energy VAD (infer/vad.py): windows under this dBFS answer as
        #: empty segments without taking a slot or a decode (None: off)
        self.vad_threshold_db = vad_threshold_db

    # ---------------------------------------------------------- feeding ---
    def feed(self, stream_id: str, samples: np.ndarray) -> None:
        s = self.streams.setdefault(
            stream_id, _Stream(np.zeros(self.window, np.float32)))
        samples = np.asarray(samples, np.float32).reshape(-1)
        pos = 0
        while pos < len(samples):
            take = min(self.window - s.filled, len(samples) - pos)
            s.buffer[s.filled: s.filled + take] = samples[pos: pos + take]
            s.filled += take
            pos += take
            if s.filled == self.window:
                s.pending.append((s.chunk_index, s.buffer.copy(),
                                  self.window))
                s.chunk_index += 1
                s.filled = 0

    def flush(self, stream_id: str) -> None:
        """Queue the trailing partial window (zero-padded)."""
        s = self.streams.get(stream_id)
        if s and s.filled > 0:
            chunk = np.zeros(self.window, np.float32)
            chunk[: s.filled] = s.buffer[: s.filled]
            s.pending.append((s.chunk_index, chunk, s.filled))
            s.chunk_index += 1
            s.filled = 0

    def remove(self, stream_id: str) -> None:
        """Drop a finished stream's buffer and queued chunks. Serving layers
        call this on disconnect: streams are never evicted implicitly."""
        self.streams.pop(stream_id, None)

    def pending_chunks(self) -> int:
        return sum(len(s.pending) for s in self.streams.values())

    # ----------------------------------------------------------- device ---
    @torch.inference_mode()
    def _run_batch(self, audio: np.ndarray) -> List[List[int]]:
        mel = self.frontend(audio)
        mesh = self.mesh
        if mesh is None:
            enc = encode(self.params, self.cfg, mel, self.dtype)
        elif batch_size(mesh) > 1 and mel.shape[0] % batch_size(mesh) == 0:
            # the rows ride the data axis, and come back whole for the
            # decode, which cuts its slots itself
            with use_mesh(mesh):
                enc = encode(self.params, self.cfg, shard_batch(mesh, mel),
                             self.dtype)
            enc = all_gather_cat(enc, batch_group(mesh), 0)
        else:
            with use_mesh(mesh):
                enc = encode(self.params, self.cfg, mel, self.dtype)
        result = generate(self.params, self.cfg, enc, self._prompt,
                          max_len=self._max_len, eos_id=self.tokenizer.eot,
                          suppress=self._suppress, dtype=self.dtype,
                          kv_quant=self.kv_quant, mesh=mesh)
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        p = self._prompt.shape[1]
        return [[int(t) for t in row[p: n] if t != self.tokenizer.eot]
                for row, n in zip(tokens, lengths)]

    def step(self) -> List[Segment]:
        """Drain up to ``batch_slots`` pending chunks in one device pass.
        Empty slots are zero-filled (fixed shape). With
        ``vad_threshold_db`` set, silent windows are answered inline (empty
        text) and never take a slot."""
        sr = self.frontend.cfg.sample_rate
        work: List[Tuple[str, int, np.ndarray, int]] = []
        silent: List[Segment] = []
        for sid in sorted(self.streams):
            s = self.streams[sid]
            while s.pending and len(work) < self.batch_slots:
                idx, chunk, valid = s.pending.pop(0)
                if (self.vad_threshold_db is not None
                        and is_silent(chunk, sr, self.vad_threshold_db)):
                    silent.append(Segment(sid, idx, "", valid / sr))
                    continue
                work.append((sid, idx, chunk, valid))
            if len(work) >= self.batch_slots:
                break
        if not work:
            return silent
        audio = np.zeros((self.batch_slots, self.window), np.float32)
        for i, (_, _, chunk, _) in enumerate(work):
            audio[i] = chunk
        t0 = time.perf_counter()
        decoded = self._run_batch(audio)
        dt = time.perf_counter() - t0
        # audio_seconds is the REAL content, not the padded window
        segs = silent + [Segment(sid, idx, self.tokenizer.decode(ids),
                                 valid / sr)
                         for (sid, idx, _, valid), ids in zip(work, decoded)]
        real_s = sum(v for _, _, _, v in work) / sr
        log.info("streamed %d chunks in %.2fs (batch rtf %.3f)",
                 len(work), dt, dt / max(real_s, 1e-9))
        return segs

    def drain(self) -> List[Segment]:
        """Run steps until no pending work remains."""
        out: List[Segment] = []
        while self.pending_chunks():
            out.extend(self.step())
        return out

    def warmup(self) -> None:
        """Run the (only) batch shape once -- frontend, encoder and decode at
        the fixed slot count -- before the first client connects."""
        self._run_batch(np.zeros((self.batch_slots, self.window), np.float32))
