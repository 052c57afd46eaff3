"""Transcription API: wav -> text with 30 s chunking, KV-cached decode,
whisper-style temperature fallback and optional timestamp segments (port of
``audax/infer/transcribe.py:Transcriber`` and the helpers it uses).

The window size defaults to the model's audio capacity (n_audio_ctx x conv
stride 2 x hop: 30 s for the published family). Windows are decoded in
groups of ``batch_chunks``; a short group is padded with duplicates of its
last window so every group has the same batch size. Decoding starts greedy
and falls back through rising temperatures when a window's mean
log-probability or gzip compression ratio looks degenerate; a window whose
``<|nospeech|>`` probability is high and confidence low is emitted as
silence. ``condition_on_previous`` decodes windows one at a time with the
previous text as ``<|startofprev|>`` context.

The port carries greedy decoding with the fallback ladder, int8/int4
weight-only trees (``quantize``, ``models/quantize.py``) and int8 KV caches
(``kv_quant``). Beam search, best-of sampling, word timestamps,
speculative drafts, tensor parallelism, clip ranges, hallucination
filtering, seeking by timestamps, energy VAD and language detection raise
``NotImplementedError`` until the later slices that bring them.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.infer.decode import GenerateResult, TimestampRules, generate
from audax_torch.models.quantize import quantize_tree
from audax_torch.models.whisper import encode, tree_map
from audax_torch.ops import native
from audax_torch.symbolic.tokenizer import WhisperTokenizer

__all__ = ["Transcriber", "TranscriptionResult", "Segment",
           "compression_ratio"]

FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
LOGPROB_THRESHOLD = -1.0
COMPRESSION_THRESHOLD = 2.4

#: constructor knobs of the JAX Transcriber that this slice does not carry:
#: name -> (default, the later slice that brings it)
_LATER_KNOBS = {
    "beam_width": (1, "serving tiers (beam search)"),
    "best_of": (1, "serving tiers (best-of sampling)"),
    "patience": (None, "serving tiers (beam search)"),
    "length_penalty": (None, "serving tiers (beam search)"),
    "word_timestamps": (False, "serving tiers (word alignment)"),
    "draft": (None, "serving tiers (speculative decoding)"),
    "mesh": (None, "parallelism"),
    "clip_timestamps": (None, "serving tiers (clip ranges)"),
    "hallucination_silence_threshold": (None, "serving tiers (word "
                                        "alignment)"),
    "seek_by_timestamps": (False, "serving tiers (seek loop)"),
    "vad_threshold_db": (None, "serving tiers (energy VAD)"),
}


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


@dataclass
class Segment:
    text: str
    start: float                 # seconds (chunk offset included)
    end: float
    avg_logprob: float
    temperature: float
    #: word timings: always None in this slice (no word alignment yet)
    words: Optional[list] = None
    compression_ratio: float = 0.0
    no_speech_prob: Optional[float] = None
    #: the segment's text token ids (openai segments carry them too)
    tokens: Optional[List[int]] = None


@dataclass
class TranscriptionResult:
    text: str
    segments: List[Segment]
    audio_seconds: float
    wall_seconds: float

    @property
    def rtf(self) -> float:
        """Real-time factor (wall / audio)."""
        return self.wall_seconds / max(self.audio_seconds, 1e-9)


class Transcriber:
    """Bundled frontend + Whisper params + tokenizer on one device."""

    #: previous-context buckets: lengths are truncated DOWN to one of these
    CONTEXT_BUCKETS = (16, 32, 64)

    def __init__(self, params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, *,
                 lang: str = "en", task: str = "transcribe",
                 max_new_tokens: int = 224,
                 timestamps: bool = False,
                 temperature_fallback: bool = True,
                 condition_on_previous: bool = False,
                 chunk_seconds: Optional[float] = None,
                 no_speech_threshold: Optional[float] = 0.6,
                 initial_prompt: Optional[str] = None,
                 temperatures: Tuple[float, ...] = FALLBACK_TEMPERATURES,
                 logprob_threshold: float = LOGPROB_THRESHOLD,
                 compression_threshold: float = COMPRESSION_THRESHOLD,
                 suppress_tokens="-1", suppress_blank: bool = True,
                 dtype=torch.float32, device: DeviceLike = None,
                 beam_width: int = 1, best_of: int = 1,
                 patience: Optional[float] = None,
                 length_penalty: Optional[float] = None,
                 word_timestamps: bool = False, draft=None,
                 quantize=False, kv_quant: bool = False, mesh=None,
                 clip_timestamps=None,
                 hallucination_silence_threshold: Optional[float] = None,
                 seek_by_timestamps: bool = False,
                 vad_threshold_db: Optional[float] = None):
        given = dict(beam_width=beam_width, best_of=best_of,
                     patience=patience, length_penalty=length_penalty,
                     word_timestamps=word_timestamps, draft=draft,
                     mesh=mesh,
                     clip_timestamps=clip_timestamps,
                     hallucination_silence_threshold=(
                         hallucination_silence_threshold),
                     seek_by_timestamps=seek_by_timestamps,
                     vad_threshold_db=vad_threshold_db)
        for name, (default, later) in _LATER_KNOBS.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"Transcriber({name}={given[name]!r}) arrives with a "
                    f"later slice of the port: {later}")
        if lang == "auto":
            raise NotImplementedError("lang='auto' (language detection) "
                                      "arrives with a later slice of the port")
        if task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe/translate, got {task!r}")
        self.device = resolve_device(device)
        # serving records no graph: trained leaves that require grad are
        # detached (the same storage, no copy)
        params = tree_map(lambda t: t.detach(), params)
        if quantize:
            # weight-only serving: True/8/"int8" -> int8, 4/"int4" -> int4
            if str(quantize) not in ("True", "8", "int8", "4", "int4"):
                raise ValueError(f"quantize={quantize!r}: expected True/8/"
                                 f"'int8' or 4/'int4'")
            params = quantize_tree(
                params, bits=4 if str(quantize) in ("4", "int4") else 8)
        self.params = params
        #: int8 self- and cross-attention KV caches in decode
        self.kv_quant = kv_quant
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lang = lang
        self.task = task
        self.max_new_tokens = max_new_tokens
        self.timestamps = timestamps
        self.temperature_fallback = temperature_fallback
        self.condition_on_previous = condition_on_previous
        self.no_speech_threshold = no_speech_threshold
        #: <|startofprev|> context: seeds the rolling context with
        #: condition_on_previous, else applies to every window
        self.initial_prompt_ids: List[int] = (
            tokenizer.encode(" " + initial_prompt.strip())
            if initial_prompt else [])
        self.temperatures = tuple(temperatures)
        self.logprob_threshold = logprob_threshold
        self.compression_threshold = compression_threshold
        self.dtype = dtype
        self.frontend = LogMelFrontend.whisper(cfg.n_mels, device=self.device)
        if chunk_seconds is None:
            chunk_seconds = (cfg.n_audio_ctx * 2 * self.frontend.cfg.hop_length
                             / self.frontend.cfg.sample_rate)
        self.chunk_seconds = float(chunk_seconds)
        self.chunk_samples = int(self.chunk_seconds
                                 * self.frontend.cfg.sample_rate)
        # whisper's SuppressTokens: control tokens are never emitted (EOT
        # excepted; timestamps follow TimestampRules), plus suppress_tokens:
        # "-1" adds the non-speech symbol set, a sequence adds those ids
        if suppress_tokens == "-1":
            extra = tokenizer.non_speech_tokens()
        elif suppress_tokens:
            extra = [int(i) for i in suppress_tokens]
        else:
            extra = []
        specials = [i for i in tokenizer.special_ids() if i != tokenizer.eot]
        self.suppress = torch.tensor(sorted(set(specials + extra)),
                                     dtype=torch.long, device=self.device)
        # SuppressBlank: ' ' and EOT banned at the first generated position
        self.first_suppress = (torch.tensor(
            sorted(set(tokenizer.encode(" ") + [tokenizer.eot])),
            dtype=torch.long, device=self.device) if suppress_blank else None)

    def _prompt(self, n: int, prev: Optional[List[int]] = None,
                lang: Optional[str] = None) -> np.ndarray:
        """SOT sequence, optionally preceded by <|startofprev|> and the
        bucketed previous-text tokens: long context keeps the LATEST
        bucket-many tokens; context shorter than the smallest bucket is
        left-padded with its first token."""
        tk = self.tokenizer
        seq = tk.sot_sequence(lang=lang or self.lang, task=self.task,
                              timestamps=self.timestamps)
        if prev:
            bucket = max((b for b in self.CONTEXT_BUCKETS if b <= len(prev)),
                         default=min(self.CONTEXT_BUCKETS))
            ctx = list(prev[-bucket:])
            ctx = [ctx[0]] * (bucket - len(ctx)) + ctx
            seq = [tk.sot_prev] + ctx + seq
        return np.asarray([seq] * n, np.int64)

    def _decode_once(self, enc: torch.Tensor, prompt: np.ndarray,
                     temperature: float) -> GenerateResult:
        tk = self.tokenizer
        rules = (TimestampRules(tk.timestamp_begin, tk.eot)
                 if self.timestamps else None)
        max_len = min(prompt.shape[1] + self.max_new_tokens,
                      self.cfg.n_text_ctx)
        ns_id = tk.no_speech if self.no_speech_threshold is not None else None
        # openai reads no_speech_prob from the logits AT <|sot|>
        ns_pos = (int(np.where(prompt[0] == tk.sot)[0][-1])
                  if ns_id is not None else None)
        return generate(self.params, self.cfg, enc,
                        torch.from_numpy(prompt).to(self.device),
                        max_len=max_len, eos_id=tk.eot,
                        temperature=temperature,
                        suppress=self.suppress,
                        first_suppress=self.first_suppress,
                        timestamps=rules, dtype=self.dtype,
                        no_speech_id=ns_id, no_speech_pos=ns_pos,
                        kv_quant=self.kv_quant)

    @torch.inference_mode()
    def warmup(self, *, batch_chunks: int = 4) -> None:
        """Build the CUDA kernels (on a CUDA device) and run one dummy
        window group through the frontend, encoder and greedy decode."""
        if self.device.type == "cuda":
            native.build()
        mel = self.frontend(torch.zeros(batch_chunks, self.chunk_samples,
                                        device=self.device))
        enc = encode(self.params, self.cfg, mel, self.dtype)
        self._decode_once(enc, self._prompt(batch_chunks), 0.0)

    @torch.inference_mode()
    def _decode_chunk_batch(self, audio_chunks: np.ndarray,
                            prev: Optional[List[int]] = None,
                            lang: Optional[str] = None):
        """[N, chunk_samples] -> per-window (token ids, avg_logprob, temp,
        compression ratio, no-speech prob) via the fallback ladder."""
        mel = self.frontend(audio_chunks)
        enc = encode(self.params, self.cfg, mel, self.dtype)
        n = len(audio_chunks)
        prompt = self._prompt(n, prev, lang)
        p = prompt.shape[1]
        tk = self.tokenizer
        results: List[Optional[tuple]] = [None] * n
        pending = list(range(n))
        ladder = (self.temperatures if self.temperature_fallback
                  else (self.temperatures[0],))
        for ti, temp in enumerate(ladder):
            if not pending:
                break
            # fixed batch: unfinished windows first, duplicates after
            idx = pending + [pending[0]] * (n - len(pending))
            out = self._decode_once(enc[torch.tensor(idx, device=enc.device)],
                                    prompt, temp)
            tokens = out.tokens.cpu().numpy()
            lengths = out.lengths.cpu().numpy()
            avg_lp = out.avg_logprob.cpu().numpy()
            nsp = (out.no_speech_prob.cpu().numpy()
                   if out.no_speech_prob is not None else None)
            still = []
            for row_i, chunk_i in enumerate(pending):
                ids = [int(t) for t in tokens[row_i, p: lengths[row_i]]
                       if t != tk.eot]
                cr = compression_ratio(tk.decode(ids))
                ok = (avg_lp[row_i] >= self.logprob_threshold
                      and cr <= self.compression_threshold)
                silent = (nsp is not None
                          and nsp[row_i] > self.no_speech_threshold
                          and avg_lp[row_i] < self.logprob_threshold)
                last = ti == len(ladder) - 1
                nsv = float(nsp[row_i]) if nsp is not None else None
                if silent:
                    results[chunk_i] = ([], float(avg_lp[row_i]), temp, 0.0,
                                        nsv)
                elif ok or last:
                    results[chunk_i] = (ids, float(avg_lp[row_i]), temp, cr,
                                        nsv)
                else:
                    still.append(chunk_i)
            pending = still
        return results

    @torch.inference_mode()
    def transcribe(self, audio: np.ndarray, *, batch_chunks: int = 4
                   ) -> TranscriptionResult:
        """audio: 1-D float waveform at 16 kHz, split into windows."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        t0 = time.perf_counter()
        total_s = len(audio) / self.frontend.cfg.sample_rate
        segments = self._transcribe_segments(audio, batch_chunks, self.lang)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return TranscriptionResult(
            text="".join(s.text for s in segments).strip(),
            segments=segments, audio_seconds=total_s, wall_seconds=wall)

    def _window_segments(self, ids, offset, avg_lp, temp, cr, nsv):
        if self.timestamps:
            return self._split_segments(ids, offset, avg_lp, temp, cr=cr,
                                        nsv=nsv)
        return [Segment(self.tokenizer.decode(ids), offset,
                        offset + self.chunk_seconds, avg_lp, temp,
                        compression_ratio=cr, no_speech_prob=nsv,
                        tokens=list(ids))]

    def _transcribe_segments(self, audio: np.ndarray, batch_chunks: int,
                             lang: str) -> List[Segment]:
        n = len(audio)
        sr = self.frontend.cfg.sample_rate
        chunks = []
        for start in range(0, max(n, 1), self.chunk_samples):
            chunk = audio[start: start + self.chunk_samples]
            if len(chunk) < self.chunk_samples:
                chunk = np.pad(chunk, (0, self.chunk_samples - len(chunk)))
            chunks.append(chunk)
        tk = self.tokenizer
        segments: List[Segment] = []
        if self.condition_on_previous:
            # sequential: each window's prompt carries the previous text,
            # reset after a high-temperature fallback (whisper convention)
            prev: List[int] = list(self.initial_prompt_ids)
            for k, chunk in enumerate(chunks):
                ids, avg_lp, temp, cr, nsv = self._decode_chunk_batch(
                    chunk[None], prev=prev, lang=lang)[0]
                segments.extend(self._window_segments(
                    ids, k * self.chunk_samples / sr, avg_lp, temp, cr, nsv))
                if temp > 0.5:
                    prev = []
                else:
                    prev = prev + [t for t in ids if not tk.is_timestamp(t)]
        else:
            init_ctx = self.initial_prompt_ids or None
            for i in range(0, len(chunks), batch_chunks):
                part = chunks[i: i + batch_chunks]
                n_valid = len(part)
                group = np.stack(part + [part[-1]] * (batch_chunks - n_valid))
                res = self._decode_chunk_batch(group, prev=init_ctx, lang=lang)
                for j, (ids, avg_lp, temp, cr, nsv) in enumerate(res[:n_valid]):
                    segments.extend(self._window_segments(
                        ids, (i + j) * self.chunk_seconds, avg_lp, temp, cr,
                        nsv))
        # the final window is zero-padded: clamp spans to the real audio
        total_s = n / sr
        for s in segments:
            s.end = min(s.end, total_s)
            s.start = min(s.start, s.end)
        return segments

    def _split_segments(self, ids: List[int], offset: float, avg_lp: float,
                        temp: float, *, cr: float = 0.0,
                        nsv: Optional[float] = None) -> List[Segment]:
        """Cut a window's tokens at timestamp pairs into timed segments."""
        tk = self.tokenizer
        segments: List[Segment] = []
        start_t: Optional[float] = None
        text_ids: List[int] = []
        for t in ids:
            if tk.is_timestamp(t):
                ts = tk.timestamp_seconds(t)
                if start_t is None:
                    start_t = ts
                else:
                    segments.append(Segment(tk.decode(text_ids),
                                            offset + start_t, offset + ts,
                                            avg_lp, temp,
                                            compression_ratio=cr,
                                            no_speech_prob=nsv,
                                            tokens=text_ids))
                    start_t = None
                    text_ids = []
            else:
                text_ids.append(t)
        if text_ids:
            segments.append(Segment(tk.decode(text_ids),
                                    offset + (start_t or 0.0),
                                    offset + self.chunk_seconds, avg_lp, temp,
                                    compression_ratio=cr,
                                    no_speech_prob=nsv, tokens=text_ids))
        return segments
