"""Transcription API: wav -> text with 30 s chunking, KV-cached decode,
whisper-style temperature fallback, timestamp segments and word timings
(port of ``audax/infer/transcribe.py``: ``Transcriber``,
``TranscriptionResult``, ``Segment``, ``detect_language``,
``hallucination_filter``, ``batch_transcribe_to_csv``).

The window size defaults to the model's audio capacity (n_audio_ctx x conv
stride 2 x hop: 30 s for the published family). Windows are decoded in
groups of ``batch_chunks``; a short group is padded with duplicates of its
last window so every group has the same batch size. Decoding starts at
t = 0 -- greedy, beam search with ``beam_width > 1``
(``infer/beam.py``), or draft-verified greedy with ``draft=``
(``infer/speculative.py``, one window at a time) -- and falls back through
rising temperatures, each drawing ``best_of`` samples and keeping the
ranker's best, when a window's mean log-probability or gzip compression
ratio looks degenerate; a window whose ``<|nospeech|>`` probability is
high and confidence low is emitted as silence.

Sequential windows (``condition_on_previous``, ``seek_by_timestamps`` or
``hallucination_silence_threshold``) run openai's seek loop: the previous
text as ``<|startofprev|>`` context, the next window starting at the last
complete segment's end, and anomalous words around long silences skipped.
``word_timestamps`` aligns each window's tokens to its frames by
cross-attention DTW (``infer/align.py``); ``vad_threshold_db`` answers a
window below that energy as silence without a decode (``infer/vad.py``);
``clip_timestamps`` transcribes only the given ranges; ``lang="auto"``
detects the language of each call's first window.

``mesh`` (tensor parallelism): the Transcriber cuts the weights it is
given (after quantizing them) by ``WHISPER_TP_RULES`` and runs every model
call of every rank under the mesh -- the encoder and decoder on their
heads, ``generate``/``beam_search`` with ``mesh=``. int4 blocks stay whole
(kernel K9 runs whole on each rank; such a block's caches hold all heads).
The speculative-draft shortcut is off under a mesh, as in JAX. Word
timestamps run the alignment pass on each rank's heads and sum the head
maps over 'model' (``infer/align.py``).
"""

from __future__ import annotations

import csv
import os
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.infer.align import (APPEND_PUNCTUATIONS,
                                     PREPEND_PUNCTUATIONS, WordTiming,
                                     cross_attention_weights, word_timings)
from audax_torch.infer.beam import beam_search
from audax_torch.infer.decode import GenerateResult, TimestampRules, generate
from audax_torch.infer.speculative import generate_speculative
from audax_torch.infer.vad import is_silent
from audax_torch.models.quantize import quantize_tree
from audax_torch.models.whisper import (decode_step, encode, init_kv_cache,
                                        local_heads, precompute_cross_kv,
                                        tree_map)
from audax_torch.ops import native
from audax_torch.parallel.mesh import use_mesh
from audax_torch.parallel.sharding import shard_params
from audax_torch.symbolic.tokenizer import WhisperTokenizer

__all__ = ["Transcriber", "TranscriptionResult", "Segment",
           "compression_ratio", "detect_language", "hallucination_filter",
           "batch_transcribe_to_csv"]

log = get_logger("audax_torch.infer")

FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
LOGPROB_THRESHOLD = -1.0
COMPRESSION_THRESHOLD = 2.4



def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# ------------------------------------------- hallucination heuristics -----
# openai-whisper transcribe.py's word_anomaly_score / is_segment_anomaly /
# silence-skip logic, as pure functions over Segment lists

def _word_anomaly_score(w: WordTiming) -> float:
    score = 0.0
    if w.probability < 0.15:
        score += 1.0
    dur = w.end - w.start
    if dur < 0.133:
        score += (0.133 - dur) * 15
    if dur > 2.0:
        score += dur - 2.0
    return score


def _is_segment_anomaly(seg: Optional["Segment"]) -> bool:
    if seg is None or not seg.words:
        return False
    punct = PREPEND_PUNCTUATIONS + APPEND_PUNCTUATIONS
    ws = [w for w in seg.words if w.word not in punct][:8]
    if not ws:
        return False
    score = sum(_word_anomaly_score(w) for w in ws)
    return score >= 3 or score + 0.01 >= len(ws)


def hallucination_filter(seg_i: List["Segment"], *, offset: float,
                         window_end: float, total_s: float,
                         threshold: float, last_speech_ts: float
                         ) -> Tuple[List["Segment"], Optional[float]]:
    """openai's hallucination_silence_threshold window pass.

    ``seg_i`` is one window's segments (absolute times, words attached).
    Returns (segments to keep, forced next-seek time in seconds or None):
    an anomalous first segment preceded by more than ``threshold`` of
    silence skips the window to the speech onset; an anomalous segment
    surrounded by silence (or more anomalies) truncates the window's output
    and re-seeks to its start so the next window re-reads that audio."""
    first = next((s for s in seg_i if s.words), None)
    if first is not None and _is_segment_anomaly(first):
        gap = first.start - offset
        if gap > threshold:
            return [], offset + gap
    kept = list(seg_i)
    hal_last_end = last_speech_ts
    for si, seg in enumerate(kept):
        if not seg.words:
            continue
        if _is_segment_anomaly(seg):
            nxt = next((s for s in kept[si + 1:] if s.words), None)
            hal_next_start = nxt.words[0].start if nxt else window_end
            silence_before = (seg.start - hal_last_end > threshold
                              or seg.start < threshold
                              or seg.start - offset < 2.0)
            silence_after = (hal_next_start - seg.end > threshold
                             or _is_segment_anomaly(nxt)
                             or window_end - seg.end < 2.0)
            if silence_before and silence_after:
                forced = max(offset + 1.0, seg.start)
                if total_s - seg.end < threshold:
                    forced = total_s       # nothing worth re-reading
                return kept[:si], forced
        hal_last_end = seg.words[-1].end
    return kept, None


@dataclass
class Segment:
    text: str
    start: float                 # seconds (chunk offset included)
    end: float
    avg_logprob: float
    temperature: float
    #: word timings (filled when Transcriber(word_timestamps=True))
    words: Optional[List[WordTiming]] = None
    #: per-window quality diagnostics: gzip compression ratio of the
    #: window's text and the <|nospeech|> probability at <|sot|> (None on
    #: the beam and speculative paths, which do not record it)
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


@torch.inference_mode()
def detect_language(params, cfg: WhisperConfig, tokenizer: WhisperTokenizer,
                    enc: torch.Tensor, dtype=torch.float32):
    """Language id from one decode step after SOT (whisper's
    detect_language): softmax restricted to the language tokens.

    Returns (lang_code [B] list, probs [B, n_languages])."""
    b = enc.shape[0]
    cross_kv = precompute_cross_kv(params, cfg, enc)
    cache = init_kv_cache(cfg, b, 2, dtype, device=enc.device,
                          heads=local_heads(params, cfg))
    sot = torch.full((b,), tokenizer.sot, dtype=torch.long, device=enc.device)
    logits, _ = decode_step(params, cfg, sot, 0, cache, cross_kv, dtype)
    langs = tokenizer.languages          # 99- or 100-language layout
    first = tokenizer.lang_token(langs[0])
    probs = torch.softmax(
        logits[:, first: first + tokenizer.num_languages].float(), -1)
    return [langs[i] for i in probs.argmax(-1).tolist()], probs


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
                 spec_tokens: int = 8,
                 quantize=False, kv_quant: bool = False, mesh=None,
                 clip_timestamps=None,
                 hallucination_silence_threshold: Optional[float] = None,
                 prepend_punctuations: str = PREPEND_PUNCTUATIONS,
                 append_punctuations: str = APPEND_PUNCTUATIONS,
                 seek_by_timestamps: bool = False,
                 vad_threshold_db: Optional[float] = None):
        if task not in ("transcribe", "translate"):
            raise ValueError(f"task must be transcribe/translate, got {task!r}")
        if best_of < 1:
            raise ValueError(f"best_of must be >= 1, got {best_of}")
        if hallucination_silence_threshold is not None and not (
                word_timestamps and timestamps):
            raise ValueError("hallucination_silence_threshold requires "
                             "word_timestamps=True and timestamps=True "
                             "(openai transcribe contract)")
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
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(params, mesh, heads=cfg.heads)
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
        #: beam search at t = 0 (openai transcribe(beam_size=K)); its FCFS
        #: finished pool holds round(W * patience); length_penalty is the
        #: GNMT exponent (None: rank by 1/length)
        self.beam_width = beam_width
        self.patience = patience
        self.length_penalty = length_penalty
        #: samples per window on the t > 0 rungs, the ranker's best kept
        self.best_of = best_of
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        #: (draft_params, draft_cfg): draft-verified greedy on one window
        #: at a time (speculative decoding), token-exact in exact arithmetic
        self.draft = (None if draft is None else
                      (tree_map(lambda t: t.detach(), draft[0]), draft[1]))
        self.spec_tokens = spec_tokens
        #: openai's seek loop: each window starts at the last complete
        #: segment's end (needs timestamps)
        self.seek_by_timestamps = seek_by_timestamps
        #: "start,end,..." seconds (or a list): only these ranges
        self.clip_timestamps = clip_timestamps
        self.hallucination_silence_threshold = hallucination_silence_threshold
        #: energy VAD: a window whose peak 100 ms RMS is below this dBFS
        #: level is silence, answered without a decode (None: off)
        self.vad_threshold_db = vad_threshold_db
        self.dtype = dtype
        self.frontend = LogMelFrontend.whisper(cfg.n_mels, device=self.device)
        self.draft_frontend = (
            LogMelFrontend.whisper(draft[1].n_mels, device=self.device)
            if draft is not None and draft[1].n_mels != cfg.n_mels else None)
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
                     temperature: float, denc: Optional[torch.Tensor] = None
                     ) -> GenerateResult:
        tk = self.tokenizer
        rules = (TimestampRules(tk.timestamp_begin, tk.eot)
                 if self.timestamps else None)
        max_len = min(prompt.shape[1] + self.max_new_tokens,
                      self.cfg.n_text_ctx)
        prompt_t = torch.from_numpy(prompt).to(self.device)
        common = dict(eos_id=tk.eot, suppress=self.suppress,
                      first_suppress=self.first_suppress, dtype=self.dtype,
                      kv_quant=self.kv_quant)
        if (denc is not None and temperature == 0.0 and rules is None
                and self.beam_width == 1 and enc.shape[0] == 1
                and self.mesh is None):
            # draft-verified greedy; the last verify span (start
            # max_len - 1) must still have spec_tokens position rows
            max_len = min(max_len,
                          min(self.cfg.n_text_ctx, self.draft[1].n_text_ctx)
                          - self.spec_tokens + 1)
            return generate_speculative(
                self.draft[0], self.params, self.draft[1], self.cfg, denc,
                enc, prompt_t, max_len=max_len,
                spec_tokens=self.spec_tokens, **common)
        if self.beam_width > 1 and temperature == 0.0:
            # whisper's ladder: beam at t = 0, sampling on hotter retries
            res = beam_search(self.params, self.cfg, enc, prompt_t,
                              max_len=max_len, beam_width=self.beam_width,
                              timestamps=rules, patience=self.patience,
                              length_penalty=self.length_penalty,
                              mesh=self.mesh, **common)
            lengths = res.lengths[:, 0]
            gen_count = torch.clamp_min(lengths - prompt.shape[1], 1)
            return GenerateResult(res.tokens[:, 0], lengths,
                                  res.sum_logprob[:, 0], gen_count)
        ns_id = tk.no_speech if self.no_speech_threshold is not None else None
        # openai reads no_speech_prob from the logits AT <|sot|>
        ns_pos = (int(np.where(prompt[0] == tk.sot)[0][-1])
                  if ns_id is not None else None)
        bo = self.best_of if temperature > 0.0 else 1
        kw = dict(max_len=max_len, temperature=temperature,
                  timestamps=rules, no_speech_id=ns_id, no_speech_pos=ns_pos,
                  mesh=self.mesh, **common)
        if bo == 1:
            return generate(self.params, self.cfg, enc, prompt_t, **kw)
        # best-of: each window tiled bo times (every row draws its own
        # samples from the generator), the ranker's best kept
        out = generate(self.params, self.cfg, enc.repeat_interleave(bo, 0),
                       prompt_t.repeat_interleave(bo, 0), **kw)
        n = enc.shape[0]
        gen_count = np.maximum(out.gen_count.cpu().numpy(), 1)
        sum_lp = out.sum_logprob.cpu().numpy()
        if self.length_penalty is None:
            score = sum_lp / gen_count           # whisper avg-logprob ranker
        else:
            score = sum_lp / ((5.0 + gen_count) / 6.0) ** self.length_penalty
        pick = torch.from_numpy(score.reshape(n, bo).argmax(1)
                                + np.arange(n) * bo).to(self.device)
        nsp = (out.no_speech_prob[pick]
               if out.no_speech_prob is not None else None)
        return GenerateResult(out.tokens[pick], out.lengths[pick],
                              out.sum_logprob[pick], out.gen_count[pick], nsp)

    def _align_words(self, enc_row: torch.Tensor, prompt_len: int,
                     prompt_and_ids: List[int],
                     n_valid_samples: int) -> List[WordTiming]:
        """Word timings for one window by cross-attention DTW. The tokens
        are padded with EOT to the fixed decode length, as the JAX package
        pads them (the z-normalisation runs across all of them)."""
        max_len = min(prompt_len + self.max_new_tokens, self.cfg.n_text_ctx)
        n_ids = len(prompt_and_ids) - prompt_len
        toks = (list(prompt_and_ids) + [self.tokenizer.eot] * max_len)[:max_len]
        n_frames = max(1, min(n_valid_samples
                              // (2 * self.frontend.cfg.hop_length),
                              enc_row.shape[0]))
        with use_mesh(self.mesh):
            w, mass = cross_attention_weights(
                self.params, self.cfg,
                torch.tensor([toks], dtype=torch.long, device=self.device),
                enc_row[None], n_frames=n_frames, dtype=self.dtype)
        # each token's row is the attention at its own input position
        # (openai-whisper find_alignment slicing); one host copy of them
        sl = slice(prompt_len, prompt_len + n_ids)
        return word_timings(w[0, sl].cpu().numpy(),
                            prompt_and_ids[prompt_len:], self.tokenizer,
                            n_frames=n_frames, mass=mass[0, sl].cpu().numpy(),
                            prepend_punctuations=self.prepend_punctuations,
                            append_punctuations=self.append_punctuations)

    def _attach_words(self, segments: List[Segment],
                      words: List[WordTiming], offset: float) -> None:
        """Distribute a window's words into its segments by midpoint time;
        a word aligned outside every segment span goes to the NEAREST
        segment rather than vanishing."""
        shifted = [WordTiming(w.word, round(w.start + offset, 3),
                              round(w.end + offset, 3), w.probability)
                   for w in words]
        if not self.timestamps or not segments:
            for seg in segments:
                seg.words = shifted
            return
        for seg in segments:
            seg.words = []
        for w in shifted:
            mid = (w.start + w.end) / 2
            inside = [s for s in segments if s.start <= mid < s.end]
            target = inside[0] if inside else min(
                segments, key=lambda s: min(abs(mid - s.start),
                                            abs(mid - s.end)))
            target.words.append(w)

    @torch.inference_mode()
    def warmup(self, *, batch_chunks: int = 4) -> None:
        """Build the CUDA kernels (on a CUDA device) and run one dummy
        window group through the frontend, encoder and t = 0 decode (beam
        search when ``beam_width > 1``)."""
        if self.device.type == "cuda":
            native.build()
        mel = self.frontend(torch.zeros(batch_chunks, self.chunk_samples,
                                        device=self.device))
        with use_mesh(self.mesh):
            enc = encode(self.params, self.cfg, mel, self.dtype)
        self._decode_once(enc, self._prompt(batch_chunks), 0.0)

    @torch.inference_mode()
    def _decode_windows(self, audio_chunks: np.ndarray,
                        prev: Optional[List[int]] = None,
                        lang: Optional[str] = None):
        """[N, chunk_samples] -> (per-window (token ids, avg_logprob, temp,
        compression ratio, no-speech prob) via the fallback ladder, encoder
        states [N, S, d] for the word alignment)."""
        mel = self.frontend(audio_chunks)
        with use_mesh(self.mesh):
            enc = encode(self.params, self.cfg, mel, self.dtype)
        n = len(audio_chunks)
        denc = None
        if self.draft is not None and n == 1:
            dmel = (self.draft_frontend(audio_chunks)
                    if self.draft_frontend is not None else mel)
            denc = encode(self.draft[0], self.draft[1], dmel, self.dtype)
        prompt = self._prompt(n, prev, lang)
        p = prompt.shape[1]
        tk = self.tokenizer
        results: List[Optional[tuple]] = [None] * n
        pending = list(range(n))
        ladder = (self.temperatures if self.temperature_fallback
                  else (self.temperatures[0],))
        draft_kw = {} if denc is None else {"denc": denc}
        for ti, temp in enumerate(ladder):
            if not pending:
                break
            # fixed batch: unfinished windows first, duplicates after
            idx = pending + [pending[0]] * (n - len(pending))
            out = self._decode_once(enc[torch.tensor(idx, device=enc.device)],
                                    prompt, temp, **draft_kw)
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
        return results, enc

    def _decode_chunk_batch(self, audio_chunks: np.ndarray,
                            prev: Optional[List[int]] = None,
                            lang: Optional[str] = None):
        """``_decode_windows`` without the encoder states."""
        return self._decode_windows(audio_chunks, prev, lang)[0]

    def _parse_clips(self, total_s: float) -> List[Tuple[float, float]]:
        """openai clip_timestamps: comma-separated (or a list of) seconds,
        consumed as start,end pairs; a missing last end means end of file.
        Ranges clamp to the audio and must be non-overlapping ascending."""
        raw = self.clip_timestamps
        if isinstance(raw, str):
            vals = [float(v) for v in raw.split(",") if v.strip()]
        else:
            vals = [float(v) for v in raw]
        if not vals:
            return [(0.0, total_s)]
        if len(vals) % 2:
            vals.append(total_s)
        if any(b < a for a, b in zip(vals, vals[1:])):
            raise ValueError(f"clip_timestamps must be ascending "
                             f"non-overlapping pairs, got {raw!r}")
        pairs = []
        for s, e in zip(vals[::2], vals[1::2]):
            s = max(min(s, total_s), 0.0)
            e = max(min(e, total_s), 0.0)
            if e > s:
                pairs.append((s, e))
        return pairs or [(0.0, total_s)]

    @torch.inference_mode()
    def detect(self, audio: np.ndarray) -> Tuple[str, Dict[str, float]]:
        """Language id over the first window (whisper detect_language):
        returns (best code, {code: probability})."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        first = audio[: self.chunk_samples]
        if len(first) < self.chunk_samples:
            first = np.pad(first, (0, self.chunk_samples - len(first)))
        with use_mesh(self.mesh):
            enc0 = encode(self.params, self.cfg, self.frontend(first[None]),
                          self.dtype)
            detected, probs = detect_language(self.params, self.cfg,
                                              self.tokenizer, enc0,
                                              self.dtype)
        row = probs[0].double().cpu().numpy()
        return detected[0], {c: float(p)
                             for c, p in zip(self.tokenizer.languages, row)}

    @torch.inference_mode()
    def transcribe(self, audio: np.ndarray, *, batch_chunks: int = 4
                   ) -> TranscriptionResult:
        """audio: 1-D float waveform at 16 kHz, split into windows."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        t0 = time.perf_counter()
        sr = self.frontend.cfg.sample_rate
        total_s = len(audio) / sr
        lang = self.lang
        if lang == "auto":
            # local to this call: a reused Transcriber re-detects per file
            lang, _ = self.detect(audio)
            log.info("detected language: %s", lang)
        if self.clip_timestamps:
            segments = []
            for cs, ce in self._parse_clips(total_s):
                sub = audio[int(cs * sr): int(ce * sr)]
                for s in self._transcribe_segments(sub, batch_chunks, lang):
                    s.start = round(s.start + cs, 3)
                    s.end = round(s.end + cs, 3)
                    if s.words:
                        s.words = [WordTiming(w.word, round(w.start + cs, 3),
                                              round(w.end + cs, 3),
                                              w.probability)
                                   for w in s.words]
                    segments.append(s)
        else:
            segments = self._transcribe_segments(audio, batch_chunks, lang)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return TranscriptionResult(
            text="".join(s.text for s in segments).strip(),
            segments=segments, audio_seconds=total_s, wall_seconds=wall)

    def _is_silent(self, chunk: np.ndarray) -> bool:
        """Energy VAD over one window (``infer/vad.py``); False when off."""
        if self.vad_threshold_db is None:
            return False
        return is_silent(chunk, self.frontend.cfg.sample_rate,
                         self.vad_threshold_db)

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
        """Windowed decode of one contiguous waveform -> Segments with times
        relative to ``audio``'s start (``transcribe`` adds clip offsets)."""
        n = len(audio)
        sr = self.frontend.cfg.sample_rate
        tk = self.tokenizer
        segments: List[Segment] = []
        seq_mode = self.condition_on_previous or (
            self.timestamps and self.seek_by_timestamps) or (
            self.hallucination_silence_threshold is not None)
        if seq_mode:
            # openai's seek loop: each window's prompt carries the previous
            # text (reset after a high-temperature fallback), and with
            # seek_by_timestamps the next window starts at the last
            # COMPLETE segment's end instead of a fixed stride
            prev: List[int] = list(self.initial_prompt_ids)
            seek = 0
            last_speech = 0.0          # hallucination filter's speech cursor
            while seek < max(n, 1):
                chunk = audio[seek: seek + self.chunk_samples]
                valid = len(chunk)
                if valid < self.chunk_samples:
                    chunk = np.pad(chunk, (0, self.chunk_samples - valid))
                if self._is_silent(chunk):
                    # silence advances the seek (and leaves the rolling
                    # context untouched) without a decode
                    seek += self.chunk_samples
                    if n == 0:
                        break
                    continue
                res_one, enc1 = self._decode_windows(chunk[None], prev=prev,
                                                     lang=lang)
                ids, avg_lp, temp, cr, nsv = res_one[0]
                prompt_row = [int(t) for t in self._prompt(1, prev, lang)[0]]
                offset = seek / sr
                seg_i = self._window_segments(ids, offset, avg_lp, temp, cr,
                                              nsv)
                if self.word_timestamps and ids:
                    self._attach_words(
                        seg_i, self._align_words(enc1[0], len(prompt_row),
                                                 prompt_row + ids, valid),
                        offset)
                forced_seek: Optional[float] = None
                dropped = False
                thr = self.hallucination_silence_threshold
                if thr is not None and self.word_timestamps:
                    window_end = offset + valid / sr
                    n_before = len(seg_i)
                    seg_i, forced_seek = hallucination_filter(
                        seg_i, offset=offset, window_end=window_end,
                        total_s=n / sr, threshold=thr,
                        last_speech_ts=last_speech)
                    dropped = len(seg_i) < n_before
                    word_ends = [w.end for s in seg_i
                                 for w in (s.words or [])]
                    if word_ends:
                        last_speech = max(last_speech, word_ends[-1])
                        # trailing-silence skip: re-seek to the last spoken
                        # word instead of past > threshold of silence
                        if (forced_seek is None
                                and valid == self.chunk_samples
                                and window_end - word_ends[-1] > thr):
                            forced_seek = word_ends[-1]
                if self.condition_on_previous:
                    # the rolling context takes only SURVIVING segments
                    if temp > 0.5:
                        prev = []
                    elif dropped:
                        prev = prev + tk.encode(
                            "".join(s.text for s in seg_i))
                    else:
                        prev = prev + [t for t in ids
                                       if not tk.is_timestamp(t)]
                segments.extend(seg_i)
                advance = self.chunk_samples
                if forced_seek is not None:
                    # a floor of 1 s guarantees forward progress
                    advance = max(int(forced_seek * sr) - seek, sr)
                elif (self.timestamps and self.seek_by_timestamps and seg_i
                        and valid == self.chunk_samples):
                    last_end = max(s.end for s in seg_i) - offset
                    if 1.0 <= last_end < self.chunk_seconds:
                        advance = int(last_end * sr)
                seek += advance
                if n == 0:
                    break
        else:
            chunks = []
            for start in range(0, max(n, 1), self.chunk_samples):
                chunk = audio[start: start + self.chunk_samples]
                if len(chunk) < self.chunk_samples:
                    chunk = np.pad(chunk, (0, self.chunk_samples - len(chunk)))
                chunks.append(chunk)
            init_ctx = self.initial_prompt_ids or None
            prompt_row = [int(t) for t in self._prompt(1, init_ctx, lang)[0]]
            # energy VAD: silent windows never reach the device (their index
            # gap keeps surviving windows at their true offsets)
            speech = [(k, ch) for k, ch in enumerate(chunks)
                      if not self._is_silent(ch)]
            for i in range(0, len(speech), batch_chunks):
                part = speech[i: i + batch_chunks]
                n_valid = len(part)
                group = np.stack([ch for _, ch in part]
                                 + [part[-1][1]] * (batch_chunks - n_valid))
                res, enc = self._decode_windows(group, prev=init_ctx,
                                                lang=lang)
                for j, (ids, avg_lp, temp, cr, nsv) in enumerate(
                        res[:n_valid]):
                    k = part[j][0]
                    offset = k * self.chunk_seconds
                    seg_i = self._window_segments(ids, offset, avg_lp, temp,
                                                  cr, nsv)
                    if self.word_timestamps and ids:
                        valid = min(n - k * self.chunk_samples,
                                    self.chunk_samples)
                        self._attach_words(
                            seg_i, self._align_words(enc[j], len(prompt_row),
                                                     prompt_row + ids, valid),
                            offset)
                    segments.extend(seg_i)
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


def batch_transcribe_to_csv(
    transcriber: Transcriber, wav_paths: Sequence[str],
    csv_path: Optional[str],
    *, write_sidecars: bool = True,
    previous: Optional[dict] = None,
    output_format: Optional[str] = None,
    output_dir: Optional[str] = None,
    writer_opts: Optional[dict] = None,
    verbose: bool = False) -> List[dict]:
    """Transcribe a set of WAV files; write per-file .txt sidecars and a
    summary CSV (the reference's transcriptions.csv artifacts,
    AB/wavToWhisper.py:85-103). ``previous`` maps filename -> prior
    transcription for before/after comparison columns.

    ``output_format`` ('txt'/'srt'/'vtt'/'tsv'/'json'/'all') also emits
    per-file transcripts into ``output_dir`` (default: beside the CSV)
    through ``infer/writers.py``; ``writer_opts`` forwards the subtitle
    line options. ``csv_path`` None writes no CSV (with
    ``write_sidecars=False`` and no ``output_format``, no file at all: the
    ranks but 0 of a mesh). Files are read by ``read_audio`` (WAV, or a
    compressed
    container through the native decoder, where the JAX package reads WAV
    only); an unreadable file gets a row with its error."""
    from audax_torch.data.audio_io import read_audio, resample, to_mono
    from audax_torch.infer.writers import _ts, get_writer

    writer = None
    if output_format:
        writer = get_writer(output_format,
                            output_dir or os.path.dirname(csv_path) or ".")
    rows = []
    sr = transcriber.frontend.cfg.sample_rate
    for path in wav_paths:
        try:
            x, rate = read_audio(path)
            x = to_mono(x)
            if rate != sr:
                x = resample(x, rate, sr)
            result = transcriber.transcribe(x)
            row = {"file": os.path.basename(path), "text": result.text,
                   "rtf": round(result.rtf, 4)}
            if previous:
                row["previous"] = previous.get(os.path.basename(path), "")
            rows.append(row)
            if write_sidecars:
                with open(os.path.splitext(path)[0] + ".txt", "w") as fh:
                    fh.write(result.text + "\n")
            if writer is not None:
                writer(result, path, **(writer_opts or {}))
            if verbose:
                # openai CLI's live segment lines
                print(os.path.basename(path))
                for seg in result.segments:
                    print(f"[{_ts(seg.start, sep='.')} --> "
                          f"{_ts(seg.end, sep='.')}] {seg.text.strip()}")
        except Exception as e:     # one bad file must not end the batch
            log.warning("skip %s: %s", path, e)
            rows.append({"file": os.path.basename(path), "text": "",
                         "rtf": -1.0, "error": str(e)})
    if rows and csv_path is not None:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        keys = sorted({k for r in rows for k in r})
        with open(csv_path, "w", newline="") as fh:
            out = csv.DictWriter(fh, fieldnames=keys)
            out.writeheader()
            out.writerows(rows)
    return rows
