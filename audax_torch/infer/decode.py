"""Autoregressive decoding with Whisper's timestamp rules (port of
``audax/infer/decode.py``: ``generate``, ``GenerateResult``,
``TimestampRules``, ``apply_timestamp_rules``).

``generate`` runs ``models/whisper.py:decode_step`` over a preallocated KV
cache: the prompt is teacher-forced through the same cached step, then
tokens are chosen greedily (temperature 0) or sampled from a seeded
``torch.Generator``. The JAX ``lax.while_loop`` becomes a Python loop that
stops once every row has emitted EOS (one host read of the ``done`` flags
per step). The sum of chosen-token log-probabilities is accumulated in the
loop, so the transcription layer can run the temperature-fallback ladder
without a second pass, and ``no_speech_prob`` is read from the raw logits
at the ``<|sot|>`` position before any constraint.

Timestamp rules (openai-whisper's ApplyTimestampRules, structural subset):
the first generated token must be a timestamp; timestamps come in pairs;
the opening timestamp counts as a completed pair; timestamps are
monotonically non-decreasing, and a new segment's opener strictly greater.

``kv_quant`` keeps the self- and cross-attention caches in int8 with
per-vector scales (``models/whisper.py:QuantKV``; K3's int8 arm on the
card). Tensor parallelism (``mesh``) arrives with a later slice of the
port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.models.whisper import (decode_step, init_kv_cache,
                                        precompute_cross_kv)

__all__ = ["generate", "GenerateResult", "TimestampRules",
           "apply_timestamp_rules"]

NEG_INF = torch.finfo(torch.float32).min


class TimestampRules(NamedTuple):
    """Static tokenizer facts needed to enforce whisper timestamp structure."""
    timestamp_begin: int
    eot_id: int


def apply_timestamp_rules(logits: torch.Tensor, rules: TimestampRules, *,
                          first: bool, prev_ts: torch.Tensor,
                          prevprev_ts: torch.Tensor,
                          last_ts: torch.Tensor) -> torch.Tensor:
    """Mask ``logits`` [B, V] per whisper's timestamp structure. ``first``
    marks the first generated position; the ``*_ts`` states are [B], with
    ``last_ts`` starting at ``timestamp_begin - 1`` (nothing emitted yet).

    State machine over the last two generated tokens: at the first position
    only a timestamp; mid pair (<text><ts>) the closing timestamp or EOT;
    after a pair (<ts><ts>, or the lone opener) text. Mid pair the closing
    timestamp may equal the opener; a new opener must be strictly greater
    than the last timestamp."""
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    is_ts_col = (vocab_ids >= rules.timestamp_begin)[None, :]
    is_eot_col = (vocab_ids == rules.eot_id)[None, :]
    mid_pair = prev_ts & ~prevprev_ts                     # [B]
    after_pair = prev_ts & prevprev_ts
    if first:
        ban = ~is_ts_col.expand_as(logits)
    else:
        ban = torch.where(mid_pair[:, None], ~is_ts_col & ~is_eot_col,
                          after_pair[:, None] & is_ts_col)
    min_ts = last_ts + torch.where(mid_pair, 0, 1)
    below = vocab_ids[None, :] < min_ts[:, None]
    ban = ban | (is_ts_col & below)
    return logits.masked_fill(ban, NEG_INF)


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_len] int64 (prompt + generated + pad)
    lengths: torch.Tensor      # [B] total valid length (incl. prompt)
    sum_logprob: torch.Tensor  # [B] float32 sum of chosen-token logprobs
    gen_count: torch.Tensor    # [B] number of generated (scored) tokens
    #: [B] softmax probability of <|nospeech|> at the <|sot|> position
    #: (None unless generate() was given no_speech_id)
    no_speech_prob: Optional[torch.Tensor] = None

    @property
    def avg_logprob(self) -> torch.Tensor:
        return self.sum_logprob / torch.clamp_min(self.gen_count, 1)


@torch.inference_mode()
def generate(params, cfg: WhisperConfig, enc: torch.Tensor,
             prompt: torch.Tensor, *, max_len: int, eos_id: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             suppress: Optional[torch.Tensor] = None,
             first_suppress: Optional[torch.Tensor] = None,
             timestamps: Optional[TimestampRules] = None,
             dtype=torch.float32,
             no_speech_id: Optional[int] = None,
             no_speech_pos: Optional[int] = None,
             kv_quant: bool = False) -> GenerateResult:
    """Decode until EOS or ``max_len``.

    enc [B, S, d] encoder states; prompt [B, P] forced prefix (the SOT
    sequence). ``suppress`` ids are never emitted; ``first_suppress`` ids
    are banned at the first generated position only (whisper's
    SuppressBlank). ``kv_quant``: int8 self- and cross-attention caches.
    Sampling (``temperature > 0``) draws from
    ``generator`` -- a fresh one seeded 0 on enc's device when None, so a
    call is deterministic for its seed."""
    device = enc.device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, p_len = prompt.shape
    cross_kv = precompute_cross_kv(params, cfg, enc, quant=kv_quant)
    cache = init_kv_cache(cfg, b, max_len, dtype, device=device,
                          quant=kv_quant)
    tokens = torch.zeros(b, max_len, dtype=torch.long, device=device)
    tokens[:, :p_len] = prompt
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if suppress is not None:
        suppress = torch.as_tensor(suppress, dtype=torch.long, device=device)
    if first_suppress is not None:
        first_suppress = torch.as_tensor(first_suppress, dtype=torch.long,
                                         device=device)
    ns_at = p_len - 1 if no_speech_pos is None else int(no_speech_pos)

    done = torch.zeros(b, dtype=torch.bool, device=device)
    lengths = torch.full((b,), max_len, dtype=torch.long, device=device)
    sum_logprob = torch.zeros(b, device=device)
    gen_count = torch.zeros(b, dtype=torch.long, device=device)
    # prev_ts starts True: the first generated token shifts it into
    # prevprev, so a lone opening timestamp reads as a completed pair
    # (openai's len(seq) < 2 => penultimate_was_timestamp)
    prev_ts = torch.ones(b, dtype=torch.bool, device=device)
    prevprev_ts = torch.ones(b, dtype=torch.bool, device=device)
    ts0 = timestamps.timestamp_begin - 1 if timestamps is not None else 0
    last_ts = torch.full((b,), ts0, dtype=torch.long, device=device)
    nsp = torch.zeros(b, device=device)

    for pos in range(max_len - 1):
        logits, cache = decode_step(params, cfg, tokens[:, pos], pos, cache,
                                    cross_kv, dtype)
        logits = logits.float()
        in_prompt = pos + 1 < p_len
        first = pos + 1 == p_len
        if no_speech_id is not None and pos == ns_at:
            nsp = torch.softmax(logits, -1)[:, no_speech_id]
        if in_prompt:
            continue        # teacher-forced: the next token is the prompt's
        if suppress is not None and suppress.numel():
            logits[:, suppress] = NEG_INF
        if first and first_suppress is not None and first_suppress.numel():
            logits[:, first_suppress] = NEG_INF
        if timestamps is not None:
            logits = apply_timestamp_rules(
                logits, timestamps, first=first, prev_ts=prev_ts,
                prevprev_ts=prevprev_ts, last_ts=last_ts)
        if temperature == 0.0:
            nxt = logits.argmax(-1)
        else:
            probs = torch.softmax(logits / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = torch.where(done, eos_id, nxt)
        tokens[:, pos + 1] = nxt

        chosen = torch.log_softmax(logits, -1).gather(1, nxt[:, None])[:, 0]
        score = ~done
        sum_logprob = sum_logprob + torch.where(score, chosen, 0.0)
        gen_count = gen_count + score.long()
        if timestamps is not None:
            is_ts = nxt >= timestamps.timestamp_begin
            prevprev_ts, prev_ts = prev_ts, is_ts
            last_ts = torch.where(is_ts, torch.maximum(last_ts, nxt), last_ts)
        newly_done = nxt == eos_id
        lengths = torch.where(newly_done & ~done, pos + 2, lengths)
        done = done | newly_done
        if bool(done.all()):
            break
    return GenerateResult(tokens, lengths, sum_logprob, gen_count,
                          nsp if no_speech_id is not None else None)
