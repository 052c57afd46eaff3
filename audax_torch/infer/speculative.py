"""Speculative decoding (port of ``audax/infer/speculative.py``:
``generate_speculative``): a small draft Whisper proposes K tokens per
pass; the target model verifies all K in ONE ``decode_span`` pass.

Single-stream greedy decode is bandwidth bound: every token re-reads the
whole decoder for one row. Here the target's weight read is shared by the
K rows of its verify span (K3 at K query rows, chunked by its wrapper
above 16), and the cheap draft runs the sequential part.

Token-exactness: every accepted token is the TARGET's own greedy argmax
given the accepted prefix -- the draft only decides how many arrive per
pass -- so tokens, lengths and scores match ``generate(temperature=0)``.
That holds in exact arithmetic; on the card the K-row verify products and
the 1-row step take different shapes, so a near-tie of the top two logits
can flip an argmax. Rejected-branch cache rows heal: ``decode_span``
writes its slots before it attends (``models/whisper.py``), in the
draft's cache as in the target's.

The JAX ``lax.while_loop`` is a Python loop here, with one host read a
pass (how many tokens were accepted, and whether one was EOT). B = 1 only:
this is the latency path; throughput comes from batched serving.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.infer.decode import NEG_INF, GenerateResult
from audax_torch.models.whisper import (decode_span, decode_step,
                                        init_kv_cache, precompute_cross_kv)

__all__ = ["generate_speculative"]


@torch.inference_mode()
def generate_speculative(draft_params, params, draft_cfg: WhisperConfig,
                         cfg: WhisperConfig, draft_enc: torch.Tensor,
                         enc: torch.Tensor, prompt: torch.Tensor, *,
                         max_len: int, eos_id: int, spec_tokens: int = 8,
                         suppress: Optional[torch.Tensor] = None,
                         first_suppress: Optional[torch.Tensor] = None,
                         dtype=torch.float32, draft_dtype=None,
                         kv_quant: bool = False,
                         accepted: Optional[List[int]] = None
                         ) -> GenerateResult:
    """Greedy decode, token-exact vs ``generate(temperature=0)``.

    draft_enc [1, S, d_draft] and enc [1, S, d] are the two encoders'
    states, prompt [1, P]. ``first_suppress`` (SuppressBlank) applies at
    absolute position P in both draft and target. ``kv_quant``: int8
    caches for the target (the draft keeps float ones). ``accepted``, when
    given, receives the number of tokens each pass accepted."""
    device = enc.device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, p_len = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding is the B=1 latency path")
    if p_len >= max_len:
        raise ValueError("max_len must exceed the prompt length")
    if max_len - 1 + spec_tokens > min(cfg.n_text_ctx, draft_cfg.n_text_ctx):
        # the last verify span starts at max_len - 1 and reads K rows of
        # the position table
        raise ValueError(
            f"max_len={max_len} + spec_tokens={spec_tokens} overruns the "
            f"position table (n_text_ctx={cfg.n_text_ctx}); cap max_len at "
            f"n_text_ctx - spec_tokens + 1")
    kk = spec_tokens
    draft_dtype = draft_dtype or dtype
    if suppress is not None:
        suppress = torch.as_tensor(suppress, dtype=torch.long, device=device)
    if first_suppress is not None:
        first_suppress = torch.as_tensor(first_suppress, dtype=torch.long,
                                         device=device)

    t_ckv = precompute_cross_kv(params, cfg, enc, quant=kv_quant)
    d_ckv = precompute_cross_kv(draft_params, draft_cfg, draft_enc)
    buf = max_len + kk             # span and draft writes never clip
    t_cache = init_kv_cache(cfg, 1, buf, dtype, device=device, quant=kv_quant)
    d_cache = init_kv_cache(draft_cfg, 1, buf, draft_dtype, device=device)
    tokens = torch.zeros(1, buf, dtype=torch.long, device=device)
    tokens[:, :p_len] = prompt

    def constrain(logits: torch.Tensor, first_row: Optional[int]):
        """Suppression on [1, V] (draft) or [1, K, V] (verify) logits;
        ``first_row`` indexes the row that produces position P (None when
        no row does)."""
        logits = logits.float()
        if suppress is not None and suppress.numel():
            logits[..., suppress] = NEG_INF
        if (first_row is not None and first_suppress is not None
                and first_suppress.numel()):
            if logits.dim() == 3:
                logits[:, first_row, first_suppress] = NEG_INF
            else:
                logits[:, first_suppress] = NEG_INF
        return logits

    # prefill positions 0..P-2; the last prompt token is fed by the first
    # pass (invariant: the caches hold positions 0..l-2)
    if p_len > 1:
        decode_span(params, cfg, prompt[:, : p_len - 1], 0, t_cache, t_ckv,
                    dtype)
        decode_span(draft_params, draft_cfg, prompt[:, : p_len - 1], 0,
                    d_cache, d_ckv, draft_dtype)

    idx = torch.arange(kk, device=device)
    sum_logprob = torch.zeros(1, device=device)
    l, gen_count, length = p_len, 0, max_len
    while l < max_len:
        cur = tokens[:, l - 1]                                      # [1]
        # -- draft: K sequential cheap steps (no host read) --------------
        tok, proposals = cur, []
        for i in range(kk):
            pos = l - 1 + i
            logits, d_cache = decode_step(draft_params, draft_cfg, tok, pos,
                                          d_cache, d_ckv, draft_dtype)
            tok = constrain(logits, 0 if pos + 1 == p_len else None
                            ).argmax(-1)
            proposals.append(tok)
        d_vec = torch.cat(proposals)                                # [K]
        # -- target: verify all K in one span pass ------------------------
        span = torch.cat([cur, d_vec[: kk - 1]])[None]              # [1, K]
        tlogits, t_cache = decode_span(params, cfg, span, l - 1, t_cache,
                                       t_ckv, dtype)
        tlogits = constrain(tlogits, 0 if l == p_len else None)
        t_vec = tlogits.argmax(-1)[0]                               # [K]
        chosen = torch.log_softmax(tlogits[0], -1).gather(
            -1, t_vec[:, None])[:, 0]
        # -- acceptance: longest matching prefix + the bonus token --------
        lead = torch.cumprod((d_vec == t_vec).long(), 0).sum()
        a = torch.clamp(lead + 1, max=min(kk, max_len - l))
        is_eos = (t_vec == eos_id) & (idx < a)
        any_eos = is_eos.any()
        accept_n = torch.where(any_eos, is_eos.long().argmax() + 1, a)
        tokens[0, l: l + kk] = t_vec
        sum_logprob = sum_logprob + torch.where(idx < accept_n, chosen,
                                                0.0).sum()
        n, eos = torch.stack([accept_n, any_eos.long()]).tolist()
        if accepted is not None:
            accepted.append(n)
        gen_count += n
        l += n
        if eos:
            length = l
            break
    return GenerateResult(
        tokens[:, :max_len],
        torch.tensor([length], dtype=torch.long, device=device),
        sum_logprob,
        torch.tensor([gen_count], dtype=torch.long, device=device))
