"""Beam-search decoding (port of ``audax/infer/beam.py``: ``beam_search``,
``BeamResult``, ``_fcfs_partition``, ``_pool_slots``).

openai-whisper's ``transcribe(beam_size=K)`` path: beams live in the batch
dimension ([B*W] rows through the same KV-cached ``decode_step``, so each
step is one K3 launch per layer and attention kind at B*W rows). Finished
hypotheses follow openai's BeamSearchDecoder: a candidate ending in EOT
vacates its lane into a per-item finished pool and the lane is refilled
with the next-best live continuation, so the search always advances
``beam_width`` LIVE beams. The pool is first-come-first-served with
``round(beam_width * patience)`` slots: once full, later (even
better-scoring) finished candidates are dropped, and the loop exits when
every item's pool is full. Candidates still in flight at ``max_len`` pad
any pool holding fewer than ``beam_width`` in descending sum-logprob order
(openai's ``finalize``).

Within a step candidates are scanned best-first; an EOT candidate is
pooled iff it outranks the W-th live candidate. Each of the W source beams
proposes EOT at most once, so the top ``2W`` candidates hold the W live
continuations and every poolable EOT. Ranking is a STABLE descending sort
(the lower flat index first among equal scores, as ``lax.top_k`` and the
stable ``jnp.argsort`` give it): beams 1..W-1 start at ``finfo.min``, so
the first expansion is full of exact ties.

Hypotheses are ranked by sum-logprob / length, or by the GNMT penalty
``((5 + len) / 6) ** alpha`` when ``length_penalty`` is set (openai's
MaximumLikelihoodRanker); the top ``beam_width`` are returned.

The JAX ``lax.while_loop`` is a Python loop here, as in
``infer/decode.py:generate``: one host read a step (whether every pool is
full). The self-attention cache is written in place, so the reorder by
source beam gathers each cache tensor (the int8 codes and both scale
tensors of a ``QuantKV`` too) up to the current position and copies the
gather back; the cross-attention K/V is the same for every beam of an item
and is never reordered. Prompt steps only fill the cache: every lane holds
the same prompt, so no candidate is ranked until the first generated
position.

``mesh``: tensor parallelism over ``params``' TP blocks, as in
``infer/decode.py:generate``; items (with their beams) are cut over the
batch axes when they divide, and the results all-gathered.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.infer.decode import (NEG_INF, TimestampRules,
                                      apply_timestamp_rules, gather_rows)
from audax_torch.models.whisper import (decode_step, init_kv_cache,
                                        local_heads, precompute_cross_kv)
from audax_torch.parallel.mesh import use_mesh
from audax_torch.parallel.sharding import kv_rows

__all__ = ["beam_search", "BeamResult"]


class BeamResult(NamedTuple):
    tokens: torch.Tensor       # [B, W, max_len] best-first
    lengths: torch.Tensor      # [B, W]
    scores: torch.Tensor       # [B, W] length-normalised or GNMT score
    sum_logprob: torch.Tensor  # [B, W] raw sum of token logprobs


def _fcfs_partition(top_idx: torch.Tensor, v: int, eos_id: int, w: int):
    """Classify the 2W best-first candidates openai-style.

    Returns (is_live, lane, is_pooled, pool_rank): ``is_live[b, j]`` for
    the first W non-EOT candidates (live lane ``lane[b, j]``);
    ``is_pooled[b, j]`` for an EOT candidate ahead of the W-th live one;
    ``pool_rank[b, j]`` its insertion order among this step's pooled
    candidates (exclusive count, best-first)."""
    is_eot = (top_idx % v) == eos_id
    live = (~is_eot).long()
    nonfin_before = torch.cumsum(live, -1) - live          # exclusive
    before_break = nonfin_before < w
    is_live = ~is_eot & before_break
    is_pooled = is_eot & before_break
    pooled = is_pooled.long()
    pool_rank = torch.cumsum(pooled, -1) - pooled
    return is_live, nonfin_before, is_pooled, pool_rank


def _pool_slots(is_pooled: torch.Tensor, pool_rank: torch.Tensor,
                cnt: torch.Tensor, m: int):
    """FCFS slot assignment for one step's pooled candidates: candidate j
    appends at ``cnt + pool_rank[j]``; a slot >= m is dropped, returned as
    the sentinel ``m`` (a full pool never evicts). Returns (slots,
    inserted mask)."""
    slot = cnt[:, None] + pool_rank
    ok = is_pooled & (slot < m)
    return torch.where(ok, slot, torch.full_like(slot, m)), ok


def _reorder_cache(cache, src: torch.Tensor, n: int) -> None:
    """Gather the cache's beam rows by ``src`` over positions < ``n`` and
    copy the gather back in place. Advanced indexing materialises the
    gathered rows before the write, so no row is read after it is
    overwritten."""
    for t in cache:
        t[:, :, :, :n] = t[:, src, :, :n]


@torch.inference_mode()
def beam_search(params, cfg: WhisperConfig, enc: torch.Tensor,
                prompt: torch.Tensor, *, max_len: int, eos_id: int,
                beam_width: int = 5,
                suppress: Optional[torch.Tensor] = None,
                first_suppress: Optional[torch.Tensor] = None,
                timestamps: Optional[TimestampRules] = None,
                dtype=torch.float32, kv_quant: bool = False,
                patience: Optional[float] = None,
                length_penalty: Optional[float] = None,
                mesh=None) -> BeamResult:
    """enc [B, S, d], prompt [B, P] forced prefix -> ``BeamResult``.
    ``first_suppress`` ids are banned at the first generated position only
    (whisper's SuppressBlank); ``kv_quant`` keeps int8 self- and
    cross-attention caches; ``mesh``: tensor parallelism (module
    docstring)."""
    if patience is not None and patience < 1.0:
        raise ValueError(f"patience must be >= 1.0, got {patience}")
    if mesh is not None:
        rows = kv_rows(mesh, enc.shape[0])
        prompt = torch.as_tensor(prompt, device=enc.device)
        with use_mesh(mesh):
            out = beam_search(
                params, cfg, enc if rows is None else enc[rows],
                prompt if rows is None else prompt[rows], max_len=max_len,
                eos_id=eos_id, beam_width=beam_width, suppress=suppress,
                first_suppress=first_suppress, timestamps=timestamps,
                dtype=dtype, kv_quant=kv_quant, patience=patience,
                length_penalty=length_penalty)
        return out if rows is None else gather_rows(mesh, out)
    device = enc.device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, p_len = prompt.shape
    w = beam_width
    m = max(w, int(round(w * (patience or 1.0))))     # finished-pool slots
    bw, k2 = b * w, 2 * w
    if suppress is not None:
        suppress = torch.as_tensor(suppress, dtype=torch.long, device=device)
    if first_suppress is not None:
        first_suppress = torch.as_tensor(first_suppress, dtype=torch.long,
                                         device=device)

    cross_kv = precompute_cross_kv(params, cfg, enc.repeat_interleave(w, 0),
                                   quant=kv_quant)
    cache = init_kv_cache(cfg, bw, max_len, dtype, device=device,
                          quant=kv_quant, heads=local_heads(params, cfg))
    tokens = torch.zeros(bw, max_len, dtype=torch.long, device=device)
    tokens[:, :p_len] = prompt.repeat_interleave(w, 0)
    # beam 0 starts live; the others at -inf so the first expansion fans out
    scores = torch.full((b, w), NEG_INF, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    # timestamp-rule carries; prev_ts starts True (openai's len(seq) < 2)
    prev_ts = torch.ones(bw, dtype=torch.bool, device=device)
    prevprev_ts = torch.ones(bw, dtype=torch.bool, device=device)
    ts0 = timestamps.timestamp_begin - 1 if timestamps is not None else 0
    last_ts = torch.full((bw,), ts0, dtype=torch.long, device=device)
    # the finished pool, FCFS order, with one spare slot (index m) that
    # takes every dropped write and is sliced off at the end
    pool_tokens = torch.zeros(b, m + 1, max_len, dtype=torch.long,
                              device=device)
    pool_sumlp = torch.full((b, m + 1), NEG_INF, device=device)
    pool_len = torch.full((b, m + 1), max_len, dtype=torch.long,
                          device=device)
    pool_cnt = torch.zeros(b, dtype=torch.long, device=device)
    bidx = torch.arange(b, device=device)[:, None]
    base = (torch.arange(b, device=device) * w)[:, None]
    col = torch.arange(max_len, device=device)

    for pos in range(max_len - 1):
        logits, cache = decode_step(params, cfg, tokens[:, pos], pos, cache,
                                    cross_kv, dtype)
        if pos + 1 < p_len:
            continue        # teacher-forced: every lane holds the prompt
        first = pos + 1 == p_len
        logits = logits.float()
        if suppress is not None and suppress.numel():
            logits[:, suppress] = NEG_INF
        if first and first_suppress is not None and first_suppress.numel():
            logits[:, first_suppress] = NEG_INF
        if timestamps is not None:
            logits = apply_timestamp_rules(
                logits, timestamps, first=first, prev_ts=prev_ts,
                prevprev_ts=prevprev_ts, last_ts=last_ts)
        logp = torch.log_softmax(logits, -1)
        v = logp.shape[-1]
        cand = (scores[:, None] + logp).reshape(b, w * v)
        top_scores, top_idx = torch.sort(cand, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :k2], top_idx[:, :k2]
        src_beam = top_idx // v
        new_tok = top_idx % v
        is_live, lane, is_pooled, pool_rank = _fcfs_partition(
            top_idx, v, eos_id, w)

        # ---- finished pool: FCFS insert of this step's EOT candidates;
        # valid slots are distinct, and every dropped candidate writes the
        # spare slot m (whichever of them lands last is discarded anyway)
        slot, ok = _pool_slots(is_pooled, pool_rank, pool_cnt, m)
        seqs = tokens.view(b, w, max_len)[bidx, src_beam]      # [B, 2W, L]
        seqs = torch.where(col > pos, eos_id, seqs)
        pool_tokens[bidx, slot] = seqs
        pool_sumlp[bidx, slot] = top_scores
        pool_len[bidx, slot] = pos + 2
        pool_cnt = pool_cnt + ok.sum(-1)

        # ---- live lanes: the first W non-EOT candidates refill the beams;
        # lanes are distinct, the rest write the spare lane w
        lane = torch.where(is_live, lane, torch.full_like(lane, w))
        live_scores = torch.zeros(b, w + 1, device=device)
        live_src = torch.zeros(b, w + 1, dtype=torch.long, device=device)
        live_tok = torch.zeros(b, w + 1, dtype=torch.long, device=device)
        live_scores[bidx, lane] = top_scores
        live_src[bidx, lane] = src_beam
        live_tok[bidx, lane] = new_tok
        src = (base + live_src[:, :w]).reshape(-1)

        tokens = tokens[src]
        scores = live_scores[:, :w].reshape(-1)
        # the post-step cache holds this step's K/V at ``pos``
        _reorder_cache(cache, src, pos + 1)
        nxt = live_tok[:, :w].reshape(-1)
        tokens[:, pos + 1] = nxt
        if timestamps is not None:
            is_ts = nxt >= timestamps.timestamp_begin
            prevprev_ts, prev_ts = prev_ts[src], is_ts
            last_ts = last_ts[src]
            last_ts = torch.where(is_ts, torch.maximum(last_ts, nxt), last_ts)
        if bool((pool_cnt >= m).all()):
            break

    # openai finalize: only pools with fewer than beam_width finished
    # candidates pad from the in-flight beams (descending sum-logprob), up
    # to beam_width in all; padded lanes keep length max_len
    live_tokens = tokens.view(b, w, max_len)
    live_sumlp = scores.view(b, w)
    order = torch.argsort(-live_sumlp, dim=1, stable=True)
    pad_slot = pool_cnt[:, None] + torch.arange(w, device=device)[None]
    pad_slot = torch.where(pad_slot < w, pad_slot,
                           torch.full_like(pad_slot, m))
    pool_tokens[bidx, pad_slot] = live_tokens[bidx, order]
    pool_sumlp[bidx, pad_slot] = live_sumlp[bidx, order]
    pool_len[bidx, pad_slot] = max_len
    pool_tokens, pool_sumlp, pool_len = (pool_tokens[:, :m],
                                         pool_sumlp[:, :m], pool_len[:, :m])

    # rank the pool (openai MaximumLikelihoodRanker); empty slots sit at
    # finfo.min and rank last
    gen_len = torch.clamp_min(pool_len - p_len, 1).float()
    if length_penalty is None:
        penalty = gen_len                          # whisper default: 1/length
    else:
        penalty = ((5.0 + gen_len) / 6.0) ** length_penalty        # GNMT
    norm_scores = pool_sumlp / penalty
    top = torch.argsort(-norm_scores, dim=1, stable=True)[:, :w]
    return BeamResult(pool_tokens[bidx, top], pool_len.gather(1, top),
                      norm_scores.gather(1, top), pool_sumlp.gather(1, top))
