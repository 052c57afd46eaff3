"""Word-level timestamps via cross-attention alignment (port of
``audax/infer/align.py``: ``cross_attention_weights``, ``dtw_path``,
``merge_punctuations``, ``word_timings``, ``WordTiming`` and the
punctuation sets).

openai-whisper's ``word_timestamps=True`` path: one teacher-forced decoder
pass captures the cross-attention probabilities of the upper half of the
decoder layers, the alignment heads' maps are z-normalised, averaged and
median-filtered on the model's device, and a host-side dynamic-time-warping
pass (numpy, over a <= 448 x 1500 matrix) yields a monotonic token->frame
path that is merged into word timings. Each encoder frame covers 0.02 s of
audio (2 mel hops).

The attention of this pass is a plain product, as in the JAX package (its
``jnp.einsum`` and softmax run outside any Pallas kernel): the
probabilities themselves are the output, so no kernel that keeps them in
registers applies. The [layers/2, B, H, L, S] stack stays on the device;
the caller copies only the rows it aligns to the host.

Under tensor parallelism (the parameters cut by ``parallel/sharding.py:
shard_params``, the mesh current) each rank runs the pass on its own heads
with the model's TP projections, z-normalises its heads as openai-whisper
does per head, and the heads' sums of the normalised maps and of the mass
meet in one all-reduce over 'model' before the mean and the median filter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.models.whisper import (_col_dense, _embed, _merge_heads,
                                        _mlp, _row_dense, _split_heads,
                                        _width, layer_norm, layer_params)
from audax_torch.parallel.comm import reduce_from_model, tp_active

__all__ = ["WordTiming", "cross_attention_weights", "dtw_path",
           "word_timings", "merge_punctuations",
           "PREPEND_PUNCTUATIONS", "APPEND_PUNCTUATIONS"]

SECONDS_PER_FRAME = 0.02      # encoder frame = 2 mel hops = 20 ms


@dataclass
class WordTiming:
    word: str
    start: float                # seconds within the window
    end: float
    #: mean softmax attention mass along the aligned path (a [0,1] quantity
    #: when ``word_timings`` receives the ``mass`` matrix; the z-scored
    #: alignment values otherwise)
    probability: float


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as ``jnp.median`` takes it: the middle
    value for an odd count, the mean of the two middle values for an even
    one (``torch.median`` would return the lower of the two)."""
    srt = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    if n % 2:
        return srt[..., n // 2]
    return (srt[..., n // 2 - 1] + srt[..., n // 2]) / 2


@torch.inference_mode()
def cross_attention_weights(params, cfg: WhisperConfig, tokens: torch.Tensor,
                            enc: torch.Tensor, *,
                            n_frames: Optional[int] = None,
                            medfilt: int = 7,
                            dtype=torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder pass -> (alignment matrix, attention mass).

    tokens [B, L], enc [B, S, d] -> (w [B, L, S], mass [B, L, S]) in
    openai-whisper's find_alignment order: softmax over the VALID frames
    only (``n_frames``; later frames are masked out before the softmax),
    z-normalise per (head, frame) across tokens (biased std), average the
    alignment heads (the upper half of the decoder layers), median-filter
    along frames (edge padding), and mask frames past ``n_frames`` with
    -1e9 so the DTW never walks there. ``mass`` is the head-mean softmax
    mass before normalisation. As in the JAX package the median filter
    runs on the head-averaged matrix, not per head. Under TP (module
    docstring) the head means are taken after one all-reduce over
    'model' of the two head sums."""
    p = params["decoder"]
    b, l = tokens.shape
    s = enc.shape[1]
    device = enc.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
    x = _embed(p, tokens, dtype, cfg.vocab_size) + p["pos"][:l].to(dtype)
    causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=device))
    enc = enc.to(dtype)
    frame_ok = torch.arange(s, device=device) < (s if n_frames is None
                                                 else int(n_frames))
    half = cfg.decoder_layers // 2
    hd = cfg.d_model // cfg.heads
    # whether this rank holds a block of the heads (int4 blocks and head
    # counts the model axis does not divide stay whole)
    self_tp = tp_active(_width(p["layers"]["attn"]["q"]), cfg.d_model,
                        "attention q")
    cross_tp = tp_active(_width(p["layers"]["cross_attn"]["q"]), cfg.d_model,
                         "cross-attention q")
    aligned = []
    for li in range(cfg.decoder_layers):
        layer = layer_params(p["layers"], li)
        h = layer_norm(layer["attn_ln"], x)
        q = _split_heads(_col_dense(layer["attn"]["q"], h), hd)
        k = _split_heads(_col_dense(layer["attn"]["k"], h), hd)
        v = _split_heads(_col_dense(layer["attn"]["v"], h), hd)
        scale = q.shape[-1] ** -0.5
        scores = (q * scale) @ k.transpose(-1, -2)
        scores = scores.masked_fill(~causal, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), -1).to(x.dtype)
        x = x + _row_dense(layer["attn"]["out"], _merge_heads(probs @ v),
                           self_tp)

        h = layer_norm(layer["cross_ln"], x)
        cq = _split_heads(_col_dense(layer["cross_attn"]["q"], h), hd)
        ck = _split_heads(_col_dense(layer["cross_attn"]["k"], enc), hd)
        cv = _split_heads(_col_dense(layer["cross_attn"]["v"], enc), hd)
        cscores = ((cq * cq.shape[-1] ** -0.5) @ ck.transpose(-1, -2)).float()
        cprobs = torch.softmax(cscores, -1)
        x = x + _row_dense(layer["cross_attn"]["out"],
                           _merge_heads(cprobs.to(x.dtype) @ cv), cross_tp)
        x = x + _mlp(layer, layer_norm(layer["mlp_ln"], x))
        if li >= half:
            # alignment probabilities: re-softmax over the valid frames
            aligned.append(torch.softmax(
                cscores.masked_fill(~frame_ok, float("-inf")), -1))
    aligned = torch.stack(aligned)             # [layers - half, B, h, L, S]
    mean = aligned.mean(dim=-2, keepdim=True)              # across tokens
    std = aligned.std(dim=-2, keepdim=True, correction=0) + 1e-9
    if cross_tp:
        # this rank's heads summed, then summed over the ranks' heads
        both = reduce_from_model(torch.stack([
            aligned.sum(dim=(0, 2)),
            ((aligned - mean) / std).sum(dim=(0, 2))]))
        n = aligned.shape[0] * cfg.heads
        mass, w = both[0] / n, both[1] / n
    else:
        mass = aligned.mean(dim=(0, 2))                    # [B, L, S]
        w = ((aligned - mean) / std).mean(dim=(0, 2))      # head-mean
    if medfilt > 1:
        pad = medfilt // 2
        cols = (torch.arange(s, device=device)[:, None]
                + torch.arange(medfilt, device=device)[None] - pad)
        w = _median_last(w[..., cols.clamp(0, s - 1)])      # [B, L, S, m]
    w = w.masked_fill(~frame_ok, -1e9)
    return w, mass


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a [L, S] cost matrix (lower = better aligned).

    Returns (token_idx, frame_idx) arrays tracing the optimal path with
    steps (1,1), (1,0), (0,1) — openai-whisper's alignment recurrence.

    Vectorized per row: the in-row dependency
    ``row[j] = c[j] + min(m[j], row[j-1])`` (m = best of the diagonal/up
    predecessors) is a MIN-PLUS prefix scan, solvable in closed form with a
    cumulative sum and a running minimum::

        row[j] = C[j] + min_{k<=j} (m[k] - C[k-1]),   C = cumsum(c)

    so the fill is L rows of O(S) numpy vector ops instead of an O(L*S)
    Python double loop (~100x on a 224x1500 alignment — this sits on the
    per-chunk word-timestamp path). Backtracking re-derives each step by
    argmin over the three predecessors in the stored matrix (diag > up >
    left priority), which is robust to the scan's float reassociation.
    """
    l, s = cost.shape
    cost64 = np.asarray(cost, np.float64)
    d = np.full((l + 1, s + 1), np.inf)
    d[0, 0] = 0.0
    for i in range(1, l + 1):
        c = cost64[i - 1]
        m = np.minimum(d[i - 1, :-1], d[i - 1, 1:])      # diag/up per column
        cum = np.cumsum(c)
        shifted = np.concatenate(([0.0], cum[:-1]))
        d[i, 1:] = cum + np.minimum.accumulate(m - shifted)
    i, j = l, s
    ti, fi = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        c0, c1, c2 = d[i - 1, j - 1], d[i - 1, j], d[i, j - 1]
        if c0 <= c1 and c0 <= c2:
            i, j = i - 1, j - 1
        elif c1 <= c2:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


#: openai-whisper's transcribe(prepend_punctuations/append_punctuations)
#: defaults — membership is SUBSTRING semantics, matching upstream's
#: ``word in punctuations`` checks
PREPEND_PUNCTUATIONS = "\"'\u201c\u00bf([{-"
APPEND_PUNCTUATIONS = "\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


def merge_punctuations(words: List[WordTiming],
                       prepend: str = PREPEND_PUNCTUATIONS,
                       append: str = APPEND_PUNCTUATIONS
                       ) -> List[WordTiming]:
    """Fold standalone punctuation words into their neighbours
    (openai-whisper ``merge_punctuations``): an opening quote/bracket
    attaches to the FOLLOWING word (extending its start), a closing
    quote/period/comma to the PRECEDING word (extending its end). The
    content word's probability is kept — the punctuation's alignment
    confidence is noise."""
    out: List[WordTiming] = []
    pending: List[WordTiming] = []          # prepends awaiting a word
    for w in words:
        if w.word and w.word in prepend:
            pending.append(w)
        elif out and w.word and w.word in append and not pending:
            prev = out[-1]
            out[-1] = WordTiming(prev.word + w.word, prev.start,
                                 w.end, prev.probability)
        else:
            if pending:
                w = WordTiming("".join(p.word for p in pending) + w.word,
                               pending[0].start, w.end, w.probability)
                pending = []
            out.append(w)
    out.extend(pending)                      # trailing prepends: keep as-is
    return out


def word_timings(
    weights: np.ndarray,          # [L, S] alignment matrix (higher = aligned)
    token_ids: Sequence[int],     # the L generated tokens (text+timestamps)
    tokenizer,
    *, n_frames: Optional[int] = None,
    mass: Optional[np.ndarray] = None,   # [L, S] softmax attention mass
    prepend_punctuations: str = PREPEND_PUNCTUATIONS,
    append_punctuations: str = APPEND_PUNCTUATIONS,
) -> List[WordTiming]:
    """Token->frame DTW path merged into per-word timings.

    Words are whitespace-split over the decoded text; each word's span is
    the contiguous run of its tokens' aligned frames. Timestamp/special
    tokens are skipped for text but still anchor the path monotonicity.
    ``mass`` (from ``cross_attention_weights``) supplies real [0,1]
    attention-mass confidences; without it probabilities are z-scores.
    """
    l = len(token_ids)
    w = np.asarray(weights[:l], np.float32)
    score_src = w if mass is None else np.asarray(mass[:l], np.float32)
    if n_frames is not None:
        w = w[:, :n_frames]
        score_src = score_src[:, :n_frames]
    ti, fi = dtw_path(-w)

    # first/last aligned frame per token
    starts = np.full(l, -1, np.int64)
    ends = np.zeros(l, np.int64)
    for t, f in zip(ti, fi):
        if starts[t] < 0:
            starts[t] = f
        ends[t] = f
    path_score = {int(t): [] for t in range(l)}
    for t, f in zip(ti, fi):
        path_score[int(t)].append(float(score_src[t, f]))

    # group text tokens into words AT THE BYTE LEVEL: byte-BPE pieces do not
    # decode independently (UTF-8 sequences span pieces), so words are byte
    # runs split on ASCII whitespace, each run decoded once and attributed
    # to the token indices that contributed bytes to it
    base = len(tokenizer.bpe)
    ws = b" \t\n\r"
    words: List[WordTiming] = []
    cur_bytes = bytearray()
    cur_tokens: List[int] = []

    def flush():
        nonlocal cur_bytes, cur_tokens
        text = bytes(cur_bytes).decode("utf-8", errors="replace").strip()
        aligned = [t for t in cur_tokens if starts[t] >= 0]
        if text and aligned:
            s = min(starts[t] for t in aligned)
            e = max(ends[t] for t in aligned)
            probs = [p for t in aligned for p in path_score.get(t, [])]
            words.append(WordTiming(
                text, round(s * SECONDS_PER_FRAME, 3),
                round((e + 1) * SECONDS_PER_FRAME, 3),
                float(np.mean(probs)) if probs else 0.0))
        cur_bytes, cur_tokens = bytearray(), []

    for idx, tid in enumerate(token_ids):
        tid = int(tid)
        piece = tokenizer.bpe.token_bytes(tid) if tid < base else None
        if piece is None:
            # special/timestamp: skipped WITHOUT flushing — WhisperTokenizer
            # .decode(skip_special=True) merges byte runs across specials,
            # and word grouping must reproduce its text exactly
            continue
        i0 = 0
        for k, byte in enumerate(piece):
            if byte in ws:
                if k > i0:
                    cur_bytes += piece[i0:k]
                    cur_tokens.append(idx)
                flush()
                i0 = k + 1
        if i0 < len(piece):
            cur_bytes += piece[i0:]
            cur_tokens.append(idx)
    flush()
    return merge_punctuations(words, prepend_punctuations,
                              append_punctuations)
