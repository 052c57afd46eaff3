"""Whisper-family encoder-decoder in PyTorch (port of ``audax/models/whisper.py``).

Parameters are the JAX package's tree as nested dicts of tensors
(``models/bridge.py`` converts one, ``init_whisper_params`` draws one):
transformer layers stay STACKED with a leading ``n_layers`` axis, dense
kernels keep the ``[d_in, d_out]`` layout (``y = x @ kernel + bias``), and
only the conv kernels change layout, to ``F.conv1d``'s ``[C_out, C_in, 3]``.
The layer loops are Python loops over that axis (views, no copies).

Architecture: pre-LN blocks; encoder = 2x conv1d (stride 1, 2) + fixed
sinusoidal positions; decoder = learned positions + causal self-attention +
cross-attention; logits tied to the token embedding; k_proj has no bias;
LayerNorm eps 1e-5 with float32 statistics; attention scale head_dim**-0.5;
GELU exact (erf) in float32 and the tanh form in bfloat16.

Every attention of ``encode`` and the teacher-forced ``decode_train`` goes
through ``ops/attention.py:dot_product_attention``: the flash kernels (K2
forward, K7/K8 backward) wherever ``flash_applicable`` holds, the
materialised twin otherwise. The incremental decoder reads its caches
through the stacked decode-attention kernel (K3; its int8 arm for a
``QuantKV`` cache), and ``attention(kv_cached=)`` through K6. On CPU
tensors the kernels take their plain PyTorch versions. Float and int8 dense
projections, the conv stem and float tied-embedding logits stay
``torch.matmul``/``F.conv1d``, as the JAX package left them to XLA; int4
trees (``models/quantize.py``) run their projections and logits through
kernel K9.

Serving (``infer/continuous.py``) decodes with ``decode_step_ragged``:
every slot at its own position, its new K/V row written in place at that
position.

Tensor parallelism (``parallel/sharding.py:WHISPER_TP_RULES``): a rank
may hold its blocks of the tree -- q/k/v and ``mlp_in`` cut by columns,
``out`` and ``mlp_out`` by rows, the token embedding by vocab rows. The
code finds the cut by a projection's width against the config
(``parallel/comm.py:tp_active``), runs its own heads and FFN columns, and
writes the Megatron collectives under the current mesh: one all-reduce a
row-parallel projection (its bias added after it), the masked
vocab-parallel lookup, and the tied logits all-gathered. Whole trees take
none of them.

``remat`` (the training path) checkpoints each layer's body with
``torch.utils.checkpoint``: True recomputes the whole layer in the backward,
"dots" keeps its dense-projection outputs (the JAX
``dots_with_no_batch_dims_saveable`` policy), False saves everything.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.quantize import (dequant_dense, embed_logits,
                                         embed_lookup)
from audax_torch.ops.attention import (decode_attention,
                                       decode_attention_stacked,
                                       dot_product_attention)
from audax_torch.parallel.comm import (copy_to_model, local_block,
                                       reduce_from_model, tp_active,
                                       vocab_embed, vocab_logits)

Params = Dict[str, Any]

__all__ = [
    "init_whisper_params", "sinusoidal_positions", "layer_norm", "dense",
    "attention", "conv_stem", "encoder_layer", "encode", "decode_train",
    "whisper_forward",
    "KVCache", "QuantKV", "quantize_kv", "init_kv_cache",
    "precompute_cross_kv", "decode_step", "decode_span",
    "decode_step_ragged", "embed_lookup", "embed_logits", "layer_params",
    "tree_map", "tree_leaves", "tree_unflatten", "local_heads",
]


# ---------------------------------------------------------------------------
# init

def sinusoidal_positions(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed encoder positions (log-spaced timescales)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(
        np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def init_whisper_params(cfg: WhisperConfig, generator: torch.Generator, *,
                        device: DeviceLike = None) -> Params:
    """Random float32 parameters with the JAX ``init_whisper_params``
    layout and scales (normal draws from ``generator``; not the JAX
    numbers). Drawn on the generator's device, then moved to ``device``."""
    device = resolve_device(device)
    gen_dev = generator.device
    d, f = cfg.d_model, 4 * cfg.d_model

    def normal(*shape, std):
        return torch.randn(*shape, generator=generator, device=gen_dev) * std

    def dense(n, d_in, d_out, bias=True):
        p = {"kernel": normal(n, d_in, d_out, std=1.0 / math.sqrt(d_in))}
        if bias:
            p["bias"] = torch.zeros(n, d_out, device=gen_dev)
        return p

    def ln(n):
        return {"scale": torch.ones(n, d, device=gen_dev),
                "bias": torch.zeros(n, d, device=gen_dev)}

    def attn(n):
        return {"q": dense(n, d, d), "k": dense(n, d, d, bias=False),
                "v": dense(n, d, d), "out": dense(n, d, d)}

    def blocks(n, cross):
        p = {"attn_ln": ln(n), "attn": attn(n), "mlp_ln": ln(n),
             "mlp_in": dense(n, d, f), "mlp_out": dense(n, f, d)}
        if cross:
            p["cross_ln"] = ln(n)
            p["cross_attn"] = attn(n)
        return p

    final_ln = {"scale": torch.ones(d, device=gen_dev),
                "bias": torch.zeros(d, device=gen_dev)}
    params = {
        "encoder": {
            "conv1": {"kernel": normal(d, cfg.n_mels, 3,
                                       std=1.0 / math.sqrt(3 * cfg.n_mels)),
                      "bias": torch.zeros(d, device=gen_dev)},
            "conv2": {"kernel": normal(d, d, 3, std=1.0 / math.sqrt(3 * d)),
                      "bias": torch.zeros(d, device=gen_dev)},
            "pos": sinusoidal_positions(cfg.n_audio_ctx, d).to(gen_dev),
            "layers": blocks(cfg.encoder_layers, cross=False),
            "ln": dict(final_ln),
        },
        "decoder": {
            "embed": normal(cfg.vocab_size, d, std=0.02),
            "pos": normal(cfg.n_text_ctx, d, std=0.01),
            "layers": blocks(cfg.decoder_layers, cross=True),
            "ln": {k: t.clone() for k, t in final_ln.items()},
        },
    }
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree, *rest):
    """``fn`` applied to every tensor of a nested-dict parameter tree (and
    the matching leaves of ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a nested-dict tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves) -> Params:
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def layer_params(stack: Params, li: int) -> Params:
    """Layer ``li`` of a stacked layer tree (views of the stacked tensors)."""
    return tree_map(lambda t: t[li], stack)


# ---------------------------------------------------------------------------
# primitives

def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "kernel_q" in p or "kernel_q4" in p:     # int8/int4 weight-only
        return dequant_dense(p, x)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """[B, T, h hd] -> [B, h, T, hd]: the head count from the width, so a
    rank's head-sharded projection splits into its own heads."""
    b, t, d = x.shape
    return x.reshape(b, t, d // hd, hd).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in float32; the tanh form in bfloat16, where the
    difference is below the dtype's own rounding step."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def _width(p: Params) -> int:
    """The output width of a float, int8 or int4 dense dict."""
    for key in ("kernel", "kernel_q", "kernel_q4"):
        if key in p:
            return p[key].shape[-1]
    raise KeyError("not a dense parameter dict")


def _col_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``dense`` of a column-parallel projection: an int8 kernel's whole
    per-column scale (it matches no TP rule, ``parallel/sharding.py``)
    cut to this rank's block of columns."""
    if "kernel_q" in p and p["kernel_scale"].shape[-1] != \
            p["kernel_q"].shape[-1]:
        p = {**p, "kernel_scale": p["kernel_scale"][
            ..., local_block(p["kernel_scale"].shape[-1])]}
    return dense(p, x)


def _row_dense(p: Params, x: torch.Tensor, tp: bool) -> torch.Tensor:
    """``dense`` of a row-parallel projection: under TP the partial
    products are summed over 'model' (Megatron's g) and the replicated
    bias is added once, after the sum."""
    if not tp:
        return dense(p, x)
    y = dense({k: v for k, v in p.items() if k != "bias"}, x)
    y = reduce_from_model(y)
    return y + p["bias"].to(y.dtype) if "bias" in p else y


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    tp = tp_active(_width(p["mlp_in"]), 4 * x.shape[-1], "mlp_in")
    h = _gelu(_col_dense(p["mlp_in"], copy_to_model(x) if tp else x))
    return _row_dense(p["mlp_out"], h, tp)


def _embed(p: Params, tokens: torch.Tensor, dtype, vocab: int
           ) -> torch.Tensor:
    """The token embedding: vocab-parallel on a vocab-sharded table."""
    if "embed" in p:
        emb = vocab_embed(p["embed"], tokens, vocab)
        if emb is not None:
            return emb.to(dtype)
    return embed_lookup(p, tokens, dtype)


def _logits(p: Params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """Tied logits: all-gathered over 'model' from a vocab-sharded table."""
    if "embed" in p:
        y = vocab_logits(p["embed"], x, vocab)
        if y is not None:
            return y
    return embed_logits(p, x)


def local_heads(params: Params, cfg: WhisperConfig) -> int:
    """The decoder self-attention heads this rank computes (and its caches
    hold): heads / tp under TP, all of them for a whole (int4) block."""
    return _width(params["decoder"]["layers"]["attn"]["q"]) // (
        cfg.d_model // cfg.heads)


def attention(p: Params, x: torch.Tensor, heads: int, *,
              kv: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              causal: bool = False, kv_cached=None,
              core=None) -> torch.Tensor:
    """Multi-head attention through ``dot_product_attention``. ``kv``: the
    cross-attention source (self-attention when None); ``mask``: a boolean
    [.., Tq, Tk] mask, which takes the materialised twin. ``kv_cached``:
    precomputed head tensors, float (k, v) [B, H, S, hd] or a ``QuantKV``;
    without a mask they go through ``decode_attention`` (K6). ``core(q, k,
    v, scale)``: another exact attention over the head tensors in place of
    ``dot_product_attention`` (sequence parallelism's ring,
    ``parallel/sp.py``).

    ``heads`` is the model's head count; with head-sharded projections
    (TP, ``parallel/sharding.py``) this rank computes its own heads and
    the output projection's partial sums meet in one all-reduce."""
    hd = x.shape[-1] // heads
    tp = tp_active(_width(p["q"]), x.shape[-1], "attention q")
    xin = copy_to_model(x) if tp else x
    q = _split_heads(_col_dense(p["q"], xin), hd)
    scale = q.shape[-1] ** -0.5
    if kv_cached is not None and mask is None:
        out = decode_attention(q, kv_cached, scale=scale)
        return _row_dense(p["out"], _merge_heads(out), tp)
    if isinstance(kv_cached, QuantKV):
        # every int8-KV caller is maskless and takes K6 above, as in JAX
        raise NotImplementedError("QuantKV attention with an explicit mask "
                                  "has no caller; use the decode fast path")
    if kv_cached is not None:
        k, v = kv_cached
    else:
        src = xin if kv is None else (copy_to_model(kv) if tp else kv)
        k = _split_heads(_col_dense(p["k"], src), hd)
        v = _split_heads(_col_dense(p["v"], src), hd)
    out = (dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 scale=scale) if core is None
           else core(q, k, v, scale))
    return _row_dense(p["out"], _merge_heads(out), tp)


# ---------------------------------------------------------------------------
# encoder

def conv_stem(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """mel [B, T, n_mels] -> [B, T//2, d_model] with positions added."""
    p = params["encoder"]
    x = mel.to(dtype).transpose(1, 2)                       # [B, C, T]
    x = _gelu(F.conv1d(x, p["conv1"]["kernel"].to(dtype),
                       p["conv1"]["bias"].to(dtype), padding=1))
    x = _gelu(F.conv1d(x, p["conv2"]["kernel"].to(dtype),
                       p["conv2"]["bias"].to(dtype), stride=2, padding=1))
    x = x.transpose(1, 2)
    return x + p["pos"].to(dtype)[None, : x.shape[1]]


#: the dense projections' ops, saved by remat="dots"
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_body(body, remat):
    """Per-LAYER gradient checkpointing of a layer body ``body(x, layer)``:
    the backward recomputes one layer at a time, so only the layer
    boundaries (and, for "dots", the projection outputs) stay saved. A
    whole-forward checkpoint would replay every layer at once and save no
    memory. Outside autograd the body runs as it is."""
    if not remat:
        return body

    def run(x, layer):
        if not torch.is_grad_enabled():
            return body(x, layer)
        kw = {}
        if remat == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_dots)
        return checkpoint(body, x, layer, use_reentrant=False, **kw)
    return run


def encoder_layer(layer: Params, cfg: WhisperConfig, x: torch.Tensor, *,
                  core=None) -> torch.Tensor:
    """One pre-norm encoder layer (``core``: as ``attention`` takes it)."""
    x = x + attention(layer["attn"], layer_norm(layer["attn_ln"], x),
                      cfg.heads, core=core)
    return x + _mlp(layer, layer_norm(layer["mlp_ln"], x))


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
           dtype=torch.float32, *, remat=False) -> torch.Tensor:
    """mel [B, T_frames, n_mels] (time-major) -> encoder states
    [B, T_frames//2, d_model]. ``remat`` (False | True | "dots")
    checkpoints each layer (training path)."""
    p = params["encoder"]
    x = conv_stem(params, cfg, mel, dtype)

    def body(x, layer):
        return encoder_layer(layer, cfg, x)

    body = _remat_body(body, remat)
    for li in range(cfg.encoder_layers):
        x = body(x, layer_params(p["layers"], li))
    return layer_norm(p["ln"], x)


# ---------------------------------------------------------------------------
# decoder (training / teacher-forced)

def decode_train(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                 enc: torch.Tensor, dtype=torch.float32, *,
                 remat=False) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, vocab] with causal self-attention
    and cross-attention to ``enc``."""
    p = params["decoder"]
    n = tokens.shape[1]
    x = _embed(p, tokens, dtype, cfg.vocab_size) + p["pos"][:n].to(dtype)

    def body(x, layer):
        x = x + attention(layer["attn"], layer_norm(layer["attn_ln"], x),
                          cfg.heads, causal=True)
        x = x + attention(layer["cross_attn"],
                          layer_norm(layer["cross_ln"], x), cfg.heads, kv=enc)
        return x + _mlp(layer, layer_norm(layer["mlp_ln"], x))

    body = _remat_body(body, remat)
    for li in range(cfg.decoder_layers):
        x = body(x, layer_params(p["layers"], li))
    return _logits(p, layer_norm(p["ln"], x), cfg.vocab_size)


def whisper_forward(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
                    tokens: torch.Tensor, dtype=torch.float32, *,
                    remat=False) -> torch.Tensor:
    """Full seq2seq forward (fine-tuning path): mel + decoder input tokens
    -> logits [B, L, vocab]."""
    return decode_train(params, cfg, tokens,
                        encode(params, cfg, mel, dtype, remat=remat),
                        dtype, remat=remat)


# ---------------------------------------------------------------------------
# decoder (incremental, KV-cached)

class KVCache(NamedTuple):
    """Fixed-shape self-attention cache: k/v [layers, B, H, max_len, hd].
    The decode steps write it IN PLACE (unlike the JAX functional update)."""
    k: torch.Tensor
    v: torch.Tensor


class QuantKV(NamedTuple):
    """Int8 K/V with one float32 scale per key/value vector: ``*_q`` int8
    [..., T, hd], ``*_scale`` [..., T]. The scales fold into the attention
    (scores times k_scale over the key axis, probabilities times v_scale
    before PV), so no float K/V is ever rebuilt."""
    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor


def quantize_kv(k: torch.Tensor, v: torch.Tensor) -> QuantKV:
    """Per-vector symmetric int8 over the head dim (any leading shape)."""

    def one(x):
        s = torch.clamp_min(x.float().abs().amax(dim=-1) / 127.0, 1e-8)
        q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
        return q.to(torch.int8), s

    kq, ks = one(k)
    vq, vs = one(v)
    return QuantKV(kq, ks, vq, vs)


def init_kv_cache(cfg: WhisperConfig, batch: int, max_len: int,
                  dtype=torch.float32, device: DeviceLike = None,
                  quant: bool = False, heads: Optional[int] = None):
    """Zeroed self-attention cache [layers, batch, H, max_len, hd]: float
    (``KVCache``) or, with ``quant``, int8 codes and unit scales
    (``QuantKV``). ``heads``: the heads this rank holds (``local_heads``;
    default all)."""
    device = resolve_device(device)
    hd = cfg.d_model // cfg.heads
    shape = (cfg.decoder_layers, batch, heads or cfg.heads, max_len, hd)
    if quant:
        return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.ones(shape[:-1], device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.ones(shape[:-1], device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def precompute_cross_kv(params: Params, cfg: WhisperConfig,
                        enc: torch.Tensor, quant: bool = False):
    """Cross-attention K/V of every layer, once per utterance:
    [layers, B, H, S, hd] each (``quant``: a ``QuantKV``); under TP this
    rank's heads."""
    layers = params["decoder"]["layers"]["cross_attn"]
    hd = cfg.d_model // cfg.heads
    ks, vs = [], []
    for li in range(cfg.decoder_layers):
        ks.append(_split_heads(_col_dense(layer_params(layers["k"], li),
                                          enc), hd))
        vs.append(_split_heads(_col_dense(layer_params(layers["v"], li),
                                          enc), hd))
    k, v = torch.stack(ks), torch.stack(vs)
    return quantize_kv(k, v) if quant else (k, v)


def _write_kv(cache, li: int, index, k1: torch.Tensor, v1: torch.Tensor):
    """Write new K/V heads into layer ``li`` of the cache at ``index`` (a
    tuple indexing the [B, H, T] axes), quantizing them for a QuantKV."""
    if isinstance(cache, QuantKV):
        new = quantize_kv(k1, v1)
        for dst, src in zip(cache, new):
            dst[(li,) + index] = src
    else:
        cache.k[(li,) + index] = k1
        cache.v[(li,) + index] = v1


def _cross_and_mlp(layer: Params, cfg: WhisperConfig, x: torch.Tensor,
                   cross_kv, li: int) -> torch.Tensor:
    h = layer_norm(layer["cross_ln"], x)
    qp = layer["cross_attn"]["q"]
    tp = tp_active(_width(qp), x.shape[-1], "cross-attention q")
    qc = _split_heads(_col_dense(qp, h), cfg.d_model // cfg.heads)
    co = decode_attention_stacked(qc, cross_kv, li,
                                  scale=qc.shape[-1] ** -0.5)
    x = x + _row_dense(layer["cross_attn"]["out"], _merge_heads(co), tp)
    return x + _mlp(layer, layer_norm(layer["mlp_ln"], x))


def _self_qkv(layer: Params, cfg: WhisperConfig, h: torch.Tensor):
    """(q, k, v) heads of the decoder self-attention, and whether they are
    this rank's TP block."""
    p = layer["attn"]
    hd = cfg.d_model // cfg.heads
    tp = tp_active(_width(p["q"]), h.shape[-1], "attention q")
    return (_split_heads(_col_dense(p["q"], h), hd),
            _split_heads(_col_dense(p["k"], h), hd),
            _split_heads(_col_dense(p["v"], h), hd), tp)


@torch.no_grad()
def decode_span(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
                pos: int, cache, cross_kv, dtype=torch.float32):
    """Teacher-forced span decode with cache append: tokens [B, K] occupy
    positions pos..pos+K-1; query i attends cached positions <= pos+i.
    ``cache``/``cross_kv`` are float (``KVCache`` / (k, v)) or int8
    (``QuantKV``). Returns (logits [B, K, vocab], the cache, updated in
    place)."""
    p = params["decoder"]
    kk = tokens.shape[1]
    x = _embed(p, tokens, dtype, cfg.vocab_size) + \
        p["pos"][pos: pos + kk][None].to(dtype)
    for li in range(cfg.decoder_layers):
        layer = layer_params(p["layers"], li)
        q, k1, v1, tp = _self_qkv(layer, cfg, layer_norm(layer["attn_ln"], x))
        _write_kv(cache, li, (slice(None), slice(None), slice(pos, pos + kk)),
                  k1, v1)
        attn_out = decode_attention_stacked(q, cache, li, pos=pos,
                                            scale=q.shape[-1] ** -0.5)
        x = x + _row_dense(layer["attn"]["out"], _merge_heads(attn_out), tp)
        x = _cross_and_mlp(layer, cfg, x, cross_kv, li)
    x = layer_norm(p["ln"], x)
    return _logits(p, x, cfg.vocab_size), cache


def decode_step(params: Params, cfg: WhisperConfig, token: torch.Tensor,
                pos: int, cache, cross_kv,
                dtype=torch.float32):
    """One autoregressive step: token [B] at position ``pos`` -> (logits
    [B, vocab], the cache, updated in place)."""
    logits, cache = decode_span(params, cfg, token[:, None], pos, cache,
                                cross_kv, dtype)
    return logits[:, 0], cache


@torch.no_grad()
def decode_step_ragged(params: Params, cfg: WhisperConfig,
                       token: torch.Tensor, pos: torch.Tensor, cache,
                       cross_kv, dtype=torch.float32):
    """``decode_step`` with PER-SLOT positions: token [B], pos [B] (integer
    tensor on the model's device). Slot b writes its new K/V at ``pos[b]``
    (in place, one indexed write per tensor) and attends cached keys
    ``<= pos[b]``: the step that lets continuous batching refill a finished
    slot while its neighbours keep decoding. Slots that are done still
    write at their frozen position, as in JAX. Returns (logits [B, vocab],
    the cache)."""
    p = params["decoder"]
    pos = pos.long()
    pos32 = pos.to(torch.int32)
    bidx = torch.arange(token.shape[0], device=token.device)
    x = _embed(p, token[:, None], dtype, cfg.vocab_size) + \
        p["pos"][pos][:, None].to(dtype)
    for li in range(cfg.decoder_layers):
        layer = layer_params(p["layers"], li)
        q, k1, v1, tp = _self_qkv(layer, cfg, layer_norm(layer["attn_ln"], x))
        # row b of the new K/V lands at (li, b, :, pos[b])
        _write_kv(cache, li, (bidx, slice(None), pos), k1[:, :, 0],
                  v1[:, :, 0])
        attn_out = decode_attention_stacked(q, cache, li, pos=pos32,
                                            scale=q.shape[-1] ** -0.5)
        x = x + _row_dense(layer["attn"]["out"], _merge_heads(attn_out), tp)
        x = _cross_and_mlp(layer, cfg, x, cross_kv, li)
    x = layer_norm(p["ln"], x)
    return _logits(p, x, cfg.vocab_size)[:, 0], cache
