"""Decoder-only causal LM, the Qwen2/Qwen3/LLaMA family and its
mixture-of-experts member Qwen3-MoE, in PyTorch (port of
``audax/models/causal_lm.py``).

The reference's two-tower model wraps HF ``Qwen/Qwen3-0.6B-Base``
(reference: .charles/music2midi/model.py:209-224); this module owns the
architecture: RMSNorm with float32 statistics, rotary position embeddings
(HF half-split, float32 angles), grouped-query attention, optional
per-head q/k norms (Qwen3) applied before RoPE, optional q/k/v biases
(Qwen2), a SwiGLU MLP or, with ``num_experts > 0``, a sparse MoE SwiGLU
block in every layer (Qwen3-MoE: no shared expert), and tied (or separate)
output embeddings.

Parameters are the JAX package's tree as nested dicts of tensors
(``models/bridge.py:causal_lm_from_numpy`` converts one; ``init_causal_lm``
draws one): layers STACKED with a leading ``[L, ...]`` axis, dense kernels
``[d_in, d_out]``, an MoE layer's ``router`` ``[L, d, E]`` and ``experts``
``{gate, up: [L, E, d, fe], down: [L, E, fe, d]}``. Float, int8 and int4
dense leaves run through ``models/whisper.py:dense``; the router stays
float in a quantized tree.

Attention sites:

  * the teacher-forced forward (``forward_with_embeds``, ``lm_forward``)
    calls ``ops/attention.py:dot_product_attention`` causally: without a
    padding mask it takes the flash path (kernel K2 on the card, GQA
    inside the kernel), with one the materialised twin, as in JAX;
  * a decode step (``lm_decode_step``) writes its new K/V row in place into
    the layer-STACKED cache ``[L, B, kvH, S, hd]`` at a scalar position or
    at each slot's own (a ``[B]`` vector, continuous batching) and reads it
    through ``decode_attention_stacked`` (kernel K3, GQA and the per-slot
    causal mask inside the kernel).

The MoE block (``_moe_block``) routes as HF's Qwen3MoeSparseMoeBlock: a
float32 softmax over all experts, the top k, an optional renormalisation,
the weights cast back to the activation dtype. Its two impls
(``cfg.moe_impl``) are JAX's: ``ragged`` sorts the N k (token, expert)
slots by expert (a stable sort), runs each expert's products over its
group of rows -- JAX's ``lax.ragged_dot`` is an XLA op, not a Pallas
kernel; here ``torch.matmul`` over the non-empty groups, whose sizes are
read on the host once a layer -- and weighted-sums the k slots back in
token order; ``dense`` runs every expert on every token and combines them
with the [N, E] router-weight matrix. int8 experts scale the products by
their per-(expert, channel) scales, int4 experts dequantize whole. The
decode path for QUANTIZED experts with N k <= E is ``_moe_selected_scan``:
slot by slot in JAX's order, each slot's gate/up/down read only the
selected expert -- int4 through kernel K9 with the expert id handed to the
kernel as a device tensor (``ops/int4_matmul.py``), so the router's
output never reaches the host.

Under tensor parallelism (``parallel/sharding.py:CAUSAL_LM_TP_RULES``) a
rank holds its blocks: q/k/v, gate/up by columns, o/down by rows, the
embedding by vocab rows, ``lm_head`` by vocab columns, and an MoE layer's
experts by the expert axis (each rank runs its experts on every token and
the combine is all-reduced). k/v whose ``kv_heads`` do not divide the
model axis are gathered (or kept whole) and each rank reads the KV heads
of its query heads (``_kv_select``); replicated tensors read by a rank's
part only (q/k norms, whole k/v, the router weights of the local experts)
pass Megatron's f so their gradient is summed over 'model'.

The rotary tables are computed once per forward or step and shared by
every layer (the JAX package recomputes them per layer; same float32
numbers). ``port_causal_lm_from_hf`` takes an in-memory HF model (this
module imports no ``transformers``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.hf_files import config_value
from audax_torch.models.quantize import embed_logits, embed_lookup
from audax_torch.models.whisper import (_col_dense, _remat_body, _row_dense,
                                        _width, dense, layer_params,
                                        tree_map)
from audax_torch.ops.attention import (decode_attention_stacked,
                                       dot_product_attention)
from audax_torch.ops.int4_matmul import dequantize_int4, int4_matmul
from audax_torch.parallel.comm import (copy_to_model, gather_for_use,
                                       gather_from_model, local_block,
                                       model_rank, reduce_from_model,
                                       sum_over, tp_active, vocab_embed,
                                       vocab_logits)
from audax_torch.parallel.mesh import axis_group, current_mesh

Params = Dict[str, Any]

__all__ = ["CausalLMConfig", "init_causal_lm", "rms_norm",
           "lm_forward", "lm_logits", "embed_tokens", "forward_with_embeds",
           "LMKVCache", "init_lm_cache", "lm_decode_step",
           "resize_embeddings", "port_causal_lm_state_dict",
           "port_causal_lm_from_hf",
           "load_balance_loss", "lm_cache_heads"]


@dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 2048
    d_model: int = 256
    layers: int = 4
    heads: int = 8
    kv_heads: int = 4            # GQA; == heads -> MHA
    #: per-head width; 0 -> d_model // heads. Qwen3 DECOUPLES it
    #: (hidden 1024, 16 heads, head_dim 128 -> q proj is [1024, 2048])
    head_dim: int = 0
    ffn_dim: int = 0             # 0 -> 8/3 * d rounded to 128
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    qkv_bias: bool = False       # Qwen2: True, Qwen3/llama: False
    qk_norm: bool = False        # Qwen3: True
    tie_embeddings: bool = True
    max_seq: int = 2048
    # ---- mixture-of-experts (Qwen3-MoE family: every layer sparse) ----
    num_experts: int = 0         # 0 -> dense SwiGLU MLP
    experts_per_tok: int = 0     # router top-k
    moe_ffn_dim: int = 0         # per-expert FFN width (0 -> ffn)
    norm_topk_prob: bool = True  # renormalize the top-k router probs
    #: "ragged": sort the selected slots by expert, each expert's products
    #: over its rows (exact top-k FLOPs); "dense": every expert on every
    #: token, combined by the router weights (E/k x the FLOPs)
    moe_impl: str = "ragged"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.heads)
        if self.num_experts and not self.experts_per_tok:
            raise ValueError("MoE config needs experts_per_tok >= 1")

    @property
    def ffn(self) -> int:
        if self.ffn_dim:
            return self.ffn_dim
        return ((int(self.d_model * 8 / 3) + 127) // 128) * 128

    @property
    def moe_ffn(self) -> int:
        return self.moe_ffn_dim or self.ffn

    @classmethod
    def qwen3_0_6b(cls) -> "CausalLMConfig":
        """Qwen3-0.6B's published config (HF ``Qwen/Qwen3-0.6B-Base``
        config.json): hidden 1024, 28 layers, 16 query and 8 KV heads of
        128, intermediate 3072, vocab 151,936, rope_theta 1e6, q/k norms,
        tied embeddings."""
        return cls(vocab_size=151936, d_model=1024, layers=28, heads=16,
                   kv_heads=8, head_dim=128, ffn_dim=3072, rope_theta=1e6,
                   rms_eps=1e-6, qk_norm=True, tie_embeddings=True,
                   max_seq=40960)

    @classmethod
    def qwen3_30b_a3b(cls) -> "CausalLMConfig":
        """Qwen3-30B-A3B's published config (HF ``Qwen/Qwen3-30B-A3B``
        config.json): hidden 2048, 48 layers, 32 query and 4 KV heads of
        128, 128 experts of intermediate 768 with 8 routed a token and the
        top-k renormalised, vocab 151,936, untied embeddings, rope_theta
        1e6, q/k norms."""
        return cls(vocab_size=151936, d_model=2048, layers=48, heads=32,
                   kv_heads=4, head_dim=128, ffn_dim=6144, rope_theta=1e6,
                   rms_eps=1e-6, qk_norm=True, tie_embeddings=False,
                   max_seq=40960, num_experts=128, experts_per_tok=8,
                   moe_ffn_dim=768, norm_topk_prob=True)


# ---------------------------------------------------------------- init ----
def init_causal_lm(cfg: CausalLMConfig, generator: torch.Generator, *,
                   device: DeviceLike = None) -> Params:
    """Random float32 parameters with the JAX ``init_causal_lm`` layout and
    scales (dense kernels normal / sqrt(d_in), expert kernels normal /
    sqrt(their d_in), zero biases, unit norms, embeddings normal x 0.02),
    drawn from ``generator`` on its device in the order of the JAX tree's
    leaves, then moved to ``device``."""
    device = resolve_device(device)
    gen_dev = generator.device
    n, d, hd = cfg.layers, cfg.d_model, cfg.head_dim

    def lin(d_in, d_out, bias=False, stack=True):
        shape = (n, d_in, d_out) if stack else (d_in, d_out)
        p = {"kernel": torch.randn(*shape, generator=generator,
                                   device=gen_dev) / math.sqrt(d_in)}
        if bias:
            p["bias"] = torch.zeros(*shape[:-2], d_out, device=gen_dev)
        return p

    def norm(width):
        return {"scale": torch.ones(n, width, device=gen_dev)}

    def experts(d_in, d_out):
        return {"kernel": torch.randn(n, cfg.num_experts, d_in, d_out,
                                      generator=generator, device=gen_dev)
                / math.sqrt(d_in)}

    layers = {"attn_norm": norm(d),
              "q": lin(d, cfg.heads * hd, cfg.qkv_bias),
              "k": lin(d, cfg.kv_heads * hd, cfg.qkv_bias),
              "v": lin(d, cfg.kv_heads * hd, cfg.qkv_bias),
              "o": lin(cfg.heads * hd, d),
              "mlp_norm": norm(d)}
    if cfg.num_experts:
        fe = cfg.moe_ffn
        layers["router"] = lin(d, cfg.num_experts)
        layers["experts"] = {"gate": experts(d, fe), "up": experts(d, fe),
                             "down": experts(fe, d)}
    else:
        layers.update(gate=lin(d, cfg.ffn), up=lin(d, cfg.ffn),
                      down=lin(cfg.ffn, d))
    if cfg.qk_norm:
        layers["q_norm"] = norm(hd)
        layers["k_norm"] = norm(hd)
    params = {"embed": torch.randn(cfg.vocab_size, d, generator=generator,
                                   device=gen_dev) * 0.02,
              "layers": layers,
              "norm": {"scale": torch.ones(d, device=gen_dev)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size, stack=False)
    return tree_map(lambda t: t.to(device), params)


# ------------------------------------------------------------ primitives --
def rms_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 statistics, cast back to x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * p["scale"]).to(x.dtype)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the HF half-split rotary embedding, float32, shaped to
    broadcast over [B, H, T, head_dim / 2]: positions [T] give [1, 1, T,
    hd/2], positions [B, T] give [B, 1, T, hd/2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv           # [(B,) T, hd/2]
    ang = ang[None, None] if positions.dim() == 1 else ang[:, None]
    return torch.cos(ang), torch.sin(ang)


def _rope(x: torch.Tensor, rope) -> torch.Tensor:
    cos, sin = rope
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _heads(y: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    b, t, _ = y.shape
    return y.reshape(b, t, heads, hd).transpose(1, 2)


class LMKVCache(NamedTuple):
    """Layer-stacked self-attention cache, k/v [L, B, kvH, max_len, hd];
    the decode steps write it IN PLACE."""
    k: torch.Tensor
    v: torch.Tensor


Pos = Union[int, torch.Tensor]


def _to_model(p: Params) -> Params:
    """A replicated parameter dict read by a rank-partitioned computation
    (its heads or experts): Megatron's f on each tensor, so its gradient,
    a partial sum on each rank, is all-reduced over 'model'."""
    return {k: copy_to_model(v) for k, v in p.items()}


def _kv_select(cfg: CausalLMConfig, hq: int) -> Tuple[list, bool]:
    """The whole-tree KV heads this rank's ``hq`` query heads read, as an
    index list, and whether they form uniform GQA groups (each KV head
    read by the same run of consecutive query heads): then the cache holds
    each KV head once, else one per query head."""
    g = cfg.heads // cfg.kv_heads
    idx = [(model_rank() * hq + i) // g for i in range(hq)]
    kvs = sorted(set(idx))
    rep = hq // len(kvs)
    uniform = hq % len(kvs) == 0 and idx == [kv for kv in kvs
                                             for _ in range(rep)]
    return (kvs if uniform else idx), uniform


def lm_cache_heads(params: Params, cfg: CausalLMConfig) -> int:
    """The KV heads a rank's decode cache holds: kv_heads / tp when the
    k/v projections are cut by whole heads, else the heads its query heads
    read (``_kv_select``); all of them without TP."""
    layers = params["layers"]
    hd = cfg.head_dim
    hq = _width(layers["q"]) // hd
    if not tp_active(hq * hd, cfg.heads * hd, "attention q"):
        return cfg.kv_heads
    kw = _width(layers["k"])
    if kw < cfg.kv_heads * hd and kw % hd == 0:
        return kw // hd
    return len(_kv_select(cfg, hq)[0])


def _attn_block(layer: Params, cfg: CausalLMConfig, x: torch.Tensor, rope,
                *, mask: Optional[torch.Tensor] = None, causal: bool = False,
                cache: Optional[LMKVCache] = None, pos: Optional[Pos] = None,
                layer_idx: int = 0) -> torch.Tensor:
    """Pre-norm GQA self-attention. Without ``cache``: ``causal`` plus an
    optional key-padding ``mask`` [B or 1, 1, 1 or Tq, Tk] through
    ``dot_product_attention``. With it: the new K/V rows land in layer
    ``layer_idx`` of the stacked cache at ``pos`` (an int: rows pos..pos+T-1;
    a [B] tensor: row b at pos[b]) and ``decode_attention_stacked`` reads
    keys <= pos (+ the query row)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(layer["attn_norm"], x, cfg.rms_eps)
    hq = _width(layer["q"]) // hd
    tp = tp_active(hq * hd, cfg.heads * hd, "attention q")
    kp, vp = layer["k"], layer["v"]
    kw = _width(kp)
    whole_kv = tp and not (kw < cfg.kv_heads * hd and kw % hd == 0)
    if tp:
        h = copy_to_model(h)
        if kw == cfg.kv_heads * hd:        # replicated k/v, partial use
            kp, vp = _to_model(kp), _to_model(vp)
    q = _heads(_col_dense(layer["q"], h), hq, hd)
    k, v = _col_dense(kp, h), _col_dense(vp, h)
    if whole_kv and kw < cfg.kv_heads * hd:
        # k/v cut inside a head (kv_heads does not divide the axis, its
        # width does): gather the whole heads; the gradient, partial on
        # each rank, is reduce-scattered back
        group = axis_group(current_mesh(), "model")
        k, v = gather_for_use(k, group, 2), gather_for_use(v, group, 2)
    k = _heads(k, k.shape[-1] // hd, hd)
    v = _heads(v, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        qn, kn = layer["q_norm"], layer["k_norm"]
        if tp:                              # each rank normalises its heads
            qn, kn = _to_model(qn), _to_model(kn)
        q = rms_norm(qn, q, cfg.rms_eps)
        k = rms_norm(kn, k, cfg.rms_eps)
    if whole_kv:
        sel, _ = _kv_select(cfg, hq)
        ix = torch.tensor(sel, device=k.device)
        k, v = k.index_select(1, ix), v.index_select(1, ix)
    q = _rope(q, rope)                     # contiguous (a concatenation)
    k = _rope(k, rope)
    if cache is not None:
        if isinstance(pos, int):
            cache.k[layer_idx, :, :, pos: pos + t] = k
            cache.v[layer_idx, :, :, pos: pos + t] = v
            at = pos
        else:
            # per-slot decode depths: row b's new K/V at (layer, b, :, pos[b])
            bidx = torch.arange(b, device=x.device)
            cache.k[layer_idx, bidx, :, pos] = k[:, :, 0]
            cache.v[layer_idx, bidx, :, pos] = v[:, :, 0]
            at = pos.to(torch.int32)
        out = decode_attention_stacked(q, cache, layer_idx, pos=at,
                                       scale=hd ** -0.5)
    else:
        out = dot_product_attention(q, k, v.contiguous(), causal=causal,
                                    mask=mask, scale=hd ** -0.5)
    out = out.transpose(1, 2).reshape(b, t, hq * hd)
    return _row_dense(layer["o"], out, tp)


def _mlp_block(layer: Params, cfg: CausalLMConfig,
               x: torch.Tensor) -> torch.Tensor:
    if "router" in layer:
        return _moe_block(layer, cfg, x)
    h = rms_norm(layer["mlp_norm"], x, cfg.rms_eps)
    tp = tp_active(_width(layer["gate"]), cfg.ffn, "mlp gate")
    if tp:
        h = copy_to_model(h)
    return _row_dense(layer["down"], F.silu(_col_dense(layer["gate"], h))
                      * _col_dense(layer["up"], h), tp)


# ------------------------------------------------------------------- MoE --
def _moe_router(layer: Params, cfg: CausalLMConfig, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top-k weights [N, k] in h's dtype, expert ids [N, k], router logits
    [N, E]): HF Qwen3MoeSparseMoeBlock's routing -- a softmax over ALL
    experts in float32, then the top k, then the optional renormalisation.
    The logits feed ``load_balance_loss``."""
    logits = dense(layer["router"], h)
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return w.to(h.dtype), idx, logits


def load_balance_loss(router_logits: torch.Tensor, num_experts: int,
                      top_k: int,
                      attention_mask: Optional[torch.Tensor] = None,
                      group=None) -> torch.Tensor:
    """The Switch-Transformer load-balancing aux loss (eqs. 4-6), HF
    ``load_balancing_loss_func``'s: the fraction of tokens routed to each
    expert (per top-k slot) times its mean router probability, summed, x E.

    router_logits [L, N, E] as ``lm_forward(..., return_router_logits=True)``
    returns them (N = B T); attention_mask [B, T] (1 = real) masks padding
    out of both statistics.

    ``group``: the data-parallel process group when each rank holds its
    rows of the batch; the statistics are then the whole batch's (the sums
    all-reduced, the router probabilities' differentiably)."""
    l, n, e = router_logits.shape
    probs = torch.softmax(router_logits.reshape(l * n, e).float(), dim=-1)
    sel = torch.topk(probs, top_k, dim=-1).indices
    sel_mask = F.one_hot(sel, e).float()                    # [LN, k, E]
    am = (attention_mask.reshape(-1).float().repeat(l)     # jnp.tile
          if attention_mask is not None else None)
    if group is None:
        if am is None:
            tokens_per_expert = sel_mask.mean(0)            # [k, E]
            router_prob = probs.mean(0)                     # [E]
        else:
            denom = am.sum()
            tokens_per_expert = (sel_mask * am[:, None, None]).sum(0) / denom
            router_prob = (probs * am[:, None]).sum(0) / denom
    else:
        am = torch.ones(l * n, device=probs.device) if am is None else am
        stats = sum_over(torch.cat([
            (sel_mask * am[:, None, None]).sum(0).reshape(-1),
            (probs * am[:, None]).sum(0), am.sum()[None]]), group)
        denom = stats[-1]
        tokens_per_expert = stats[: top_k * e].reshape(top_k, e) / denom
        router_prob = stats[top_k * e: -1] / denom
    return (tokens_per_expert * router_prob[None, :]).sum() * num_experts


def _expert_weights(p: Params, dtype) -> Tuple[torch.Tensor,
                                               Optional[torch.Tensor]]:
    """One layer's expert kernels [E, K, N] in ``dtype`` and the int8
    per-(expert, output channel) scales [E, N] (None otherwise). int4
    experts dequantize whole: the prefill and training path, where every
    expert's weights are read anyway."""
    if "kernel_q4" in p:
        return dequantize_int4(p["kernel_q4"], p["kernel_scale4"], dtype), None
    if "kernel_q" in p:
        return p["kernel_q"].to(dtype), p["kernel_scale"]
    return p["kernel"].to(dtype), None


def _ragged(xr: torch.Tensor, wk: torch.Tensor, sizes) -> torch.Tensor:
    """``lax.ragged_dot``: rows grouped by expert (``sizes`` rows each, in
    expert order) times their expert's [K, N] kernel -> [rows, N]. The rows
    and the experts are taken by ``split`` and ``unbind``, whose backward
    writes each input's gradient once (a slice or an index a group would
    allocate and fill a whole-size gradient per group)."""
    outs = [x @ w for x, w, c in zip(xr.split(sizes), wk.unbind(0), sizes)
            if c]
    return torch.cat(outs) if outs else xr.new_zeros(0, wk.shape[-1])


def _moe_experts(ex: Params, h: torch.Tensor, idx: torch.Tensor,
                 w: torch.Tensor, impl: str) -> torch.Tensor:
    """The expert FFN of the ``ragged`` or ``dense`` impl (module
    docstring) over the router's selections: h [N, d], expert ids and
    weights [N, k] -> [N, d]. ``ex``: {gate, up, down} of one layer's
    float, int8 or int4 expert leaves."""
    n, d = h.shape
    k = idx.shape[1]
    gk, gsc = _expert_weights(ex["gate"], h.dtype)          # [E, d, fe]
    uk, usc = _expert_weights(ex["up"], h.dtype)
    dk, dsc = _expert_weights(ex["down"], h.dtype)          # [E, fe, d]
    if impl == "dense":
        comb = torch.zeros(n, gk.shape[0], dtype=w.dtype,
                           device=w.device).scatter_add(1, idx, w)

        def scale(t_, s_):                                  # t_ [E, N, out]
            return t_ if s_ is None else t_ * s_[:, None, :].to(t_.dtype)

        g = scale(torch.einsum("nd,edf->enf", h, gk), gsc)
        u = scale(torch.einsum("nd,edf->enf", h, uk), usc)
        o = scale(torch.einsum("enf,efd->end", F.silu(g) * u, dk), dsc)
        return torch.einsum("end,ne->nd", o, comb)
    if impl != "ragged":
        raise ValueError(f"unknown moe_impl {impl!r}")
    fidx = idx.reshape(-1)                                  # [N k]
    order = torch.argsort(fidx, stable=True)
    xr = h[order // k]                                      # [N k, d]
    sizes = torch.bincount(fidx, minlength=gk.shape[0]).tolist()
    row_e = fidx[order]                                     # row -> expert

    def scale(t_, s_):                                      # t_ [N k, out]
        return t_ if s_ is None else t_ * s_[row_e].to(t_.dtype)

    g = scale(_ragged(xr, gk, sizes), gsc)
    u = scale(_ragged(xr, uk, sizes), usc)
    o = scale(_ragged(F.silu(g) * u, dk, sizes), dsc)
    o = o[torch.argsort(order)].reshape(n, k, d)            # slot order
    return torch.einsum("nkd,nk->nd", o, w)


def _moe_block(layer: Params, cfg: CausalLMConfig, x: torch.Tensor,
               return_router_logits: bool = False):
    """The sparse-MoE SwiGLU FFN of one layer (module docstring): x [B, T,
    d] -> [B, T, d] (and the router logits [B T, E])."""
    b, t, d = x.shape
    n = b * t
    h = rms_norm(layer["mlp_norm"], x, cfg.rms_eps).reshape(n, d)
    w, idx, router_logits = _moe_router(layer, cfg, h)
    ex = layer["experts"]
    gate = ex["gate"]
    el = (gate.get("kernel", gate.get("kernel_q", gate.get("kernel_q4")))
          .shape[0])
    if tp_active(el, cfg.num_experts, "experts"):
        y = _moe_local_experts(ex, cfg, h, idx, w)
    elif (("kernel_q" in gate or "kernel_q4" in gate)
            and cfg.moe_impl == "ragged"
            and n * cfg.experts_per_tok <= cfg.num_experts):
        y = _moe_selected_scan(ex, cfg, h, idx, w)
    else:
        y = _moe_experts(ex, h, idx, w, cfg.moe_impl)
    out = y.reshape(b, t, d)
    return (out, router_logits) if return_router_logits else out


def _moe_local_experts(ex: Params, cfg: CausalLMConfig, h: torch.Tensor,
                       idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense impl over this rank's block of experts (the expert axis
    sharded over 'model'): every token through the local experts, combined
    by their columns of the router-weight matrix, the partial sums
    all-reduced. The replicated router's weights and ``h`` meet the
    rank-partitioned experts through Megatron's f."""
    n = h.shape[0]
    comb = torch.zeros(n, cfg.num_experts, dtype=w.dtype,
                       device=w.device).scatter_add(1, idx, w)
    comb = copy_to_model(comb)[:, local_block(cfg.num_experts)]
    hin = copy_to_model(h)
    gk, gsc = _expert_weights(ex["gate"], h.dtype)          # [E/tp, d, fe]
    uk, usc = _expert_weights(ex["up"], h.dtype)
    dk, dsc = _expert_weights(ex["down"], h.dtype)

    def scale(t_, s_):                                      # t_ [E, N, out]
        return t_ if s_ is None else t_ * s_[:, None, :].to(t_.dtype)

    g = scale(torch.einsum("nd,edf->enf", hin, gk), gsc)
    u = scale(torch.einsum("nd,edf->enf", hin, uk), usc)
    o = scale(torch.einsum("enf,efd->end", F.silu(g) * u, dk), dsc)
    return reduce_from_model(torch.einsum("end,ne->nd", o, comb))


def _moe_selected_scan(ex: Params, cfg: CausalLMConfig, h: torch.Tensor,
                       idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The selected-experts MoE FFN of JAX's decode path for quantized
    experts: the n k (token, expert) slots in JAX's order (token-major),
    each slot's gate, up and down reading ONLY its expert's stored bytes,
    its router-weighted output added to ``acc`` in h's dtype, slot by slot
    (JAX's ``acc`` is ``jnp.zeros((n, d), h.dtype)``). int4 experts run
    kernel K9 with the slot's expert id handed over as a device tensor, a
    view of the router's top-k output; int8 and float experts are selected
    by ``index_select``. Nothing here reads a tensor on the host."""
    n, d = h.shape
    k = cfg.experts_per_tok
    fidx = idx.reshape(-1)                                  # [n k]
    ww = w.reshape(-1)

    def mat(name, e, x):
        p = ex[name]
        if "kernel_q4" in p:
            return int4_matmul(x, p["kernel_q4"], p["kernel_scale4"],
                               layer=e)
        if "kernel_q" in p:
            m = p["kernel_q"].index_select(0, e)[0]
            sc = p["kernel_scale"].index_select(0, e)[0]
            return (x @ m.to(x.dtype)) * sc.to(x.dtype)
        return x @ p["kernel"].index_select(0, e)[0].to(x.dtype)

    acc = torch.zeros(n, d, dtype=h.dtype, device=h.device)
    for j in range(n * k):
        t = j // k
        e = fidx[j: j + 1]                                  # on the device
        x = h[t: t + 1]
        g = F.silu(mat("gate", e, x)) * mat("up", e, x)
        acc[t: t + 1] += mat("down", e, g) * ww[j: j + 1].to(acc.dtype)
    return acc


# ------------------------------------------------------------- forward ----
def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype=torch.float32,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """The token embedding; ``vocab`` (the config's) lets a vocab-sharded
    table (TP) take the vocab-parallel lookup."""
    if vocab is not None and "embed" in params:
        emb = vocab_embed(params["embed"], tokens, vocab)
        if emb is not None:
            return emb.to(dtype)
    return embed_lookup(params, tokens, dtype)


def forward_with_embeds(params: Params, cfg: CausalLMConfig,
                        embeds: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None,
                        dtype=torch.float32,
                        return_router_logits: bool = False,
                        remat=False):
    """Hidden states [B, T, d] (before the logits) from input embeddings
    [B, T, d] (the two-tower fusion's entry point). ``attention_mask`` [B,
    T], 1 = real: padding is masked from the keys (which takes the
    materialised twin); without it the causal attention rides the flash
    path. ``remat`` (False | True | "dots") checkpoints each layer
    (``models/whisper.py:_remat_body``; the training path).
    ``return_router_logits`` (MoE configs; the training aux loss) also
    returns each layer's router logits stacked, [L, B T, E], from inside
    the checkpointed layer body."""
    if return_router_logits and cfg.num_experts == 0:
        raise ValueError("return_router_logits requires an MoE config "
                         "(num_experts > 0)")
    b, t, _ = embeds.shape
    x = embeds.to(dtype)
    rope = _rope_tables(torch.arange(t, device=x.device), cfg.head_dim,
                       cfg.rope_theta)
    mask = (attention_mask[:, None, None, :].bool()
            if attention_mask is not None else None)

    def body(x, layer):
        x = x + _attn_block(layer, cfg, x, rope, mask=mask, causal=True)
        if return_router_logits:
            y, rl = _moe_block(layer, cfg, x, return_router_logits=True)
            return x + y, rl
        return x + _mlp_block(layer, cfg, x)

    body = _remat_body(body, remat)
    router = []
    for li in range(cfg.layers):
        x = body(x, layer_params(params["layers"], li))
        if return_router_logits:
            x, rl = x
            router.append(rl)
    hidden = rms_norm(params["norm"], x, cfg.rms_eps)
    if return_router_logits:
        return hidden, torch.stack(router)
    return hidden


def lm_logits(params: Params, cfg: CausalLMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits (or the separate ``lm_head``): [..., V],
    all-gathered over 'model' from a vocab-sharded table or head."""
    if cfg.tie_embeddings or not any(k.startswith("lm_head")
                                     for k in params):
        y = (vocab_logits(params["embed"], hidden, cfg.vocab_size)
             if "embed" in params else None)
        return y if y is not None else embed_logits(params, hidden)
    head = params["lm_head"]
    if "kernel" in head and tp_active(head["kernel"].shape[-1],
                                      cfg.vocab_size, "lm_head"):
        y = copy_to_model(hidden) @ head["kernel"].to(hidden.dtype)
        if "bias" in head:
            y = y + head["bias"][local_block(cfg.vocab_size)].to(y.dtype)
        return gather_from_model(y, dim=-1)
    return dense(head, hidden)


def lm_forward(params: Params, cfg: CausalLMConfig, tokens: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               dtype=torch.float32, return_router_logits: bool = False,
               remat=False):
    """tokens [B, T] -> logits [B, T, V]; with ``return_router_logits`` (MoE
    configs) also the stacked router logits [L, B T, E] (feed them to
    ``load_balance_loss`` with the same attention_mask). ``remat``
    checkpoints each layer (training path)."""
    out = forward_with_embeds(params, cfg,
                              embed_tokens(params, tokens, dtype,
                                           cfg.vocab_size),
                              attention_mask, dtype,
                              return_router_logits=return_router_logits,
                              remat=remat)
    if return_router_logits:
        hidden, router = out
        return lm_logits(params, cfg, hidden), router
    return lm_logits(params, cfg, out)


# ---------------------------------------------------------------- decode --
def init_lm_cache(cfg: CausalLMConfig, batch: int, max_len: int,
                  dtype=torch.float32, device: DeviceLike = None,
                  heads: Optional[int] = None) -> LMKVCache:
    """Zeroed [L, B, kvH, max_len, hd] cache; ``heads`` the KV heads this
    rank holds (``lm_cache_heads``; default all)."""
    device = resolve_device(device)
    shape = (cfg.layers, batch, heads or cfg.kv_heads, max_len, cfg.head_dim)
    return LMKVCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def lm_decode_step(params: Params, cfg: CausalLMConfig,
                   embed: torch.Tensor, pos: Pos, cache: LMKVCache,
                   dtype=torch.float32) -> Tuple[torch.Tensor, LMKVCache]:
    """One autoregressive step from an input EMBEDDING [B, d] (so the
    two-tower fusion reuses it). ``pos``: an int (every row at that depth)
    or a per-slot [B] integer tensor on the model's device (each row writes
    its K/V at its own depth and attends keys <= pos[b]). Returns (logits
    [B, V], the cache, updated in place). MoE layers with quantized
    experts take ``_moe_selected_scan`` while B k <= E."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 0:
        pos = int(pos)
    x = embed.to(dtype)[:, None, :]
    if isinstance(pos, int):
        positions = torch.tensor([pos], device=x.device)
    else:
        pos = pos.long()
        positions = pos[:, None]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for li in range(cfg.layers):
        layer = layer_params(params["layers"], li)
        x = x + _attn_block(layer, cfg, x, rope, cache=cache, pos=pos,
                            layer_idx=li)
        x = x + _mlp_block(layer, cfg, x)
    hidden = rms_norm(params["norm"], x, cfg.rms_eps)
    return lm_logits(params, cfg, hidden)[:, 0], cache


# ----------------------------------------------------------------- vocab --
def resize_embeddings(params: Params, cfg: CausalLMConfig, new_vocab: int,
                      generator: torch.Generator
                      ) -> Tuple[Params, CausalLMConfig]:
    """Extend (or shrink) the token embedding to ``new_vocab`` rows; new
    rows are the mean of the existing rows plus 0.02 x normal noise from
    ``generator`` (HF resize_token_embeddings semantics; the reference's
    matched-pair contract, music2midi/README.md:16-26). The noise is
    drawn on the generator's device."""
    embed = params["embed"]
    old_vocab = embed.shape[0]

    def noise(*shape):
        return torch.randn(*shape, generator=generator,
                           device=generator.device).to(embed.device,
                                                       embed.dtype)

    if new_vocab <= old_vocab:
        new_embed = embed[:new_vocab]
    else:
        extra = embed.mean(0, keepdim=True) + 0.02 * noise(
            new_vocab - old_vocab, embed.shape[1])
        new_embed = torch.cat([embed, extra], 0)
    out = dict(params)
    out["embed"] = new_embed
    if "lm_head" in params:
        head = params["lm_head"]["kernel"]
        if new_vocab <= old_vocab:
            new_head = head[:, :new_vocab]
        else:
            extra = head.mean(1, keepdim=True) + 0.02 * noise(
                head.shape[0], new_vocab - old_vocab)
            new_head = torch.cat([head, extra], 1)
        out["lm_head"] = {**params["lm_head"], "kernel": new_head}
        if "bias" in params["lm_head"]:
            bias = params["lm_head"]["bias"]
            nb = torch.zeros(new_vocab, dtype=bias.dtype, device=bias.device)
            keep = min(old_vocab, new_vocab)
            nb[:keep] = bias[:keep]
            out["lm_head"]["bias"] = nb
    return out, dataclasses.replace(cfg, vocab_size=new_vocab)


# ------------------------------------------------------------------ port --
def port_causal_lm_state_dict(sd: Mapping, hc, *, device: DeviceLike = None
                              ) -> Tuple[Params, CausalLMConfig]:
    """Port an HF Qwen2/Qwen3/Qwen3-MoE/LLaMA-style ForCausalLM state dict
    (tensors of any float dtype, e.g. ``models/hf_files.py:
    read_state_dict`` of a local directory) with its config (the HF object
    or the ``config.json`` dict): (params, float32 on ``device``, config).
    MoE covers the homogeneous every-layer-sparse stacks the released
    Qwen3-MoE checkpoints use (layers are stacked, so a mixed dense/sparse
    stack raises ``NotImplementedError``). Each tensor is read once, when
    its stacked leaf is built."""
    device = resolve_device(device)
    keys = list(sd)

    def t(name: str) -> torch.Tensor:
        v = sd[name]
        v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        return v.to(device, torch.float32)

    # a tied lm_head still appears in state_dict: trust the config flag
    tie = bool(config_value(hc, "tie_word_embeddings",
                       "lm_head.weight" not in keys))
    moe = any(k.endswith("mlp.experts.0.gate_proj.weight") for k in keys)
    if moe and (list(config_value(hc, "mlp_only_layers", []) or [])
                or int(config_value(hc, "decoder_sparse_step", 1) or 1) != 1):
        raise NotImplementedError("mixed dense/sparse layer stacks are not "
                                  "supported (stacked homogeneous layers "
                                  "only)")
    rope = config_value(hc, "rope_theta", None)
    if rope is None:
        rope = (config_value(hc, "rope_parameters", None) or {}).get(
            "rope_theta", 1e6)
    heads = config_value(hc, "num_attention_heads")
    cfg = CausalLMConfig(
        vocab_size=config_value(hc, "vocab_size"),
        d_model=config_value(hc, "hidden_size"),
        layers=config_value(hc, "num_hidden_layers"), heads=heads,
        kv_heads=config_value(hc, "num_key_value_heads", heads) or heads,
        # Qwen3 decouples head_dim from hidden_size // heads
        head_dim=int(config_value(hc, "head_dim", 0) or 0),
        ffn_dim=config_value(hc, "intermediate_size"),
        rope_theta=float(rope),
        rms_eps=float(config_value(hc, "rms_norm_eps", 1e-6)),
        qkv_bias=any(k.endswith("self_attn.q_proj.bias") for k in keys),
        qk_norm=any(k.endswith("self_attn.q_norm.weight") for k in keys),
        tie_embeddings=tie,
        max_seq=config_value(hc, "max_position_embeddings", 2048),
        num_experts=int(config_value(hc, "num_experts", 0)) if moe else 0,
        experts_per_tok=(int(config_value(hc, "num_experts_per_tok", 0))
                         if moe else 0),
        moe_ffn_dim=(int(config_value(hc, "moe_intermediate_size", 0))
                     if moe else 0),
        norm_topk_prob=bool(config_value(hc, "norm_topk_prob", True)))

    def stack(fn):
        return torch.stack([fn(i) for i in range(cfg.layers)])

    def lin(proj):
        p = {"kernel": stack(lambda i: t(
            f"model.layers.{i}.{proj}.weight").t())}
        if f"model.layers.0.{proj}.bias" in sd:
            p["bias"] = stack(lambda i: t(f"model.layers.{i}.{proj}.bias"))
        return p

    def scale(name):
        return {"scale": stack(lambda i: t(f"model.layers.{i}.{name}"))}

    layers: Params = {
        "attn_norm": scale("input_layernorm.weight"),
        "q": lin("self_attn.q_proj"), "k": lin("self_attn.k_proj"),
        "v": lin("self_attn.v_proj"), "o": lin("self_attn.o_proj"),
        "mlp_norm": scale("post_attention_layernorm.weight"),
    }
    if moe:
        layers["router"] = {"kernel": stack(lambda i: t(
            f"model.layers.{i}.mlp.gate.weight").t())}
        layers["experts"] = {
            name: {"kernel": stack(lambda i, proj=proj: torch.stack([
                t(f"model.layers.{i}.mlp.experts.{e}.{proj}.weight").t()
                for e in range(cfg.num_experts)]))}
            for name, proj in (("gate", "gate_proj"), ("up", "up_proj"),
                               ("down", "down_proj"))}
    else:
        layers.update(gate=lin("mlp.gate_proj"), up=lin("mlp.up_proj"),
                      down=lin("mlp.down_proj"))
    if cfg.qk_norm:
        layers["q_norm"] = scale("self_attn.q_norm.weight")
        layers["k_norm"] = scale("self_attn.k_norm.weight")
    params: Params = {
        "embed": t("model.embed_tokens.weight"),
        "layers": layers,
        "norm": {"scale": t("model.norm.weight")},
    }
    if not tie:
        params["lm_head"] = {"kernel": t("lm_head.weight").t()}
    return tree_map(lambda x: x.contiguous(), params), cfg


def port_causal_lm_from_hf(hf_model, *, device: DeviceLike = None
                           ) -> Tuple[Params, CausalLMConfig]:
    """Port an in-memory HF Qwen2/Qwen3/Qwen3-MoE/LLaMA-style ForCausalLM
    (no network): ``port_causal_lm_state_dict`` of its state dict and
    config."""
    return port_causal_lm_state_dict(hf_model.state_dict(), hf_model.config,
                                     device=device)
