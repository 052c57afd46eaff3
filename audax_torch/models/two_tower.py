"""Two-tower audio -> ABC transcription model in PyTorch (port of
``audax/models/two_tower.py``).

  frozen Whisper encoder  ->  cross-attention adapter  ->  causal LM
  (models/whisper.encode)     (text queries, audio K/V)   (models/causal_lm)

The adapter fuses every text embedding with the audio states: text-query
cross-attention and a GELU FFN with post-LN residuals (LayerNorm eps
1e-5), its ``out`` and ``ffn_out`` projections zero-initialised
("zero-gated"), so at step 0 the LM sees LN(LN(text)). It is independent
of the text position, so a decode step applies it to one token against
cross-K/V projected once per clip (``adapter_cross_kv``).

Attention sites on the card: the teacher-forced ``forward`` runs the
adapter's cross-attention (q T x kv S) and the LM's causal GQA
self-attention through ``dot_product_attention`` (kernel K2 where
``flash_applicable`` holds: at least 16 query rows); a decode step's
one-row adapter query takes the materialised twin, as in JAX, and the LM
step reads its stacked cache through K3. The encoder runs K2 too, and the
log-mel of the callers (``infer/continuous.py``, ``cli/main.py``) K1.

``generate`` is the JAX ``lax.while_loop`` as a host loop with one host
read of the ``done`` flags a step; sampling at a temperature draws from a
``torch.Generator`` (parity with JAX holds at temperature 0). Training
(the dual-LR optimizer and the step) is ``train/two_tower.py``. The LM may
be a mixture-of-experts decoder (``models/causal_lm.py``): its decode steps
then take the selected-experts scan where its experts are quantized, and
``loss_sum`` adds the Switch load-balancing aux loss when
``cfg.moe_aux_coef > 0``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from audax_torch.core.config import TwoTowerConfig, WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.causal_lm import (CausalLMConfig, embed_tokens,
                                          forward_with_embeds,
                                          init_causal_lm, init_lm_cache,
                                          lm_decode_step, lm_logits,
                                          load_balance_loss,
                                          resize_embeddings)
from audax_torch.models.whisper import (_gelu, dense, encode,
                                        init_whisper_params, layer_norm,
                                        tree_map)
from audax_torch.ops.attention import dot_product_attention

Params = Dict[str, Any]

__all__ = ["TwoTowerModel", "init_adapter", "adapter_apply",
           "adapter_cross_kv", "adapter_apply_kv", "build_two_tower",
           "two_tower_step"]


# ----------------------------------------------------------- adapter ------
def init_adapter(generator: torch.Generator, audio_dim: int, text_dim: int,
                 heads: int = 8, ffn_mult: int = 4, *,
                 device: DeviceLike = None) -> Params:
    """Near-identity ("zero-gated") init: the cross-attention ``out`` and
    ``ffn_out`` projections start at ZERO, so the adapter starts as
    LN(LN(text)) and audio enters through the learned output gates (the
    JAX ``init_adapter``'s recipe and scales; normal draws from
    ``generator`` on its device, then moved to ``device``). ``heads`` only
    sets the head split the callers use."""
    device = resolve_device(device)
    g = generator.device

    def lin(d_in, d_out):
        return {"kernel": torch.randn(d_in, d_out, generator=generator,
                                      device=g) / math.sqrt(d_in),
                "bias": torch.zeros(d_out, device=g)}

    def zero(d_in, d_out):
        return {"kernel": torch.zeros(d_in, d_out, device=g),
                "bias": torch.zeros(d_out, device=g)}

    def ln():
        return {"scale": torch.ones(text_dim, device=g),
                "bias": torch.zeros(text_dim, device=g)}

    p = {"audio_proj": lin(audio_dim, text_dim),
         "q": lin(text_dim, text_dim), "k": lin(text_dim, text_dim),
         "v": lin(text_dim, text_dim), "out": zero(text_dim, text_dim),
         "ln1": ln(), "ln2": ln(),
         "ffn_in": lin(text_dim, ffn_mult * text_dim),
         "ffn_out": zero(ffn_mult * text_dim, text_dim)}
    return tree_map(lambda t: t.to(device), p)


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2).contiguous()


def adapter_cross_kv(p: Params, audio: torch.Tensor, heads: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from encoder states: [B, S, da] -> (k, v) each
    [B, H, S, hd]. A function of the (frozen) audio tower only, so decode
    loops compute it ONCE per clip."""
    akv = dense(p["audio_proj"], audio)
    return _split(dense(p["k"], akv), heads), _split(dense(p["v"], akv),
                                                      heads)


def adapter_apply_kv(p: Params, text: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Adapter forward from precomputed cross-K/V: text [B, T, d] + k/v
    [B, H, S, hd] -> fused [B, T, d]."""
    b, t, d = text.shape
    heads = k.shape[1]
    q = _split(dense(p["q"], text), heads)
    attn = dot_product_attention(q, k, v, scale=(d // heads) ** -0.5)
    attn = dense(p["out"], attn.transpose(1, 2).reshape(b, t, d))
    x = layer_norm(p["ln1"], text + attn)
    h = dense(p["ffn_out"], _gelu(dense(p["ffn_in"], x)))
    return layer_norm(p["ln2"], x + h)


def adapter_apply(p: Params, text: torch.Tensor, audio: torch.Tensor,
                  heads: int = 8) -> torch.Tensor:
    """Fuse text embeds [B, T, d] with audio states [B, S, da]
    (reference :157-188)."""
    k, v = adapter_cross_kv(p, audio.to(text.dtype), heads)
    return adapter_apply_kv(p, text, k, v)


def _child_generators(generator: torch.Generator, n: int
                      ) -> Tuple[torch.Generator, ...]:
    """``n`` independent generators on ``generator``'s device, seeded from
    it (the JAX ``jax.random.split``: each part's draw does not depend on
    which other parts are drawn)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return tuple(torch.Generator(device=generator.device).manual_seed(s)
                 for s in seeds)


def build_two_tower(cfg: TwoTowerConfig, audio_cfg: WhisperConfig,
                    lm_cfg: CausalLMConfig, vocab_size: int,
                    generator: torch.Generator, *,
                    audio_params: Optional[Params] = None,
                    lm_params: Optional[Params] = None,
                    device: DeviceLike = None) -> "TwoTowerModel":
    """Assemble the model on ``device``: (optionally given) towers + a fresh
    adapter, with the LM embedding resized to the extended ABC vocab (the
    reference's resize_token_embeddings contract, model.py:217-224). The
    audio tower, LM, adapter and resize noise draw from four generators
    seeded from ``generator``."""
    device = resolve_device(device)
    g_audio, g_lm, g_adapter, g_resize = _child_generators(generator, 4)
    if audio_params is None:
        audio_params = init_whisper_params(audio_cfg, g_audio, device=device)
    if lm_params is None:
        lm_params = init_causal_lm(lm_cfg, g_lm, device=device)
    audio_params = tree_map(lambda t: t.to(device), audio_params)
    lm_params = tree_map(lambda t: t.to(device), lm_params)
    if vocab_size != lm_cfg.vocab_size:
        lm_params, lm_cfg = resize_embeddings(lm_params, lm_cfg, vocab_size,
                                              g_resize)
    adapter = init_adapter(g_adapter, audio_cfg.d_model, lm_cfg.d_model,
                           heads=cfg.adapter_heads,
                           ffn_mult=cfg.adapter_ffn_mult, device=device)
    return TwoTowerModel(audio_params, audio_cfg,
                         {"adapter": adapter, "lm": lm_params}, lm_cfg, cfg)


def two_tower_step(params: Params, lm_cfg: CausalLMConfig,
                   tokens: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   pos, cache, dtype=torch.float32):
    """One KV-cached decode step of every row: embed ``tokens`` [B], fuse
    them through the adapter against the precomputed cross-K/V
    (``adapter_cross_kv``), one LM step at ``pos`` (an int, or [B] per
    row). Returns (float32 logits [B, V], the updated cache); the caller
    masks and samples (the JAX ``step_embed`` + ``lm_decode_step`` of
    ``_generate_jit`` and ``_gen_chunk``)."""
    text = embed_tokens(params["lm"], tokens[:, None], dtype,
                        lm_cfg.vocab_size)
    emb = adapter_apply_kv(params["adapter"], text, ck, cv)[:, 0]
    logits, cache = lm_decode_step(params["lm"], lm_cfg, emb, pos, cache,
                                   dtype)
    return logits.float(), cache


def _allowed_mask(allowed_ids, end_id: int, vocab: int,
                  device) -> Optional[torch.Tensor]:
    """[V] bool: the ``allowed_ids`` and ``end_id`` (None: no constraint)."""
    if allowed_ids is None:
        return None
    mask = torch.zeros(vocab, dtype=torch.bool, device=device)
    mask[torch.tensor(list(allowed_ids) + [end_id], dtype=torch.long,
                      device=device)] = True
    return mask


# ------------------------------------------------------------- model ------
class TwoTowerModel(NamedTuple):
    """Bundle of the three towers. ``audio_params`` (Whisper) is always
    frozen; ``params`` = {"adapter": ..., "lm": ...}."""

    audio_params: Params
    audio_cfg: WhisperConfig
    params: Params
    lm_cfg: CausalLMConfig
    cfg: TwoTowerConfig

    # -- audio tower ------------------------------------------------------
    def encode_audio(self, mel: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
        """Batched mel [B, T, n_mels] -> frozen encoder states."""
        with torch.no_grad():
            return encode(self.audio_params, self.audio_cfg, mel, dtype)

    # -- teacher-forced forward -------------------------------------------
    def forward(self, params: Params, enc: torch.Tensor,
                input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                dtype=torch.float32, return_router_logits: bool = False):
        """Teacher-forced logits [B, T, V]: every text position fused with
        the audio through the adapter (reference :263-288).
        ``return_router_logits`` (MoE decoders) also returns the stacked
        per-layer router logits [L, B T, E] for the aux loss."""
        text = embed_tokens(params["lm"], input_ids, dtype,
                            self.lm_cfg.vocab_size)
        fused = adapter_apply(params["adapter"], text, enc,
                              self.cfg.adapter_heads)
        out = forward_with_embeds(params["lm"], self.lm_cfg, fused,
                                  attention_mask, dtype,
                                  return_router_logits=return_router_logits)
        if return_router_logits:
            hidden, router = out
            return lm_logits(params["lm"], self.lm_cfg, hidden), router
        return lm_logits(params["lm"], self.lm_cfg, out)

    def loss_sum(self, params: Params, enc: torch.Tensor,
                 input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """(summed shifted CE over non-pad positions, token count): the
        un-normalised form gradient accumulation needs. MoE decoders with
        ``cfg.moe_aux_coef > 0`` add the Switch load-balancing aux loss
        over the non-pad positions as ``coef * aux * count``, so the
        normalised loss is ``CE_mean + coef * aux`` (per microbatch under
        accumulation, as in JAX)."""
        want_aux = self.lm_cfg.num_experts > 0 and self.cfg.moe_aux_coef > 0
        out = self.forward(params, enc, input_ids, attention_mask, dtype,
                           return_router_logits=want_aux)
        logits, router = out if want_aux else (out, None)
        shift = logits[:, :-1].float()
        labels = input_ids[:, 1:].long()
        mask = attention_mask[:, 1:].float()
        losses = F.cross_entropy(shift.reshape(-1, shift.shape[-1]),
                                 labels.reshape(-1), reduction="none")
        losses = losses.reshape(labels.shape)
        total, count = (losses * mask).sum(), mask.sum()
        if want_aux:
            aux = load_balance_loss(router, self.lm_cfg.num_experts,
                                    self.lm_cfg.experts_per_tok,
                                    attention_mask)
            total = total + self.cfg.moe_aux_coef * aux * count
        return total, count

    def loss(self, params: Params, enc: torch.Tensor,
             input_ids: torch.Tensor, attention_mask: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
        """Shifted CE with padding masked (labels = input_ids)."""
        total, count = self.loss_sum(params, enc, input_ids, attention_mask,
                                     dtype)
        return total / torch.clamp_min(count, 1.0)

    # -- generation (KV-cached) -------------------------------------------
    @torch.inference_mode()
    def generate(self, params: Params, enc: torch.Tensor, *,
                 start_id: int, end_id: int, max_len: int = 256,
                 temperature: float = 0.7,
                 generator: Optional[torch.Generator] = None,
                 allowed_ids: Optional[Sequence[int]] = None,
                 prompt_ids: Optional[Sequence[int]] = None,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample ABC ids [B, max_len]; returns (tokens, lengths).

        ``allowed_ids``: sampling constrained to this id set (+
        ``end_id``), a [V] mask folded into the logits. ``prompt_ids``: a
        teacher-forced prefix after ``start_id`` (the reference's ABC-header
        prompt, model.py:363-366); forced positions never end a row. The
        adapter's cross-K/V are computed once per clip. Temperature > 0
        draws from ``generator`` (a fresh one seeded 0 on enc's device when
        None)."""
        device = enc.device
        b = enc.shape[0]
        vocab = self.lm_cfg.vocab_size
        mask = _allowed_mask(allowed_ids, end_id, vocab, device)
        prompt = list(prompt_ids) if prompt_ids else []
        p_len = len(prompt)
        cache = init_lm_cache(self.lm_cfg, b, max_len, dtype, device=device)
        tokens = torch.full((b, max_len), end_id, dtype=torch.long,
                            device=device)
        tokens[:, 0] = start_id
        if p_len:
            tokens[:, 1: 1 + p_len] = torch.tensor(prompt, device=device)
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        ck, cv = adapter_cross_kv(params["adapter"], enc.to(dtype),
                                  self.cfg.adapter_heads)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        lengths = torch.full((b,), max_len, dtype=torch.long, device=device)
        for pos in range(max_len - 1):
            logits, cache = two_tower_step(params, self.lm_cfg,
                                           tokens[:, pos], ck, cv, pos,
                                           cache, dtype)
            if mask is not None:
                logits = logits.masked_fill(~mask[None], float("-inf"))
            if temperature == 0.0:
                nxt = logits.argmax(-1)
            else:
                probs = torch.softmax(logits / temperature, -1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            forced = pos < p_len          # positions 1..p_len are the prompt
            if forced:
                nxt = torch.full_like(nxt, prompt[pos])
            nxt = torch.where(done, end_id, nxt)
            tokens[:, pos + 1] = nxt
            newly = ~done & (nxt == end_id) & (not forced)
            lengths = torch.where(newly, pos + 2, lengths)
            done = done | newly
            if bool(done.all()):
                break
        return tokens, lengths
