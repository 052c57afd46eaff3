"""Checkpoint export: the port's parameter trees -> HF torch state dicts
(port of ``audax/models/export.py``).

The exact inverse of the import path (``models/port.py``,
``models/causal_lm.py:port_causal_lm_state_dict``): a fine-tune made by the
port (``finetune``, ``train-lm``, ``train-music``) goes back to the
transformers ecosystem as a standard local checkpoint directory
(``models/hf_files.py``). ``export(port(sd)) == sd`` bit for
bit, tied ``proj_out.weight`` / ``lm_head.weight`` aliases included.

The values are views of the parameters (a layer of a stacked leaf, a
transposed kernel), not copies: ``hf_files.write_state_dict`` makes each
contiguous on the host when it writes it, so an export never holds a second
copy of the tree. Quantized trees (``convert-hf --quantize``) are rejected:
their packed layouts have no HF container; export the float checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.models.whisper import tree_leaves

__all__ = ["export_whisper_state_dict", "export_causal_lm_state_dict",
           "hf_whisper_config_dict", "hf_causal_lm_config_dict"]


def _check_float_tree(params: Mapping) -> None:
    """Raise ``ValueError`` on a quantized tree (any integer leaf)."""
    if any(not (t.is_floating_point() or t.is_complex())
           for t in tree_leaves(params)):
        raise ValueError(
            "quantized param tree (int leaves) cannot be exported to an HF "
            "state_dict -- export from the float checkpoint instead")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked-layer tree (views)."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _put_ln(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]


def _put_linear(out: Dict[str, torch.Tensor], prefix: str,
                p: Mapping) -> None:
    out[f"{prefix}.weight"] = p["kernel"].t()
    if "bias" in p:
        out[f"{prefix}.bias"] = p["bias"]


def _put_attn(out: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    _put_linear(out, f"{prefix}.q_proj", p["q"])
    _put_linear(out, f"{prefix}.k_proj", p["k"])   # no bias (whisper layout)
    _put_linear(out, f"{prefix}.v_proj", p["v"])
    _put_linear(out, f"{prefix}.out_proj", p["out"])


def export_whisper_state_dict(params: Mapping, cfg: WhisperConfig
                              ) -> Dict[str, torch.Tensor]:
    """The port's Whisper params (stacked layers) -> an HF
    ``WhisperForConditionalGeneration`` state dict (views; see the module
    docstring)."""
    _check_float_tree(params)
    out: Dict[str, torch.Tensor] = {}
    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):       # [C_out, C_in, 3]: HF's layout
        out[f"model.encoder.{name}.weight"] = enc[name]["kernel"]
        out[f"model.encoder.{name}.bias"] = enc[name]["bias"]
    out["model.encoder.embed_positions.weight"] = enc["pos"]
    for i in range(cfg.encoder_layers):
        layer = _layer(enc["layers"], i)
        p = f"model.encoder.layers.{i}"
        _put_ln(out, f"{p}.self_attn_layer_norm", layer["attn_ln"])
        _put_attn(out, f"{p}.self_attn", layer["attn"])
        _put_ln(out, f"{p}.final_layer_norm", layer["mlp_ln"])
        _put_linear(out, f"{p}.fc1", layer["mlp_in"])
        _put_linear(out, f"{p}.fc2", layer["mlp_out"])
    _put_ln(out, "model.encoder.layer_norm", enc["ln"])

    embed = dec["embed"]
    out["model.decoder.embed_tokens.weight"] = embed
    out["model.decoder.embed_positions.weight"] = dec["pos"]
    for i in range(cfg.decoder_layers):
        layer = _layer(dec["layers"], i)
        p = f"model.decoder.layers.{i}"
        _put_ln(out, f"{p}.self_attn_layer_norm", layer["attn_ln"])
        _put_attn(out, f"{p}.self_attn", layer["attn"])
        _put_ln(out, f"{p}.encoder_attn_layer_norm", layer["cross_ln"])
        _put_attn(out, f"{p}.encoder_attn", layer["cross_attn"])
        _put_ln(out, f"{p}.final_layer_norm", layer["mlp_ln"])
        _put_linear(out, f"{p}.fc1", layer["mlp_in"])
        _put_linear(out, f"{p}.fc2", layer["mlp_out"])
    _put_ln(out, "model.decoder.layer_norm", dec["ln"])
    out["proj_out.weight"] = embed        # tied output projection
    return out


def hf_whisper_config_dict(cfg: WhisperConfig) -> Dict[str, Any]:
    """WhisperConfig -> the HF config.json fields the port reads back
    (``port.py:whisper_config_from_hf`` inverse)."""
    d: Dict[str, Any] = {
        "model_type": "whisper",
        "architectures": ["WhisperForConditionalGeneration"],
        "num_mel_bins": cfg.n_mels,
        "max_source_positions": cfg.n_audio_ctx,
        "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.heads,
        "decoder_attention_heads": cfg.heads,
        "encoder_ffn_dim": 4 * cfg.d_model,
        "decoder_ffn_dim": 4 * cfg.d_model,
        "vocab_size": cfg.vocab_size,
        "max_target_positions": cfg.n_text_ctx,
    }
    if cfg.vocab_size < 51864:
        # shrunken/test vocab: HF's default special-token ids would fall
        # outside the embedding table and from_pretrained refuses the model
        d.update(pad_token_id=0, bos_token_id=1, eos_token_id=2,
                 decoder_start_token_id=1, suppress_tokens=[],
                 begin_suppress_tokens=[])
    elif cfg.vocab_size == 51864:
        # English-only family (.en): eot=50256, sot=50257
        d.update(pad_token_id=50256, bos_token_id=50256,
                 eos_token_id=50256, decoder_start_token_id=50257,
                 suppress_tokens=[], begin_suppress_tokens=[220, 50256])
    else:
        # multilingual: the standard whisper ids (sot=50258, eot=50257) and
        # the published suppress lists, whose task/context ids shift with
        # the language count (99 at 51865; large-v3 adds yue -> 51866)
        eot, sot = 50257, 50258
        translate = sot + 1 + (99 if cfg.vocab_size == 51865 else 100)
        d.update(
            pad_token_id=eot, bos_token_id=eot, eos_token_id=eot,
            decoder_start_token_id=sot,
            suppress_tokens=_WHISPER_SYMBOL_SUPPRESS + [sot] +
                            list(range(translate, translate + 5)),
            begin_suppress_tokens=[220, eot])
    return d


# openai's default non-speech suppression set over the base GPT-2-style
# vocab, identical across every multilingual whisper size (the published
# checkpoints ship exactly this list in config.json)
_WHISPER_SYMBOL_SUPPRESS = [
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
]


def export_causal_lm_state_dict(params: Mapping, cfg
                                ) -> Dict[str, torch.Tensor]:
    """The port's causal-LM params (Qwen2/Qwen3/Qwen3-MoE family) -> an HF
    ``*ForCausalLM`` state dict (views)."""
    _check_float_tree(params)
    out: Dict[str, torch.Tensor] = {}
    embed = params["embed"]
    out["model.embed_tokens.weight"] = embed
    moe = cfg.num_experts > 0
    for i in range(cfg.layers):
        layer = _layer(params["layers"], i)
        pr = f"model.layers.{i}"
        out[f"{pr}.input_layernorm.weight"] = layer["attn_norm"]["scale"]
        for name, proj in (("q", "q_proj"), ("k", "k_proj"),
                           ("v", "v_proj"), ("o", "o_proj")):
            _put_linear(out, f"{pr}.self_attn.{proj}", layer[name])
        out[f"{pr}.post_attention_layernorm.weight"] = \
            layer["mlp_norm"]["scale"]
        if moe:
            out[f"{pr}.mlp.gate.weight"] = layer["router"]["kernel"].t()
            for name, proj in (("gate", "gate_proj"), ("up", "up_proj"),
                               ("down", "down_proj")):
                stack = layer["experts"][name]["kernel"]   # [E, in, out]
                for e in range(cfg.num_experts):
                    out[f"{pr}.mlp.experts.{e}.{proj}.weight"] = stack[e].t()
        else:
            for name, proj in (("gate", "gate_proj"), ("up", "up_proj"),
                               ("down", "down_proj")):
                _put_linear(out, f"{pr}.mlp.{proj}", layer[name])
        if cfg.qk_norm:
            out[f"{pr}.self_attn.q_norm.weight"] = layer["q_norm"]["scale"]
            out[f"{pr}.self_attn.k_norm.weight"] = layer["k_norm"]["scale"]
    out["model.norm.weight"] = params["norm"]["scale"]
    out["lm_head.weight"] = (embed if cfg.tie_embeddings
                             else params["lm_head"]["kernel"].t())
    return out


def hf_causal_lm_config_dict(cfg) -> Dict[str, Any]:
    """CausalLMConfig -> HF config.json fields (the inverse of
    ``port_causal_lm_state_dict``'s reading). Qwen2 layout when qkv_bias,
    else Qwen3 (qk_norm / decoupled head_dim); MoE -> Qwen3-MoE."""
    moe = cfg.num_experts > 0
    if moe:
        model_type, arch = "qwen3_moe", "Qwen3MoeForCausalLM"
    elif cfg.qk_norm or not cfg.qkv_bias:
        model_type, arch = "qwen3", "Qwen3ForCausalLM"
    else:
        model_type, arch = "qwen2", "Qwen2ForCausalLM"
    d: Dict[str, Any] = {
        "model_type": model_type,
        "architectures": [arch],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads,
        "num_key_value_heads": cfg.kv_heads,
        # the derived widths, not the raw fields: a config may leave
        # ffn_dim/moe_ffn_dim 0 (width derived), and a raw 0 would make HF
        # build zero-width MLPs
        "intermediate_size": cfg.ffn,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "max_position_embeddings": cfg.max_seq,
    }
    if cfg.head_dim:
        d["head_dim"] = cfg.head_dim
    if moe:
        d.update(num_experts=cfg.num_experts,
                 num_experts_per_tok=cfg.experts_per_tok,
                 moe_intermediate_size=cfg.moe_ffn,
                 norm_topk_prob=cfg.norm_topk_prob,
                 decoder_sparse_step=1, mlp_only_layers=[])
    return d
