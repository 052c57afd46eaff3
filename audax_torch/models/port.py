"""Checkpoint porting: an HF Whisper state dict -> the port's parameter tree
(port of ``audax/models/port.py``).

Works from a live ``WhisperForConditionalGeneration`` (the tests build
random ones from configs; there is no network) or from a state dict, e.g.
``models/hf_files.py:read_state_dict`` of a local checkpoint directory,
which needs neither ``transformers`` nor ``safetensors``. The layout is the
JAX package's tree with the port's two conventions (``models/bridge.py``):
stacked ``[L, ...]`` layers, dense kernels ``[d_in, d_out]``, and the conv
kernels in ``F.conv1d``'s ``[C_out, C_in, 3]``, which is HF's own layout.
Leaves are float32: the result equals ``bridge.params_from_numpy`` of the
JAX package's port of the same state dict, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.hf_files import config_value

__all__ = ["whisper_config_from_hf", "port_whisper_from_hf",
           "port_whisper_state_dict"]


def whisper_config_from_hf(hf_config) -> WhisperConfig:
    """An HF ``WhisperConfig`` object or its ``config.json`` dict ->
    the port's ``WhisperConfig``."""
    return WhisperConfig(
        n_mels=config_value(hf_config, "num_mel_bins"),
        n_audio_ctx=config_value(hf_config, "max_source_positions"),
        d_model=config_value(hf_config, "d_model"),
        encoder_layers=config_value(hf_config, "encoder_layers"),
        decoder_layers=config_value(hf_config, "decoder_layers"),
        heads=config_value(hf_config, "encoder_attention_heads"),
        vocab_size=config_value(hf_config, "vocab_size"),
        n_text_ctx=config_value(hf_config, "max_target_positions"),
    )


class _Porter:
    """Recipes for the tree: each leaf a thunk that reads its HF tensor
    once, as float32 on ``device``."""

    def __init__(self, sd: Mapping, device: torch.device):
        self.sd = sd
        self.keys = {k.removeprefix("model."): k for k in sd}
        self.device = device

    def t(self, name: str, transpose: bool = False):
        def read() -> torch.Tensor:
            v = self.sd[self.keys[name]]
            v = (v.detach() if isinstance(v, torch.Tensor)
                 else torch.as_tensor(v))
            v = v.to(self.device, torch.float32)
            return v.t() if transpose else v
        return read

    def ln(self, prefix: str) -> Dict[str, Any]:
        return {"scale": self.t(f"{prefix}.weight"),
                "bias": self.t(f"{prefix}.bias")}

    def linear(self, prefix: str, bias: bool = True) -> Dict[str, Any]:
        p = {"kernel": self.t(f"{prefix}.weight", transpose=True)}
        if bias and f"{prefix}.bias" in self.keys:
            p["bias"] = self.t(f"{prefix}.bias")
        return p

    def attn(self, prefix: str) -> Dict[str, Any]:
        return {"q": self.linear(f"{prefix}.q_proj"),
                "k": self.linear(f"{prefix}.k_proj", bias=False),
                "v": self.linear(f"{prefix}.v_proj"),
                "out": self.linear(f"{prefix}.out_proj")}


def _read(recipe):
    """A recipe tree read leaf by leaf (stacked leaves are read already)."""
    if isinstance(recipe, dict):
        return {k: _read(v) for k, v in recipe.items()}
    return recipe if isinstance(recipe, torch.Tensor) else recipe()


def _stacked(layers):
    """Per-layer recipe trees -> one tree of ``[L, ...]`` leaves, stacked
    leaf by leaf (one leaf's layers read at a time)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stacked([layer[k] for layer in layers]) for k in first}
    return torch.stack([read() for read in layers])


def _enc_layer(P: _Porter, i: int) -> Dict[str, Any]:
    p = f"encoder.layers.{i}"
    return {"attn_ln": P.ln(f"{p}.self_attn_layer_norm"),
            "attn": P.attn(f"{p}.self_attn"),
            "mlp_ln": P.ln(f"{p}.final_layer_norm"),
            "mlp_in": P.linear(f"{p}.fc1"),
            "mlp_out": P.linear(f"{p}.fc2")}


def _dec_layer(P: _Porter, i: int) -> Dict[str, Any]:
    p = f"decoder.layers.{i}"
    return {"attn_ln": P.ln(f"{p}.self_attn_layer_norm"),
            "attn": P.attn(f"{p}.self_attn"),
            "cross_ln": P.ln(f"{p}.encoder_attn_layer_norm"),
            "cross_attn": P.attn(f"{p}.encoder_attn"),
            "mlp_ln": P.ln(f"{p}.final_layer_norm"),
            "mlp_in": P.linear(f"{p}.fc1"),
            "mlp_out": P.linear(f"{p}.fc2")}


def port_whisper_state_dict(sd: Mapping, cfg: WhisperConfig, *,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """HF state dict (``model.``-prefixed or not; tensors or arrays of any
    float dtype) -> the port's Whisper params, float32 on ``device``."""
    P = _Porter(sd, resolve_device(device))
    return _read({
        "encoder": {
            "conv1": {"kernel": P.t("encoder.conv1.weight"),
                      "bias": P.t("encoder.conv1.bias")},
            "conv2": {"kernel": P.t("encoder.conv2.weight"),
                      "bias": P.t("encoder.conv2.bias")},
            "pos": P.t("encoder.embed_positions.weight"),
            "layers": _stacked([_enc_layer(P, i)
                                for i in range(cfg.encoder_layers)]),
            "ln": P.ln("encoder.layer_norm"),
        },
        "decoder": {
            "embed": P.t("decoder.embed_tokens.weight"),
            "pos": P.t("decoder.embed_positions.weight"),
            "layers": _stacked([_dec_layer(P, i)
                                for i in range(cfg.decoder_layers)]),
            "ln": P.ln("decoder.layer_norm"),
        },
    })


def port_whisper_from_hf(hf_model, *, device: DeviceLike = None
                         ) -> Dict[str, Any]:
    """Port a live transformers ``WhisperForConditionalGeneration`` /
    ``WhisperModel``."""
    cfg = whisper_config_from_hf(hf_model.config)
    base = getattr(hf_model, "model", hf_model)
    return port_whisper_state_dict(base.state_dict(), cfg, device=device)
