"""Weight bridge: the JAX package's Whisper parameter tree -> the port's.

``params_from_numpy`` takes the tree as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, init_whisper_params(cfg, key))`` or a tree read
from a checkpoint, and returns the same tree of tensors on ``device``.
Layouts are kept on purpose so the two packages compare like with like:

  * stacked layers keep their leading ``[L, ...]`` axis;
  * dense kernels keep ``[d_in, d_out]`` (``y = x @ kernel``);
  * the conv kernels are the one deliberate change: JAX's HIO
    ``[3, C_in, C_out]`` becomes ``F.conv1d``'s ``[C_out, C_in, 3]``.

Float leaves become float32. Quantized trees (``models/quantize.py``, as
``quantize_tree`` or ``convert-hf --quantize`` writes them) keep their
codes byte for byte: ``kernel_q``/``embed_q`` stay int8,
``kernel_q4``/``embed_q4`` stay uint8, and every ``*_scale*`` is float32.
Conv kernels are never quantized (a quantized conv raises
``NotImplementedError``), so their transpose is unchanged.
``lora_from_numpy`` converts the JAX package's flat LoRA adapter tree the
same way; adapters of the conv kernels raise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.lora import check_not_conv

__all__ = ["params_from_numpy", "lora_from_numpy"]

_CONVS = ("conv1", "conv2")


def _convert(tree: Mapping[str, Any], device: torch.device, path: str):
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        where = f"{path}/{key}"
        if isinstance(val, Mapping):
            out[key] = _convert(val, device, where)
            continue
        if key.startswith(("kernel_q", "embed_q")):
            if path.rsplit("/", 1)[-1] in _CONVS:
                raise NotImplementedError(f"{where}: quantized conv kernels "
                                          "are not carried (quantize_tree "
                                          "keeps convs float)")
            dt = np.uint8 if key.endswith("_q4") else np.int8
            out[key] = torch.from_numpy(np.array(val, dtype=dt,
                                                 copy=True)).to(device)
            continue
        arr = np.asarray(val, dtype=np.float32)
        if key == "kernel" and path.rsplit("/", 1)[-1] in _CONVS:
            arr = arr.transpose(2, 1, 0)          # HIO -> [C_out, C_in, 3]
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def lora_from_numpy(tree: Mapping[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's flat LoRA tree (``{path: {"a", "b"}}``, numpy
    arrays) -> the port's, float32 tensors on ``device``. Adapters of the
    conv kernels, whose layout the port changes, raise ``ValueError``."""
    device = resolve_device(device)
    out = {}
    for path, ab in tree.items():
        check_not_conv(path)
        out[path] = {k: torch.from_numpy(
            np.array(ab[k], dtype=np.float32, copy=True)).to(device)
            for k in ("a", "b")}
    return out


def params_from_numpy(tree: Mapping[str, Any], cfg: WhisperConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """JAX-layout numpy tree -> port tree on ``device`` (float32 leaves,
    quantized codes and scales as they are)."""
    device = resolve_device(device)
    params = _convert(tree, device, "")
    conv1 = params["encoder"]["conv1"]["kernel"]
    dec = params["decoder"]
    if "embed" in dec:
        embed, want = dec["embed"], (cfg.vocab_size, cfg.d_model)
    elif "embed_q" in dec:
        embed, want = dec["embed_q"], (cfg.vocab_size, cfg.d_model)
    else:                                  # int4: [d/2, V]
        embed, want = dec["embed_q4"], (cfg.d_model // 2, cfg.vocab_size)
    if conv1.shape != (cfg.d_model, cfg.n_mels, 3) or embed.shape != want:
        raise ValueError(f"tree does not match {cfg}: conv1 "
                         f"{tuple(conv1.shape)}, embed {tuple(embed.shape)}")
    return params
