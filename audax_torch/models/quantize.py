"""Int8/int4 weight-only quantization for serving (port of
``audax/models/quantize.py``).

Decode with a small batch reads every decoder weight once per generated
token, so fewer bytes per weight is more tokens per second and larger
checkpoints per card. ``quantize_tree`` replaces every dense ``{kernel[,
bias]}`` with

  * int8 (``bits=8``): ``{kernel_q, kernel_scale}`` -- symmetric, one
    float32 scale per output channel; the product stays plain PyTorch,
    ``(x @ q) * scale`` in the activation dtype, as the JAX package left it
    to XLA;
  * int4 (``bits=4``): ``{kernel_q4, kernel_scale4}`` -- nibble-packed,
    one scale per group of 128 contraction rows per output channel
    (``ops/int4_matmul.py``, kernel K9 on the card),

and the token embedding ``embed`` [V, d] (also the tied logit projection)
with ``embed_q``/``embed_scale`` (one scale per vocab row) or
``embed_q4``/``embed_scale4`` (packed [d/2, V], the kernel's contraction-major
orientation). Convs and the MoE router stay float (``_SKIP_KEYS``), as do
norms, positions and biases. A quantized tree is a drop-in replacement for
the float tree: ``models/whisper.py:dense``, ``embed_lookup`` and
``embed_logits`` dispatch on the leaves they find.

The JAX package's ``stacked_layer_view`` has no counterpart: the port's
layer loops index the stacked ``[L, K/2, N]`` tensor (``packed[li]``), a
view at the same pointer offset the TPU kernel's scalar prefetch selected,
so no per-layer copy is made.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from audax_torch.ops.int4_matmul import int4_matmul, quantize_int4

Params = Dict[str, Any]

__all__ = ["quantize_matrix", "quantize_tree", "dequant_dense",
           "embed_lookup", "embed_logits", "tree_bytes"]

#: dicts under these keys stay float: the two encoder convs run once per
#: utterance, and a router's output feeds a discrete top-k
_SKIP_KEYS = {"conv1", "conv2", "router"}


def quantize_matrix(k: torch.Tensor, axis: int = -2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per output channel: ``axis`` is the
    contraction axis that the matmul reduces away."""
    k = k.float().contiguous()
    s = torch.clamp_min(k.abs().amax(dim=axis) / 127.0, 1e-12)
    q = torch.clamp(torch.round(k / s.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), s


def _quantize_dense(p: Params, bits: int, group: int) -> Params:
    # kernel [..., d_in, d_out] (a leading layer axis when stacked)
    if bits == 4:
        q, s = quantize_int4(p["kernel"], group=group)
        out = {"kernel_q4": q, "kernel_scale4": s}
    else:
        q, s = quantize_matrix(p["kernel"], axis=-2)
        out = {"kernel_q": q, "kernel_scale": s}
    out.update((k, v) for k, v in p.items() if k != "kernel")
    return out


def quantize_tree(params: Params, *, embed_keys=("embed",), bits: int = 8,
                  group: int = 128) -> Params:
    """Walk a parameter tree, quantizing every dense kernel (2-4 dims, the
    contraction axis second to last) and every ``embed_keys`` matrix; see
    the module docstring for the leaves written."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def rec(node, name):
        if not isinstance(node, dict):
            return node
        if "kernel" in node and name not in _SKIP_KEYS \
                and 2 <= node["kernel"].dim() <= 4:
            return _quantize_dense(node, bits, group)
        out = {}
        for k, v in node.items():
            if k in embed_keys and isinstance(v, torch.Tensor) \
                    and v.dim() == 2:
                if bits == 4:
                    # embed [V, d]: logits contract d, so pack it as
                    # [K=d, N=V]: [d/2, V] codes, [G, V] scales
                    out[k + "_q4"], out[k + "_scale4"] = quantize_int4(
                        v.t(), group=group)
                else:
                    out[k + "_q"], out[k + "_scale"] = quantize_matrix(
                        v, axis=-1)
            else:
                out[k] = rec(v, k)
        return out

    return rec(params, "")


def dequant_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(kernel_q*) + bias`` in the activation dtype. int8:
    ``(x @ q) * scale``; int4: ``ops/int4_matmul.py`` (kernel K9 on the
    card for up to 256 rows)."""
    if "kernel_q4" in p:
        y = int4_matmul(x, p["kernel_q4"], p["kernel_scale4"])
    else:
        y = (x @ p["kernel_q"].to(x.dtype)) * p["kernel_scale"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embed_lookup(p: Params, idx: torch.Tensor, dtype,
                 key: str = "embed") -> torch.Tensor:
    """Token-embedding gather from a float, int8 or int4 table."""
    if key + "_q4" in p:
        pi = p[key + "_q4"][:, idx].to(torch.int32)         # [d/2, ...]
        q = torch.cat([(pi & 0xF) - 8, (pi >> 4) - 8], dim=0).to(dtype)
        s = p[key + "_scale4"][:, idx]                      # [G, ...]
        emb = q * torch.repeat_interleave(s, q.shape[0] // s.shape[0],
                                          dim=0).to(dtype)
        return torch.movedim(emb, 0, -1)                    # [..., d]
    if key + "_q" in p:
        rows = p[key + "_q"][idx].to(dtype)
        return rows * p[key + "_scale"][idx][..., None].to(dtype)
    return p[key][idx].to(dtype)


def embed_logits(p: Params, x: torch.Tensor, key: str = "embed"
                 ) -> torch.Tensor:
    """Tied-embedding logit projection x [..., d] -> [..., V]: float, int8
    (the per-row scale multiplies the output column) or int4 (K9)."""
    if key + "_q4" in p:
        return int4_matmul(x, p[key + "_q4"], p[key + "_scale4"])
    if key + "_q" in p:
        y = x @ p[key + "_q"].to(x.dtype).t()
        return y * p[key + "_scale"].to(x.dtype)
    return x @ p[key].to(x.dtype).t()


def tree_bytes(params: Params) -> int:
    """Total parameter bytes of a tree of tensors."""
    def rec(node):
        if isinstance(node, dict):
            return sum(rec(v) for v in node.values())
        return node.numel() * node.element_size()
    return rec(params)
