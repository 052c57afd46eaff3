"""LoRA adapters for the nested-dict Whisper parameter tree (port of
``audax/models/lora.py``).

LoRA is a tree transformation, not a module rewrite:

    lora = init_lora(params, rank, targets=("attn/q", "attn/v"), generator=g)
    model_params = apply_lora(params, lora, alpha)   # kernels += B @ A

The adapter tree is flat, keyed by the same ``"decoder/layers/attn/q/kernel"``
paths as the JAX package's, each holding ``{"a": [..., r, d_in], "b": [...,
d_out, r]}``; stacked ``[L, d_in, d_out]`` kernels get per-layer adapters
through the leading axis. ``merge_lora`` bakes adapters in for serving.

The conv kernels are the one layout the port changes (``models/bridge.py``:
``[C_out, C_in, 3]`` instead of JAX's ``[3, C_in, C_out]``), so a target
that matches a conv kernel raises ``ValueError`` instead of adapting the
wrong axes. No caller targets one.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch

from audax_torch.parallel.comm import copy_to_model, model_rank

Params = Dict[str, Any]

__all__ = ["init_lora", "apply_lora", "merge_lora", "lora_param_count",
           "match_path", "iter_leaves"]

#: conv kernels, whose layout differs from the JAX package's
CONV_KERNELS = ("encoder/conv1/kernel", "encoder/conv2/kernel")


def iter_leaves(params: Params, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ``(path, leaf)`` for every leaf, in sorted key order (the JAX
    package's tree order)."""
    for key in sorted(params):
        path = f"{prefix}/{key}" if prefix else key
        val = params[key]
        if isinstance(val, dict):
            yield from iter_leaves(val, path)
        else:
            yield path, val


def match_path(path: str, targets: Sequence[str]) -> bool:
    """Segment-aligned containment: target 'attn/q' matches
    'decoder/layers/attn/q/kernel' but NOT 'cross_attn/q/kernel'. Target
    'cross_attn/q' selects the cross path explicitly."""
    hay = f"/{path}/"
    return any(f"/{t.strip('/')}/" in hay for t in targets)


def check_not_conv(path: str) -> None:
    if path in CONV_KERNELS:
        raise ValueError(f"LoRA on {path}: the port keeps conv kernels as "
                         "[C_out, C_in, 3], not JAX's [3, C_in, C_out]; "
                         "conv adapters are not supported")


def init_lora(params: Params, rank: int, *, targets: Sequence[str],
              generator: torch.Generator) -> Params:
    """A ~ N(0, 1/rank) [..., r, d_in]; B = 0 [..., d_out, r], so the
    adapted model starts exactly at the base model. A is drawn on the
    generator's device and moved to its kernel's device, so one seed gives
    the same adapters on the CPU and the card."""
    flat = {}
    for path, leaf in iter_leaves(params):
        if leaf.dim() >= 2 and path.endswith("kernel") and \
                match_path(path, targets):
            check_not_conv(path)
            *lead, d_in, d_out = leaf.shape
            a = torch.randn(*lead, rank, d_in, generator=generator,
                            device=generator.device) / math.sqrt(rank)
            flat[path] = {
                "a": a.to(leaf.device),
                "b": torch.zeros(*lead, d_out, rank, device=leaf.device),
            }
    return flat


def _apply_at(tree: Params, parts, delta: torch.Tensor) -> Params:
    key = parts[0]
    if len(parts) == 1:
        return {**tree, key: tree[key] + delta.to(tree[key].dtype)}
    return {**tree, key: _apply_at(tree[key], parts[1:], delta)}


def _leaf_at(tree: Params, parts):
    for key in parts:
        tree = tree[key]
    return tree


def apply_lora(params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """Params with ``kernel += (B @ A)^T * (alpha / rank)`` per target (a
    new tree; the base tensors are not modified).

    Under tensor parallelism (``parallel/sharding.py``) a base kernel may
    be this rank's block of columns or rows while the adapters stay whole:
    the delta is cut to the same block, and the adapters pass Megatron's f
    (``parallel/comm.py:copy_to_model``) so their gradient, partial on each
    rank, is summed over 'model'."""
    out = params
    for path, ab in lora.items():
        parts = path.split("/")
        base = _leaf_at(params, parts)
        a, b = ab["a"], ab["b"]
        rank = a.shape[-2]
        cut = b.shape[-2] != base.shape[-1] or a.shape[-1] != base.shape[-2]
        if cut:
            a, b = copy_to_model(a), copy_to_model(b)
        delta = torch.einsum("...or,...ri->...io", b, a) * (alpha / rank)
        if cut:
            for dim in (-2, -1):
                n = base.shape[dim]
                if delta.shape[dim] != n:
                    delta = delta.narrow(dim, model_rank() * n, n)
        out = _apply_at(out, parts, delta)
    return out


def merge_lora(params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """Fold adapters into the base weights (serving path)."""
    return apply_lora(params, lora, alpha)


def lora_param_count(lora: Params) -> int:
    return sum(int(ab[k].numel()) for ab in lora.values() for k in ("a", "b"))
