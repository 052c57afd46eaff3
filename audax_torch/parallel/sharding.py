"""Parameter sharding rules: path pattern -> partition spec (port of
``audax/parallel/sharding.py``).

The rule tables are the JAX package's, one for one, and ``param_specs``
gives the same spec tree. Where JAX hands the specs to GSPMD, the port cuts
each rank's local tensors from the one full tree: every rank builds the
same full tree from the same seed, then ``shard_params`` slices it (no rank
ever initialises its shards on its own). The model code then sees plain
local tensors -- heads / tp of them -- and writes the Megatron collectives
itself (``parallel/comm.py``).

Whisper follows the Megatron pattern: attention/MLP input projections split
the *output* feature dim across 'model' (head-parallel), output projections
split the *input* dim, so each block needs one all-reduce on its residual
add. A row-parallel projection's bias is replicated and added after that
all-reduce.

A leaf whose sharded dim does not divide the axis stays whole
(replicated), as in JAX. int4 dense dicts stay whole as a unit: their
matmul (kernel K9) then runs whole on every rank, and the attention beside
it computes every head, so a rank's caches hold ALL heads of such a block.
An int8 ``kernel_q`` takes its float kernel's rule by suffix match while
its ``kernel_scale`` matches none and stays whole: the model code takes
the scale's block for a column-parallel kernel.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import torch

from audax_torch.parallel.mesh import (P, axis_rank, axis_size, batch_rank,
                                       batch_size)

__all__ = ["WHISPER_TP_RULES", "CAUSAL_LM_TP_RULES", "ATTENTION_LEAVES",
           "spec_for_path", "shard_params", "param_specs", "kv_rows",
           "tp_specs", "local_slice", "path_leaves", "map_with_path", "P"]


# (path regex, spec). First match wins. Stacked-layer params carry a leading
# layer axis -> specs start with None for it.
WHISPER_TP_RULES: Tuple[Tuple[str, P], ...] = (
    # int4 leaves ([L, K/2, N] packed + [L, G, N] scales) feed kernel K9,
    # which runs whole on each rank -- keep them replicated (first match
    # wins). int8 kernel_q shares the float kernel's layout and inherits
    # its TP rules by suffix match.
    (r"_q4$|_scale4$", P()),
    # attention / mlp column-parallel (split output features)
    (r"layers/(attn|cross_attn)/(q|k|v)/kernel", P(None, None, "model")),
    (r"layers/(attn|cross_attn)/(q|k|v)/bias", P(None, "model")),
    (r"layers/mlp_in/kernel", P(None, None, "model")),
    (r"layers/mlp_in/bias", P(None, "model")),
    # row-parallel (split input features; output all-reduced)
    (r"layers/(attn|cross_attn)/out/kernel", P(None, "model", None)),
    (r"layers/mlp_out/kernel", P(None, "model", None)),
    # token embedding: shard vocab rows (masked lookup + all-reduce)
    (r"decoder/embed$", P("model", None)),
    # everything else replicated
)

# Megatron split for the Qwen/LLaMA-family causal LM (models/causal_lm.py):
# q/k/v and SwiGLU gate/up are column-parallel, o/down row-parallel --
# one all-reduce per block. GQA: k/v shard over kv_heads; shard_params
# falls back to replication when kv_heads doesn't divide the model axis.
CAUSAL_LM_TP_RULES: Tuple[Tuple[str, P], ...] = (
    (r"_q4$|_scale4$", P()),             # transposed int4 layout: replicate
    # expert parallelism: the expert axis of stacked MoE weights ([L, E,
    # d, f]) over 'model'; each rank computes its expert slice and the
    # combine is all-reduced -- attention stays head-sharded on the same
    # axis (hybrid TP-attention + EP-FFN). Router stays replicated.
    (r"layers/experts/(gate|up|down)/kernel_scale", P(None, "model", None)),
    (r"layers/experts/(gate|up|down)/kernel", P(None, "model", None, None)),
    (r"layers/router/kernel", P()),
    (r"layers/(q|k|v|gate|up)/kernel", P(None, None, "model")),
    (r"layers/(q|k|v|gate|up)/bias", P(None, "model")),
    (r"layers/(o|down)/kernel", P(None, "model", None)),
    (r"^embed$|/embed$", P("model", None)),
    (r"lm_head/kernel", P(None, "model")),
)


def path_leaves(tree: Any, prefix: str = ""):
    """(path, leaf) of every leaf of a nested-dict tree, paths joined by
    "/" as the JAX package's ``_path_str`` joins its keys (a LoRA tree's
    slash-containing keys read as the same path)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from path_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def map_with_path(fn, tree: Any, prefix: str = ""):
    """``fn(path, leaf)`` over a nested-dict tree (same structure)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def spec_for_path(path: str, rules: Sequence[Tuple[str, P]], ndim: int) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            if len(spec) <= ndim:
                return spec
    return P()


def _int4_dense_prefixes(params: Any) -> Tuple[str, ...]:
    """Paths of dense dicts holding int4 weights: the WHOLE dict (packed,
    scales, bias) stays replicated together -- K9 runs whole on every
    rank, and a sharded bias beside its whole output would not add."""
    return tuple(s[: -len("/kernel_q4")] for s, _ in path_leaves(params)
                 if s.endswith("/kernel_q4"))


def _in_int4(path: str, prefixes: Tuple[str, ...]) -> bool:
    return any(path == pre or path.startswith(pre + "/") for pre in prefixes)


def param_specs(params: Any, rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES
                ) -> Any:
    """Tree of partition specs matching ``params`` (JAX's, spec for
    spec)."""
    int4 = _int4_dense_prefixes(params)
    return map_with_path(
        lambda s, leaf: P() if _in_int4(s, int4)
        else spec_for_path(s, rules, leaf.dim()), params)


#: the attention projections of both rule tables (Whisper's
#: ``layers/(attn|cross_attn)/(q|k|v|out)``, the causal LM's
#: ``layers/(q|k|v|o)``): they are cut by whole heads or not at all
ATTENTION_LEAVES = r"layers/((attn|cross_attn)/)?(q|k|v|o|out)/"


def tp_specs(params: Any, mesh,
             rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES, *,
             heads: Optional[int] = None) -> Any:
    """The specs ``shard_params`` applies: ``param_specs`` with a leaf
    whose sharded dim does not divide its mesh axis replicated. ``heads``
    (the model's attention heads): when the model axis does not divide
    them, every attention projection stays whole too, so each rank
    computes all the heads (a cut by width would split a head), as int4
    blocks stay whole."""
    specs = param_specs(params, rules)
    whole_attn = heads is not None and heads % axis_size(mesh, "model")

    def fit(spec: P, leaf, path: str) -> P:
        if whole_attn and re.search(ATTENTION_LEAVES, path):
            return P()
        for dim, axis in enumerate(spec):
            if axis is not None and leaf.shape[dim] % axis_size(mesh,
                                                                axis):
                return P()
        return spec

    return _zip_map(fit, specs, params, with_path=True)


def _zip_map(fn, specs, tree, prefix: str = "", *, with_path=False):
    """``fn(spec, leaf)`` (and the leaf's path, ``with_path``) over a
    spec tree and the tree it describes."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, specs[k], v,
                            f"{prefix}/{k}" if prefix else str(k),
                            with_path=with_path) for k, v in tree.items()}
    return fn(specs, tree, prefix) if with_path else fn(specs, tree)


def local_slice(leaf: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec`` (a view): every dim
    named by an axis is cut into that axis' size blocks."""
    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if isinstance(axis, tuple):
            raise ValueError(f"spec {spec}: the port shards a dim over one "
                             "axis")
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"divide axis {axis!r} ({n})")
        size = out.shape[dim] // n
        out = out.narrow(dim, axis_rank(mesh, axis) * size, size)
    return out


def shard_params(params: Any, mesh,
                 rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES, *,
                 heads: Optional[int] = None) -> Any:
    """This rank's local tree of ``params`` (every rank's full tree equal):
    each leaf's block under its rule-derived spec, a copy of its own (so
    the full tree can be freed). Dims not divisible by the mesh axis fall
    back to replication for that param, and with ``heads`` the model axis
    does not divide, the attention projections (``tp_specs``)."""
    specs = tp_specs(params, mesh, rules, heads=heads)
    return _zip_map(
        lambda spec, leaf: local_slice(leaf, spec, mesh).clone()
        if any(a is not None for a in spec) else leaf, specs, params)


def kv_rows(mesh, batch: int) -> Optional[slice]:
    """The slots (rows of the batch dim) of decode state [L, B, H, ...]
    this rank holds: its block when the batch axes divide ``batch``, else
    None (every rank holds all of them). JAX's ``constrain_kv`` slot rule,
    and the ONE definition of it, shared by fixed-batch decode
    (``infer/decode.py``), beam search and both continuous engines. The
    heads follow the attention projections' column split: a rank's caches
    hold its own heads (``models/whisper.py:local_heads``), all of them
    for a whole (int4) block."""
    if mesh is None or batch % batch_size(mesh):
        return None
    n = batch // batch_size(mesh)
    return slice(batch_rank(mesh) * n, (batch_rank(mesh) + 1) * n)
