"""Model analysis reports: parameter and memory breakdowns and the
two-tower diagram (port of ``audax/utils/reports.py``).

The reference's train-start parameter and memory breakdown
(.charles/music2midi/train.py:67-175) and its inference-time report with a
KV-cache estimate and an ASCII architecture diagram
(.charles/music2midi/inference.py:93-298), over the port's trees (nested
dicts, lists and tuples of tensors).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["param_count", "param_bytes", "tree_breakdown", "model_report",
           "kv_cache_bytes", "format_bytes", "TWO_TOWER_DIAGRAM"]


def _leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_path(v, path + (str(i),))]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def param_count(tree: Any) -> int:
    return sum(int(x.numel()) for _, x in _leaves_with_path(tree))


def param_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size()
               for _, x in _leaves_with_path(tree))


def format_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} PB"


def tree_breakdown(tree: Any, depth: int = 1) -> List[Tuple[str, int, int]]:
    """[(path_prefix, params, bytes)] grouped at ``depth`` levels."""
    groups: Dict[str, Tuple[int, int]] = {}
    for keys, leaf in _leaves_with_path(tree):
        prefix = "/".join(keys[:depth]) or "(root)"
        c, b = groups.get(prefix, (0, 0))
        groups[prefix] = (c + int(leaf.numel()),
                          b + int(leaf.numel()) * leaf.element_size())
    return [(k, c, b) for k, (c, b) in sorted(groups.items())]


def kv_cache_bytes(layers: int, batch: int, kv_heads: int, max_len: int,
                   head_dim: int, dtype_bytes: int = 4) -> int:
    return 2 * layers * batch * kv_heads * max_len * head_dim * dtype_bytes


def model_report(named_trees: Dict[str, Any], *,
                 trainable: Optional[Dict[str, bool]] = None,
                 kv_cache: Optional[Dict[str, int]] = None,
                 diagram: Optional[str] = None) -> str:
    """Printable report over named parameter trees. ``trainable`` marks the
    trees counted as trainable; ``kv_cache`` passes ``kv_cache_bytes``
    arguments."""
    lines = ["=" * 64, "MODEL ANALYSIS", "=" * 64]
    total_params = total_bytes = trainable_params = 0
    for name, tree in named_trees.items():
        c, b = param_count(tree), param_bytes(tree)
        total_params += c
        total_bytes += b
        is_trainable = (trainable or {}).get(name, False)
        if is_trainable:
            trainable_params += c
        lines.append(f"{name:<28} {c:>14,}  {format_bytes(b):>10} "
                     f"{'trainable' if is_trainable else 'frozen'}")
        for sub, sc, sb in tree_breakdown(tree, depth=1):
            lines.append(f"  {sub:<26} {sc:>14,}  {format_bytes(sb):>10}")
    lines.append("-" * 64)
    lines.append(f"{'total':<28} {total_params:>14,}  "
                 f"{format_bytes(total_bytes):>10}")
    if trainable:
        pct = 100.0 * trainable_params / max(total_params, 1)
        lines.append(f"{'trainable':<28} {trainable_params:>14,}  "
                     f"({pct:.2f}%)")
    if kv_cache:
        kb = kv_cache_bytes(**kv_cache)
        lines.append(f"{'kv-cache (decode)':<28} {'':>14}  "
                     f"{format_bytes(kb):>10}")
    if diagram:
        lines += ["-" * 64, diagram]
    lines.append("=" * 64)
    return "\n".join(lines)


TWO_TOWER_DIAGRAM = r"""
  waveform [B, n]                                  tokens [B, T]
      |                                                 |
  LogMelFrontend (log-mel kernel K1)               embed_tokens
      |                                                 |
  Whisper encoder (FROZEN)  ----audio KV---->  CrossAttentionAdapter
      [B, S, d_audio]                               [B, T, d_text]
                                                        |
                                              causal LM (top-K unfrozen)
                                                        |
                                                logits [B, T, V_abc]
"""
