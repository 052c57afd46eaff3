"""Exponential moving average of the trainable parameters (port of
``audax/train/ema.py``).

The EMA tree tracks whatever the train state trains: the full parameters,
or the LoRA adapters, whose average is merged through ``apply_lora`` so the
frozen base is never duplicated. Debias warmup follows the
``min(decay, (1+t)/(10+t))`` ramp, so early steps are not anchored to the
initial weights.
"""

from __future__ import annotations

import torch

from audax_torch.models.lora import apply_lora
from audax_torch.models.whisper import tree_leaves, tree_map

__all__ = ["ema_init", "ema_update", "ema_model_params"]


def ema_init(trainable):
    """A fresh EMA tree: a detached copy of the trainable parameters."""
    return tree_map(lambda t: t.detach().clone(), trainable)


@torch.no_grad()
def ema_update(ema, trainable, decay: float, step: int):
    """One EMA step with debias warmup, in place on ``ema``'s tensors
    (``e * d + p * (1 - d)`` with ``d = min(decay, (1+step)/(10+step))``
    in float32); returns ``ema``."""
    d = torch.minimum(torch.tensor(decay, dtype=torch.float32),
                      (1.0 + torch.tensor(step, dtype=torch.float32))
                      / (10.0 + torch.tensor(step, dtype=torch.float32)))
    d = float(d)
    es, ps = tree_leaves(ema), tree_leaves(trainable)
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, [p.detach().to(e.dtype) for e, p in zip(es, ps)],
                        alpha=1.0 - d)
    return ema


def ema_model_params(state, ema):
    """Serving weights from the EMA tree: merged through LoRA when the
    state trains adapters, the EMA tree itself otherwise (mirrors
    ``FTState.model_params``)."""
    if getattr(state, "use_lora", False):
        return apply_lora(state.base_params, ema, state.lora_alpha)
    return ema
