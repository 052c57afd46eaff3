"""The fine-tune optimizer: AdamW with reduced-precision moment storage and
the warmup + linear-decay schedule (port of ``audax/train/optim.py``:
``seq2seq_schedule``, ``scale_by_adam_lp``, ``adamw_lp``).

These are plain functions on nested-dict tensor trees, not
``torch.optim`` classes, because the JAX chain fixes an operation order
that ``torch.optim.AdamW`` and ``clip_grad_norm_`` do not follow:

  * clipping (``optax.clip_by_global_norm``) scales by ``max_norm / norm``
    only when ``norm >= max_norm``, with no epsilon;
  * the Adam direction is ``m_hat / (sqrt(v_hat) + eps)``; the decoupled
    weight decay ``wd * p`` is added to it for EVERY leaf (biases and
    LayerNorm included), and only then is the sum scaled by ``-lr``;
  * the learning rate of update k is ``schedule(k)``, k counting from 0, so
    the first update of a warmup schedule has lr 0.

``moments`` is the STORAGE dtype of m and v: "float32" is the exact twin of
optax's chain; "bfloat16" halves the optimizer-state bytes. The update
arithmetic is float32 either way and parameters stay float32 master
weights. The int8 moments belong to a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten

__all__ = ["seq2seq_schedule", "scale_by_adam_lp", "adamw_lp",
           "GradientTransformation", "ScaleByAdamLPState", "apply_updates",
           "global_norm"]

Schedule = Callable[[int], float]
_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x) -> np.float32:
    return np.float32(x)


def _linear(init: float, end: float, steps: int, count) -> np.float32:
    """``optax.linear_schedule(init, end, steps)(count)`` in float32."""
    c = np.clip(_f32(count), _f32(0), _f32(steps))
    frac = _f32(1) - c / _f32(steps)
    return (_f32(init) - _f32(end)) * frac + _f32(end)


def seq2seq_schedule(learning_rate: float, warmup_steps: int,
                     max_steps: int) -> Schedule:
    """Linear warmup from 0 to ``learning_rate`` over ``warmup_steps``,
    then linear decay to zero at ``max_steps`` (optax ``join_schedules`` of
    two ``linear_schedule``\\ s, evaluated in float32)."""
    warm = max(warmup_steps, 1)
    decay = max(max_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(_linear(0.0, learning_rate, warm, count))
        return float(_linear(learning_rate, 0.0, decay, count - warmup_steps))
    return schedule


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)`` on tensor trees, as optax's."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


class ScaleByAdamLPState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def _check_moments(moments: str) -> None:
    if moments == "int8":
        raise NotImplementedError(
            "moments='int8' (blockwise int8 m, bf16 v) arrives with a later "
            "slice of the port (int8 optimizer moments); use 'float32' or "
            "'bfloat16'")
    if moments not in _STORE:
        raise ValueError(f"moments={moments!r}")


def scale_by_adam_lp(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     *, moments: str = "bfloat16") -> GradientTransformation:
    """Adam's direction ``m_hat / (sqrt(v_hat) + eps)`` with m and v stored
    in ``moments`` dtype and every operation in float32."""
    _check_moments(moments)
    store = _STORE[moments]

    def init(params) -> ScaleByAdamLPState:
        zeros = lambda p: torch.zeros(p.shape, dtype=store,  # noqa: E731
                                      device=p.device)
        return ScaleByAdamLPState(0, tree_map(zeros, params),
                                  tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: ScaleByAdamLPState, params=None):
        del params
        count = state.count + 1
        c1 = float(_f32(1) - np.power(_f32(b1), _f32(count)))
        c2 = float(_f32(1) - np.power(_f32(b2), _f32(count)))
        gs = [g.float() for g in tree_leaves(grads)]
        ms = [m.float() for m in tree_leaves(state.mu)]
        ns = [n.float() for n in tree_leaves(state.nu)]
        # m = b1 m + (1 - b1) g ;  n = b2 n + (1 - b2) g^2
        ms = torch._foreach_add(torch._foreach_mul(ms, b1),
                                torch._foreach_mul(gs, 1.0 - b1))
        sq = torch._foreach_mul(gs, gs)
        ns = torch._foreach_add(torch._foreach_mul(ns, b2),
                                torch._foreach_mul(sq, 1.0 - b2))
        den = torch._foreach_sqrt(torch._foreach_div(ns, c2))
        torch._foreach_add_(den, eps)
        out = torch._foreach_div(torch._foreach_div(ms, c1), den)
        out = [o.to(g.dtype) for o, g in zip(out, tree_leaves(grads))]
        mu = tree_unflatten(state.mu, [m.to(store) for m in ms])
        nu = tree_unflatten(state.nu, [n.to(store) for n in ns])
        return tree_unflatten(grads, out), ScaleByAdamLPState(count, mu, nu)

    return GradientTransformation(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a float32 scalar tensor."""
    sq = [torch.sum(g.float() * g.float()) for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def adamw_lp(learning_rate: Union[float, Schedule],
             weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, *, moments: str = "bfloat16",
             grad_clip: Optional[float] = None) -> GradientTransformation:
    """AdamW with reduced-precision moments, in optax's chain order:
    optional global-norm clipping -> Adam direction -> + ``weight_decay * p``
    -> x ``-lr``. The state is the Adam state; its count, read before the
    update increments it, indexes the schedule."""
    adam = scale_by_adam_lp(b1, b2, eps, moments=moments)
    schedule = (learning_rate if callable(learning_rate)
                else (lambda _count: learning_rate))

    @torch.no_grad()
    def update(grads, state: ScaleByAdamLPState, params):
        if grad_clip:
            # clip_by_global_norm: (g / norm) * max_norm where norm >= max,
            # decided on the device (no host read of the norm)
            norm = global_norm(grads)
            keep = norm < grad_clip
            one = torch.ones_like(norm)
            den = torch.where(keep, one, norm)
            num = torch.where(keep, one, torch.full_like(norm, grad_clip))
            grads = tree_map(lambda g: g / den * num, grads)
        lr = float(_f32(schedule(state.count)))
        direction, state = adam.update(grads, state)
        ds = tree_leaves(direction)
        torch._foreach_add_(ds, [p.detach() for p in tree_leaves(params)],
                            alpha=weight_decay)
        torch._foreach_mul_(ds, -lr)
        return direction, state

    return GradientTransformation(adam.init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place (the step owns its trainable
    tensors, as the JAX step donates them)."""
    ps = tree_leaves(params)
    torch._foreach_add_(ps, [u.to(p.dtype) for p, u in
                             zip(ps, tree_leaves(updates))])
