"""The optimizers: the classifiers' AdamW, and the fine-tune AdamW with
reduced-precision moment storage and the warmup + linear-decay schedule
(port of ``audax/train/optim.py``: ``adamw``, ``seq2seq_schedule``,
``scale_by_adam_lp``, ``adamw_lp``, ``moment_bytes_per_param``, and the
two-tower recipe's ``dual_lr`` and ``reduce_on_plateau``), and the
causal-LM pretraining's ``warmup_cosine_decay_schedule`` (optax's, which
``audax/train/lm.py`` uses).

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
optax's chain; "bfloat16" halves the optimizer-state bytes; "int8" keeps m
as blockwise-absmax int8 (the tensor flattened into blocks of 256, each
with one float32 scale, absmax / 127; codes round half to even) and v in
bfloat16 -- 3.02 bytes per parameter against 8. v stays bfloat16 because a
linear int8 code would crush entries far below their block's max to zero
and blow up their step. The state's ``mu`` is then ``{"q": tree of int8
[blocks, 256], "s": tree of float32 [blocks]}``, as in JAX. The update
arithmetic is float32 in every mode and parameters stay float32 master
weights.

Under a mesh (``parallel/fsdp.py:Layout``) the blocks are laid out over the
whole flattened leaf, so an int8 m stays whole and the same on every rank,
as JAX keeps it replicated; v is cut like its parameter. For a cut leaf the
update gathers the gradient whole, updates and re-encodes the whole m on
every rank, and takes this rank's block of the decoded m for the
direction: the int8 m costs its 1 + 4/256 ~ 1.016 bytes a parameter on
every rank.

The update owns its state, as JAX's donated one: it writes the moments in
place and works one leaf at a time, so the float32 temporaries alive at
once are of one leaf's size (the clip's scale is applied to each gradient
leaf as it is read). The results are the bits of the whole-tree chain; the
caller's gradients are left as they were.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten

__all__ = ["adamw", "seq2seq_schedule", "warmup_cosine_decay_schedule",
           "scale_by_adam_lp", "adamw_lp", "GradientTransformation",
           "ScaleByAdamLPState", "apply_updates", "global_norm",
           "clip_scale", "clip_by_global_norm", "moment_bytes_per_param",
           "dual_lr", "reduce_on_plateau", "DualLRState",
           "ReduceLROnPlateauState"]

Schedule = Callable[[int], float]
#: storage dtype of v (and of m but for "int8") per moments mode
_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.bfloat16}
_Q8_BLOCK = 256


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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` in float32: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from 0, warmup
    included)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    alpha = _f32(0.0 if peak_value == 0.0 else end_value / peak_value)
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(_linear(init_value, peak_value, warmup_steps, count))
        c = _f32(min(count - warmup_steps, span))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(span)))
        return float(_f32(peak_value) * ((_f32(1) - alpha) * cos + alpha))
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


def moment_bytes_per_param(moments: str) -> float:
    """Optimizer-state bytes per parameter of a ``moments`` mode."""
    return {"float32": 8.0, "bfloat16": 4.0,
            "int8": 1.0 + 4.0 / _Q8_BLOCK + 2.0}[moments]


def _blocks(p: torch.Tensor) -> int:
    return (p.numel() + _Q8_BLOCK - 1) // _Q8_BLOCK


def _q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int8 of float32 ``x``: flattened, zero-padded to
    256-element blocks, each scaled by its absmax / 127 (codes [blocks,
    256] int8, scales [blocks] float32)."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % _Q8_BLOCK)).reshape(
        -1, _Q8_BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-30)[:, None])
    return q.to(torch.int8), scale


def _q8_decode(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return (q.float() * s[:, None]).reshape(-1)[:n].reshape(shape)


def scale_by_adam_lp(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     *, moments: str = "bfloat16") -> GradientTransformation:
    """Adam's direction ``m_hat / (sqrt(v_hat) + eps)`` with m and v stored
    as ``moments`` says (module docstring) and every operation in
    float32."""
    if moments not in _STORE:
        raise ValueError(f"moments={moments!r}")
    store = _STORE[moments]
    int8 = moments == "int8"

    def init(params) -> ScaleByAdamLPState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=store, device=p.device)
        if int8:        # zeros encode to codes 0 and scales 0
            mu = {"q": tree_map(lambda p: torch.zeros(
                      _blocks(p), _Q8_BLOCK, dtype=torch.int8,
                      device=p.device), params),
                  "s": tree_map(lambda p: torch.zeros(
                      _blocks(p), device=p.device), params)}
        else:
            mu = tree_map(zeros, params)
        return ScaleByAdamLPState(0, mu, tree_map(zeros, params))

    @torch.no_grad()
    def leaf_update(g, m, n, c1, c2, mq=None, whole=None, block=None):
        """One leaf's Adam direction (a new tensor in g's dtype); m and n,
        the leaf's stored moments, are written in place (for "int8" m is
        the pair (codes, scales) ``mq``). Every float32 temporary is of
        this leaf's size. ``whole``/``block``: for an int8 m kept whole
        beside a cut leaf, the gradient's blocks gathered whole and this
        rank's block of a whole tensor (module docstring)."""
        gs = g.float()
        gm = gs if whole is None else whole(gs)
        if int8:
            if mq[0].shape[0] != _blocks(gm):
                raise ValueError(
                    f"an int8 m of {mq[0].shape[0]} blocks beside a gradient "
                    f"of {_blocks(gm)}: a cut leaf's update needs layout=")
            mf = [_q8_decode(mq[0], mq[1], gm.shape)]
        else:
            mf = [m if m.dtype == torch.float32 else m.float()]
        nf = [n if n.dtype == torch.float32 else n.float()]
        # m = b1 m + (1 - b1) g ;  n = b2 n + (1 - b2) g^2: the operations
        # and their order of the whole-tree chain, one leaf at a time
        torch._foreach_mul_(mf, b1)
        torch._foreach_add_(mf, torch._foreach_mul([gm], 1.0 - b1))
        sq = torch._foreach_mul([gs], [gs])
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(nf, b2)
        torch._foreach_add_(nf, sq)
        del sq, gs, gm
        den = torch._foreach_div(nf, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        out = torch._foreach_div(mf if block is None else [block(mf[0])], c1)
        torch._foreach_div_(out, den)
        del den
        if int8:
            q, s = _q8_encode(mf[0])
            mq[0].copy_(q)
            mq[1].copy_(s)
        elif mf[0] is not m:
            m.copy_(mf[0])
        if nf[0] is not n:
            n.copy_(nf[0])
        return out[0].to(g.dtype)

    @torch.no_grad()
    def update(grads, state: ScaleByAdamLPState, params=None, *,
               grad_scale=None, layout=None):
        """The directions as a new tree; the state's moments are updated
        in place (the update owns its state, as JAX's donated one) and
        returned in a state whose count is one more. ``grad_scale``, a
        pair of float32 scalar tensors (den, num), scales each gradient
        leaf by ``g / den * num`` as it is read (the clip, fused); the
        caller's gradients are left as they were. ``layout``: the
        ``parallel/fsdp.py:Layout`` of ``grads`` when they are this rank's
        blocks; an int8 m is then whole (``Layout.local_opt_state``) and
        reads each cut leaf's gradient gathered whole."""
        del params
        count = state.count + 1
        c1 = float(_f32(1) - np.power(_f32(b1), _f32(count)))
        c2 = float(_f32(1) - np.power(_f32(b2), _f32(count)))
        gl = tree_leaves(grads)
        nl = tree_leaves(state.nu)
        if int8:
            ml = list(zip(tree_leaves(state.mu["q"]),
                          tree_leaves(state.mu["s"])))
        else:
            ml = tree_leaves(state.mu)
        out = []
        for i, (g, m, n) in enumerate(zip(gl, ml, nl)):
            if grad_scale is not None:
                g = g / grad_scale[0] * grad_scale[1]
            if int8 and layout is not None and layout.is_cut(i):
                out.append(leaf_update(
                    g, None, n, c1, c2, mq=m,
                    whole=partial(layout.whole_leaf, i),
                    block=partial(layout.block_leaf, i)))
            elif int8:
                out.append(leaf_update(g, None, n, c1, c2, mq=m))
            else:
                out.append(leaf_update(g, m, n, c1, c2))
            del g
        return tree_unflatten(grads, out), ScaleByAdamLPState(
            count, state.mu, state.nu)

    return GradientTransformation(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a float32 scalar tensor."""
    sq = [torch.sum(g.float() * g.float()) for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_scale(grads, max_norm: float, norm: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(den, num), float32 scalar tensors: ``optax.clip_by_global_norm``
    scales every leaf by ``g / den * num``, (norm, max_norm) where the
    global norm is at least ``max_norm``, else (1, 1); decided on the
    device (no host read of the norm). ``norm``: the global norm when the
    gradients are shards (``parallel/fsdp.py:Layout.norm``)."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    return (torch.where(keep, one, norm),
            torch.where(keep, one, torch.full_like(norm, max_norm)))


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """``optax.clip_by_global_norm``: every leaf times ``max_norm / norm``
    where the global norm is at least ``max_norm`` (a new tree; ``norm``
    as ``clip_scale`` takes it)."""
    den, num = clip_scale(grads, max_norm, norm)
    return tree_map(lambda g: g / den * num, grads)


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
    def update(grads, state: ScaleByAdamLPState, params, *, norm=None,
               layout=None):
        """``norm``: the whole tree's global norm for the clip, when
        ``grads`` are this rank's shards of it; ``layout``: their
        ``Layout`` (``scale_by_adam_lp``'s update)."""
        scale = clip_scale(grads, grad_clip, norm) if grad_clip else None
        lr = float(_f32(schedule(state.count)))
        direction, state = adam.update(grads, state, grad_scale=scale,
                                       layout=layout)
        # leaf by leaf, so the update adds no tree-sized temporary
        for d, p in zip(tree_leaves(direction), tree_leaves(params)):
            torch._foreach_add_([d], [p.detach()], alpha=weight_decay)
            torch._foreach_mul_([d], -lr)
        return direction, state

    return GradientTransformation(adam.init, update)


def adamw(learning_rate: float, weight_decay: float = 0.0,
          grad_clip: Optional[float] = None) -> GradientTransformation:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decay on every leaf),
    after an optional global-norm clip: ``adamw_lp`` with float32
    moments."""
    return adamw_lp(learning_rate, weight_decay, moments="float32",
                    grad_clip=grad_clip)


class DualLRState(NamedTuple):
    """Each group's AdamW state, over that group's leaves (in the order of
    ``tree_leaves``) as a flat ``{index: tensor}`` tree."""
    groups: Dict[str, ScaleByAdamLPState]


def dual_lr(label_fn, lrs: Dict[str, float], *,
            grad_clip: Optional[float] = None,
            frozen_label: str = "frozen") -> GradientTransformation:
    """Per-group learning rates, ``optax.multi_transform``'s semantics (the
    functional equivalent of torch param groups + requires_grad=False):
    ``label_fn`` maps the parameter tree to a tree of group labels (or is
    that tree); each group in ``lrs`` takes its own ``optax.adamw(lr)``
    (weight decay 1e-4 on every leaf, float32 moments) over its leaves,
    and leaves labelled ``frozen_label`` get zero updates. ``grad_clip``
    clips the whole tree by its global norm first, the frozen leaves'
    gradients included, as ``optax.chain(clip_by_global_norm, tx)``."""
    groups = {name: adamw(lr, weight_decay=1e-4) for name, lr in lrs.items()}

    def labels(params):
        return tree_leaves(label_fn(params) if callable(label_fn)
                           else label_fn)

    def split(tree, names):
        leaves = tree_leaves(tree)
        return {g: {str(i): leaves[i] for i, n in enumerate(names) if n == g}
                for g in groups}

    def init(params) -> DualLRState:
        names = labels(params)
        unknown = set(names) - set(groups) - {frozen_label}
        if unknown:
            raise ValueError(f"labels {sorted(unknown)} have no rate in lrs "
                             f"and are not {frozen_label!r}")
        parts = split(params, names)
        return DualLRState({g: tx.init(parts[g]) for g, tx in groups.items()})

    @torch.no_grad()
    def update(grads, state: DualLRState, params):
        names = labels(params)
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        gparts, pparts = split(grads, names), split(params, names)
        out = [torch.zeros_like(g) for g in tree_leaves(grads)]
        new = {}
        for g, tx in groups.items():
            upd, new[g] = tx.update(gparts[g], state.groups[g], pparts[g])
            for i, u in upd.items():
                out[int(i)] = u
        return tree_unflatten(grads, out), DualLRState(new)

    return GradientTransformation(init, update)


class ReduceLROnPlateauState(NamedTuple):
    """``optax.contrib.ReduceLROnPlateauState`` on the host, at optax's
    default cooldown (none) and accumulation size (one value a decision):
    the float32 scale and best value, and the calls since an
    improvement."""
    scale: np.float32
    best_value: np.float32
    plateau_count: int


#: ``optax.contrib.reduce_on_plateau``'s default rtol (its atol is 0)
_PLATEAU_RTOL = 1e-4


def reduce_on_plateau(patience: int = 2, factor: float = 0.5,
                      min_scale: float = 1e-3) -> GradientTransformation:
    """ReduceLROnPlateau (reference: music2midi/train.py:467,524), the state
    machine of ``optax.contrib.reduce_on_plateau`` at the JAX package's
    patience, factor and min_scale and optax's defaults for the rest (rtol
    1e-4, atol 0, no cooldown, one value a decision). ``update(updates,
    state, params=None, *, value)``: a ``value`` (a validation loss) below
    ``(1 - rtol) * best`` is an improvement, and ``patience`` calls
    without one scale the updates by ``factor`` (down to ``min_scale``).
    Every call returns the updates times the current scale. Arithmetic in
    float32, as optax's."""
    if not 0.0 < factor < 1.0:
        raise ValueError(f"Factor must be in the range (0, 1), got factor "
                         f"= {factor}.")

    def init(params=None) -> ReduceLROnPlateauState:
        del params
        return ReduceLROnPlateauState(_f32(1.0), _f32(np.inf), 0)

    @torch.no_grad()
    def update(updates, state: ReduceLROnPlateauState, params=None, *,
               value):
        del params
        value = _f32(value)
        improved = bool(value < _f32(1 - _PLATEAU_RTOL) * state.best_value)
        plateau = 0 if improved else state.plateau_count + 1
        hit = plateau == patience
        scale = np.maximum(state.scale * _f32(factor) if hit
                           else state.scale, _f32(min_scale))
        state = ReduceLROnPlateauState(
            _f32(scale), value if improved else state.best_value,
            0 if hit else plateau)
        return tree_map(lambda g: g * float(state.scale), updates), state

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place (the step owns its trainable
    tensors, as the JAX step donates them)."""
    ps = tree_leaves(params)
    torch._foreach_add_(ps, [u.to(p.dtype) for p, u in
                             zip(ps, tree_leaves(updates))])
