"""Two-tower training: dual-LR partial unfreezing, the train and eval
steps, and trainable-only checkpoints (port of ``audax/train/
two_tower.py``).

Reference semantics (.charles/music2midi/train.py): dual learning rates,
adapter 1e-4 / LM 2e-5 (:230-279); the Whisper tower frozen structurally
(its parameters never enter the optimizer, and its forward runs under
``no_grad``); grad clip 1.0 (:499); ReduceLROnPlateau on the val loss
(:467,524) through ``scale_learning_rates``; space-saving trainable-only
checkpoints (:281-334).

The optimizer is the JAX chain: one global-norm clip over every gradient,
then ``optax.adamw`` per group (adapter, LM) at its own learning rate with
optax's defaults (weight decay 1e-4 on every leaf, eps 1e-8). The rates
live in the optimizer state as float32 scalars (``inject_hyperparams``),
so the plateau scaling keeps the Adam moments.

Top-K unfreezing with stacked layers: the LM's layers are one [L, ...]
tensor each, so "unfreeze the top K" is a per-layer mask multiplied into
the gradients before the optimizer AND into the updates after it
(AdamW's decoupled decay would otherwise move the frozen layers). The
global norm is therefore taken over masked gradients; the frozen layers'
Adam moments still decay, while their weights stay bit-identical. The
embeddings and the final norm are not in ``layers`` and train at the LM's
rate.

The step runs eagerly and updates the state's parameters and moments in
place (the JAX step donates them). Over a mesh (``make_two_tower_step(...,
layout=)``, a ``parallel/fsdp.py:Layout`` of the trainable tree) the
state holds this rank's blocks, the forward runs under the mesh, and the
CE is the global sum over the global token count, so a batch every rank
runs whole (one whose rows the data axis does not divide) gives the same
gradient as one cut over the ranks. On the card its forward and backward go
through the kernels of ``models/two_tower.py``: K2 in the frozen encoder
and the adapter's cross-attention, K7/K8 in the adapter's backward; the
LM's attention has a padding mask and takes the materialised twin, as in
JAX.

``save_trainable_checkpoint`` writes only what training can change -- the
adapter, the top ``top_k_unfrozen_layers`` LM layers (slices of the stacked
tensors), the LM's other leaves, the step, and the optimizer state when
there is one; the frozen layers are rebuilt from the model the checkpoint
is merged over. ``top_k_unfrozen_layers`` is clamped to the layer count on
both sides. ``load_trainable_checkpoint`` reads the port's format and,
through ``read_orbax``, one the JAX package wrote.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from audax_torch.core.logging import get_logger
from audax_torch.models.two_tower import TwoTowerModel
from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten
from audax_torch.train.checkpoints import _match, load_pytree, save_pytree
from audax_torch.train.optim import (GradientTransformation,
                                     ScaleByAdamLPState, adamw,
                                     apply_updates, clip_by_global_norm)
from audax_torch.train.seq2seq import accumulate_grads

log = get_logger("audax_torch.two_tower")

__all__ = ["TwoTowerState", "TwoTowerOptState", "init_two_tower_optimizer",
           "init_two_tower_state", "make_two_tower_step",
           "layer_unfreeze_mask", "scale_learning_rates",
           "trainable_param_counts", "save_trainable_checkpoint",
           "load_trainable_checkpoint"]

#: optax.adamw's default decoupled weight decay
_WEIGHT_DECAY = 1e-4
_GROUPS = ("adapter", "lm")


@dataclasses.dataclass
class TwoTowerState:
    step: int
    params: Dict[str, Any]          # {"adapter": ..., "lm": ...}
    opt_state: Any = None
    tx: Optional[GradientTransformation] = None
    layer_mask: Optional[torch.Tensor] = None      # [L] 1.0 = trainable

    def replace(self, **changes) -> "TwoTowerState":
        return dataclasses.replace(self, **changes)


class TwoTowerOptState(NamedTuple):
    """Each group's Adam state and its learning rate, a float32 scalar
    tensor on the CPU (``{"adapter": ..., "lm": ...}`` both)."""
    adam: Dict[str, ScaleByAdamLPState]
    learning_rate: Dict[str, torch.Tensor]


def layer_unfreeze_mask(n_layers: int, top_k: int, *,
                        device=None) -> torch.Tensor:
    """[L] float32: 1.0 for the top-K layers, 0.0 below (reference
    TOP_K_QWEN_LAYERS=4, model.py:242-261)."""
    mask = torch.zeros(n_layers, device=device)
    if top_k > 0:
        mask[max(0, n_layers - top_k):] = 1.0
    return mask


def _mask_lm_grads(grads: Dict, mask: torch.Tensor) -> Dict:
    """Zero the gradients (or updates) of frozen (stacked) LM layers."""
    def mask_leaf(g):
        return g * mask.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)

    lm = dict(grads["lm"])
    lm["layers"] = tree_map(mask_leaf, lm["layers"])
    return {**grads, "lm": lm}


def init_two_tower_optimizer(model: TwoTowerModel
                             ) -> Tuple[GradientTransformation, torch.Tensor]:
    """(tx, layer mask): global-norm clipping at ``cfg.grad_clip``, then
    AdamW per group at ``cfg.adapter_lr`` / ``cfg.lm_lr`` (weight decay
    1e-4, float32 moments); the rates are read from the state, so
    ``scale_learning_rates`` moves them without rebuilding the moments."""
    cfg = model.cfg

    def init(params) -> TwoTowerOptState:
        rates = {"adapter": cfg.adapter_lr, "lm": cfg.lm_lr}
        return TwoTowerOptState(
            {g: adamw(rates[g], _WEIGHT_DECAY).init(params[g])
             for g in _GROUPS},
            {g: torch.tensor(rates[g], dtype=torch.float32)
             for g in _GROUPS})

    @torch.no_grad()
    def update(grads, state: TwoTowerOptState, params, *, norm=None):
        """``norm``: the whole tree's global norm when ``grads`` are this
        rank's blocks of it."""
        grads = clip_by_global_norm(grads, cfg.grad_clip, norm)
        updates, adam = {}, {}
        for g in _GROUPS:
            tx = adamw(float(state.learning_rate[g]), _WEIGHT_DECAY)
            updates[g], adam[g] = tx.update(grads[g], state.adam[g],
                                            params[g])
        return updates, state._replace(adam=adam)

    device = model.params["adapter"]["q"]["kernel"].device
    mask = layer_unfreeze_mask(model.lm_cfg.layers, cfg.top_k_unfrozen_layers,
                               device=device)
    return GradientTransformation(init, update), mask


def init_two_tower_state(model: TwoTowerModel) -> TwoTowerState:
    """Step 0 over a COPY of ``model.params`` (the step updates the state's
    tensors in place; the model's stay as they are)."""
    tx, mask = init_two_tower_optimizer(model)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      model.params)
    return TwoTowerState(step=0, params=params, opt_state=tx.init(params),
                         tx=tx, layer_mask=mask)


def scale_learning_rates(opt_state: TwoTowerOptState,
                         factor: float) -> TwoTowerOptState:
    """ReduceLROnPlateau primitive (reference: train.py:467,524): every
    learning rate times ``factor`` in float32; the moments are kept."""
    f = torch.tensor(factor, dtype=torch.float32)
    return opt_state._replace(learning_rate={
        g: lr * f for g, lr in opt_state.learning_rate.items()})


def make_two_tower_step(model: TwoTowerModel, *, accum_steps: int = 1,
                        layout=None) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) on a batch = {"mel": [B, T, n_mels],
    "input_ids": [B, L], "attention_mask": [B, L]} of tensors on the
    model's device; each returns {"loss": a device scalar} (train_step also
    the new state).

    ``accum_steps`` splits the batch into microbatches run one after the
    other (gradient_accumulation_steps semantics, AB/fineTune.py:165): the
    frozen encoder runs inside each microbatch, the gradients of the summed
    CE and the token counts accumulate and are normalised once, so the
    update equals the full-batch step. B must be divisible.

    ``layout``: the state's trainable tree laid out over a mesh (its
    ``mesh``, whose current use the step enters): each batch is this
    rank's rows or the whole batch on every rank; the summed CE and the
    token count are summed over the batch axes before the division, the
    gradients reduced and the clip's norm taken over the whole tree."""
    if layout is not None:
        return _mesh_steps(model, accum_steps, layout)

    def grads_and_loss(params, batch):
        leaves = tree_leaves(params)
        if accum_steps == 1:
            enc = model.encode_audio(batch["mel"])
            loss = model.loss(params, enc, batch["input_ids"],
                              batch["attention_mask"])
            return torch.autograd.grad(loss, leaves), loss.detach()
        grads, loss, _ = accumulate_grads(
            lambda micro: model.loss_sum(
                params, model.encode_audio(micro["mel"]),
                micro["input_ids"], micro["attention_mask"]),
            leaves, batch, accum_steps)
        return grads, loss

    def train_step(state: TwoTowerState, batch):
        grads, loss = grads_and_loss(state.params, batch)
        grads = _mask_lm_grads(tree_unflatten(state.params, grads),
                               state.layer_mask)
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.params)
        apply_updates(state.params,
                      _mask_lm_grads(updates, state.layer_mask))
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    @torch.no_grad()
    def eval_step(state: TwoTowerState, batch):
        enc = model.encode_audio(batch["mel"])
        return {"loss": model.loss(state.params, enc, batch["input_ids"],
                                   batch["attention_mask"])}

    return train_step, eval_step


def _mesh_steps(model: TwoTowerModel, accum_steps: int, lay
                ) -> Tuple[Callable, Callable]:
    """``make_two_tower_step``'s pair over ``lay.mesh``."""
    from audax_torch.parallel.comm import all_reduce_sum
    from audax_torch.parallel.mesh import batch_group, batch_size, use_mesh

    group = batch_group(lay.mesh) if batch_size(lay.mesh) > 1 else None

    def summed(t):
        return t if group is None else all_reduce_sum(t, group)

    def grads_and_loss(params, batch):
        leaves = tree_leaves(params)
        if accum_steps > 1:
            grads, loss, _ = accumulate_grads(
                lambda micro: model.loss_sum(
                    lay.use(params), model.encode_audio(micro["mel"]),
                    micro["input_ids"], micro["attention_mask"]),
                leaves, batch, accum_steps, reduce=lay.reduce)
            return grads, loss
        total, count = model.loss_sum(lay.use(params),
                                      model.encode_audio(batch["mel"]),
                                      batch["input_ids"],
                                      batch["attention_mask"])
        count = torch.clamp_min(summed(count.float()), 1.0)
        grads = lay.reduce_grads(torch.autograd.grad(total / count, leaves))
        return grads, summed(total.detach()) / count

    def train_step(state: TwoTowerState, batch):
        with use_mesh(lay.mesh):
            grads, loss = grads_and_loss(state.params, batch)
            grads = _mask_lm_grads(tree_unflatten(state.params, grads),
                                   state.layer_mask)
            updates, opt_state = state.tx.update(
                grads, state.opt_state, state.params, norm=lay.norm(grads))
        apply_updates(state.params,
                      _mask_lm_grads(updates, state.layer_mask))
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    @torch.no_grad()
    def eval_step(state: TwoTowerState, batch):
        with use_mesh(lay.mesh):
            enc = model.encode_audio(batch["mel"])
            return {"loss": model.loss(lay.use(state.params), enc,
                                       batch["input_ids"],
                                       batch["attention_mask"])}

    return train_step, eval_step


def trainable_param_counts(model: TwoTowerModel, mask: torch.Tensor
                           ) -> Dict[str, int]:
    """Parameter breakdown (reference report train.py:67-175)."""
    def count(tree):
        return sum(int(x.numel()) for x in tree_leaves(tree))

    per_layer = count(model.params["lm"]["layers"]) // model.lm_cfg.layers
    unfrozen_layers = int(np.asarray(mask.cpu()).sum())
    lm_other = count({k: v for k, v in model.params["lm"].items()
                      if k != "layers"})
    adapter = count(model.params["adapter"])
    return {
        "whisper_frozen": count(model.audio_params),
        "adapter": adapter,
        "lm_total": count(model.params["lm"]),
        "lm_trainable": per_layer * unfrozen_layers + lm_other,
        "trainable_total": adapter + per_layer * unfrozen_layers + lm_other,
    }


def _top_k(model: TwoTowerModel) -> int:
    return min(model.cfg.top_k_unfrozen_layers, model.lm_cfg.layers)


def save_trainable_checkpoint(path: str, state: TwoTowerState,
                              model: TwoTowerModel,
                              extra: Optional[Dict] = None, *,
                              save_optimizer: bool = True,
                              block: bool = True):
    """Persist the adapter, the top-K LM layer slices, the LM's other leaves,
    the step and (``save_optimizer``, when the state has one) the optimizer
    state. ``block=False`` returns the pending write; call its
    ``wait_until_finished()`` before relying on it."""
    k, n = _top_k(model), model.lm_cfg.layers
    lm = state.params["lm"]
    trainable = {
        "adapter": state.params["adapter"],
        "lm_top_layers": tree_map(lambda x: x[n - k:], lm["layers"]),
        "lm_other": {key: val for key, val in lm.items() if key != "layers"},
        "step": int(state.step),
    }
    if save_optimizer and state.opt_state is not None:
        trainable["opt_state"] = state.opt_state
    if extra:
        trainable["extra"] = extra
    return save_pytree(path, trainable, block=block)


def load_trainable_checkpoint(path: str, model: TwoTowerModel, *,
                              return_saved: bool = False,
                              opt_state_template=None):
    """Merge a trainable-only checkpoint over ``model``'s params (on their
    devices and dtypes). ``return_saved=True`` also returns the saved tree
    (step, opt_state and extra when present, as plain containers;
    ``opt_state_template``, e.g. ``tx.init(params)``, gives the optimizer
    state back in the template's structure, dtypes and devices)."""
    saved = load_pytree(path)
    if opt_state_template is not None and "opt_state" in saved:
        saved["opt_state"] = _match(opt_state_template, saved["opt_state"])
    k, n = _top_k(model), model.lm_cfg.layers
    lm = dict(model.params["lm"])

    def like(ref: torch.Tensor, val) -> torch.Tensor:
        return torch.as_tensor(val).to(device=ref.device, dtype=ref.dtype)

    lm["layers"] = tree_map(
        lambda full, top: torch.cat([full[: n - k], like(full, top)], 0),
        lm["layers"], saved["lm_top_layers"])
    for key, val in saved["lm_other"].items():
        # a leaf the model lacks (a separate head) takes the embedding's
        # device and dtype
        ref = lm.get(key, tree_map(lambda _: lm["embed"], val)
                     if isinstance(val, dict) else lm["embed"])
        lm[key] = (tree_map(like, ref, val) if isinstance(val, dict)
                   else like(ref, val))
    adapter = tree_map(like, model.params["adapter"], saved["adapter"])
    out = model._replace(params={"adapter": adapter, "lm": lm})
    return (out, saved) if return_saved else out
