"""Classifier train and eval steps (port of ``audax/train/steps.py``).

One step is forward, softmax cross-entropy, gradients and the optimizer
update. The JAX step is one jitted function that donates its state; the
port's step runs eagerly and updates the module's parameters, its BatchNorm
running statistics and the optimizer state IN PLACE, as
``train/seq2seq.py`` does. ``TrainState.params`` and ``.buffers`` are the
module's own tensors, by name.

Dropout draws from the ``torch.Generator`` handed to ``train_step``
(``fit_classifier`` seeds one from ``cfg.seed``); JAX folds the step into a
``jax.random`` key. Same distribution, different masks, so parity with the
JAX package holds at dropout 0 or in eval mode.

Under a mesh (``make_classifier_steps(model, mesh)``, data parallelism:
the parameters whole on every rank, each batch's rows cut over the batch
axes) the loss and accuracy are the whole batch's means (each rank's
block is the same size), BatchNorm's statistics the whole batch's
(``models/classifiers.py``), the gradients summed over the data ranks, and
the eval step's loss, logits and predictions the whole batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from audax_torch.parallel.comm import all_gather_cat, all_reduce_sum
from audax_torch.parallel.mesh import batch_group, batch_size, use_mesh
from audax_torch.train.optim import GradientTransformation, apply_updates

__all__ = ["TrainState", "make_classifier_steps", "cross_entropy"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt_state: Any
    tx: GradientTransformation
    #: the params' layout over a mesh (whole on every rank; the gradient
    #: all-reduce over 'data' reads it)
    layout: Any = None

    @classmethod
    def create(cls, model: torch.nn.Module,
               tx: GradientTransformation) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params, buffers=dict(model.named_buffers()),
                   opt_state=tx.init(params), tx=tx)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy; with per-example ``weights`` (which mask
    the padding rows of fixed-size eval batches) ``sum(w * l) /
    max(sum(w), 1)``."""
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if weights is None:
        return losses.mean()
    return (losses * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def make_classifier_steps(model: torch.nn.Module, mesh=None
                          ) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` for a classifier of
    ``models/classifiers.py``.

    ``train_step(state, batch, generator=None) -> (state, {"loss",
    "accuracy"})`` with batch = {"x", "y"} tensors on the model's device;
    ``eval_step(state, batch) -> {"loss", "logits", "predictions"}``, where
    an optional "w" masks padding rows. Metrics stay on the device.
    ``mesh``: each batch is this rank's block (module docstring)."""
    n = 1 if mesh is None else batch_size(mesh)

    def whole_mean(t: torch.Tensor) -> torch.Tensor:
        return t if n == 1 else all_reduce_sum(t, batch_group(mesh)) / n

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        names = list(state.params)
        with use_mesh(mesh):
            logits = model(batch["x"], train=True, generator=generator)
        loss = cross_entropy(logits, batch["y"], batch.get("w"))
        grads = torch.autograd.grad(loss / n,
                                    [state.params[k] for k in names])
        kw = {}
        if state.layout is not None:
            grads = state.layout.reduce_grads(grads)
        grads = dict(zip(names, grads))
        if state.layout is not None:
            kw["norm"] = state.layout.norm(grads)
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.params, **kw)
        apply_updates(state.params, updates)
        acc = (logits.detach().argmax(-1) == batch["y"]).float().mean()
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": whole_mean(loss.detach()),
                 "accuracy": whole_mean(acc)})

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        logits = model(batch["x"], train=False)
        if n == 1:
            loss = cross_entropy(logits, batch["y"], batch.get("w"))
        else:
            group = batch_group(mesh)
            logits = all_gather_cat(logits, group, 0)
            y = all_gather_cat(batch["y"], group, 0)
            w = (all_gather_cat(batch["w"], group, 0) if "w" in batch
                 else None)
            loss = cross_entropy(logits, y, w)
        return {"loss": loss, "logits": logits,
                "predictions": logits.argmax(-1)}

    return train_step, eval_step
