"""The UrbanSound8K fold protocol: train on folds 1-8, evaluate fold 9
every epoch with the full metric suite, test fold 10 (port of
``audax/train/loops.py``: ``fit_classifier``, ``evaluate_classifier``).

The loops take dict-of-array splits (``{"x": [N, T, n_mels] float32, "y":
[N] int}``) and a classifier of ``models/classifiers.py`` and run on one
device: ``device=None`` is the CUDA card. Each train epoch fetches its
losses and accuracies from the device once; evaluation pads the final
batch and masks the padding rows, and fetches its predictions once.

Two differences from the JAX loop, by design: ``fit_classifier`` trains the
module's parameters as the caller built (or bridged) them, where the JAX
loop initialises from ``cfg.seed``; and under a mesh each rank draws its
own dropout masks, so mesh and single-device runs agree at dropout 0.

``mesh=`` trains data-parallel (``train/steps.py``): every batch goes
through ``parallel/mesh.py:shard_batch``, which pads it to a multiple of
the data ranks by repeating row 0, unmasked, as JAX's does -- the padding
rows count in the loss and metrics of both packages. Rank 0 alone writes
the checkpoints.

``ckpt_manager`` (a ``train/checkpoints.py:CheckpointManager``) keeps the
JAX contract: every epoch's end saves the parameters, the BatchNorm
statistics, the optimizer state and the step (asynchronously; the loop
calls ``wait()`` once at the end), and a run whose manager holds a step
resumes after the latest one. The port also saves the dropout generator's
state, which the JAX loop need not (it folds the step into its key), so a
run stopped after an epoch and resumed ends bit-equal to one that was not
stopped.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audax_torch.core.config import ClassifierTrainConfig
from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.data.batching import eval_batches, train_batches
from audax_torch.eval.metrics import detailed_metrics
from audax_torch.train.metrics_sink import MetricsSink
from audax_torch.parallel.fsdp import Layout
from audax_torch.parallel.mesh import P, shard_batch
from audax_torch.train.optim import adamw
from audax_torch.train.steps import TrainState, make_classifier_steps

__all__ = ["fit_classifier", "evaluate_classifier"]

log = get_logger("audax_torch.train")


def _to_device(batch: Dict[str, np.ndarray], device: torch.device,
               mesh=None):
    if mesh is not None:
        batch = shard_batch(mesh, {k: np.asarray(v) for k, v in
                                   batch.items()}, device)
        return {k: v.to(torch.int64 if k == "y" else torch.float32)
                for k, v in batch.items()}
    out = {"x": torch.from_numpy(np.ascontiguousarray(batch["x"],
                                                      np.float32)),
           "y": torch.from_numpy(np.asarray(batch["y"], np.int64))}
    if "w" in batch:
        out["w"] = torch.from_numpy(np.asarray(batch["w"], np.float32))
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


class _ReadOnly:
    """A checkpoint manager that restores but does not write (the ranks
    but 0 of a mesh)."""

    def __init__(self, manager):
        self._m = manager

    def __getattr__(self, name):
        return getattr(self._m, name)

    def save(self, *args, **kwargs):
        return None

    def wait(self):
        return None


def _device_of(state: TrainState) -> torch.device:
    return next(iter(state.params.values())).device


def _ckpt_tree(state: TrainState, generator: torch.Generator) -> Dict:
    return {"params": state.params, "batch_stats": state.buffers,
            "opt_state": state.opt_state, "step": state.step,
            "rng": generator.get_state()}


def _resume(ckpt_manager, state: TrainState,
            generator: torch.Generator) -> TrainState:
    """Load the latest checkpoint into the module's own tensors (in place),
    the optimizer state, the step and the dropout generator. A checkpoint
    of parameters and statistics alone resets the Adam moments."""
    try:
        restored = ckpt_manager.restore(_ckpt_tree(state, generator))
    except KeyError:
        restored = ckpt_manager.restore({"params": state.params,
                                         "batch_stats": state.buffers})
        restored.update(opt_state=state.opt_state, step=state.step,
                        rng=generator.get_state())
        log.warning("checkpoint has no optimizer state (old format); "
                    "Adam moments reset")
    with torch.no_grad():
        for name, t in list(state.params.items()) + list(
                state.buffers.items()):
            src = (restored["params"] if name in state.params
                   else restored["batch_stats"])[name]
            t.copy_(src)
    generator.set_state(restored["rng"])
    return state.replace(opt_state=restored["opt_state"],
                         step=restored["step"])


def evaluate_classifier(eval_step, state: TrainState,
                        data: Dict[str, np.ndarray], batch_size: int,
                        num_classes: int, mesh=None) -> Tuple[Dict, np.ndarray]:
    """Run eval over a split on the state's device; returns (metrics dict
    incl. loss, predictions). ``mesh``: ``eval_step`` is the mesh's
    (``make_classifier_steps(model, mesh)``) and each batch is cut over
    it."""
    device = _device_of(state)
    preds, losses, keeps = [], [], []
    numeric = {k: data[k] for k in ("x", "y")}
    for batch in eval_batches(numeric, batch_size):
        out = eval_step(state, _to_device(batch, device, mesh))
        keeps.append(int(batch["w"].sum()))
        preds.append(out["predictions"])
        losses.append(out["loss"])
    if preds:
        # one device -> host fetch for the whole split
        all_preds = torch.cat(preds).reshape(-1).cpu().numpy()
        all_losses = torch.stack(losses).cpu().numpy()
        predictions = np.concatenate(
            [p[:k] for p, k in zip(all_preds.reshape(len(keeps), -1), keeps)])
        loss = float(np.average(all_losses, weights=keeps))
    else:
        predictions = np.zeros(0, np.int64)
        loss = 0.0
    m = detailed_metrics(data["y"], predictions, num_classes)
    m["loss"] = loss
    return m, predictions


def fit_classifier(
    model: torch.nn.Module,
    train_data: Dict[str, np.ndarray],
    eval_data: Optional[Dict[str, np.ndarray]],
    cfg: ClassifierTrainConfig,
    *,
    num_classes: int = 10,
    mesh=None,
    sink: Optional[MetricsSink] = None,
    ckpt_manager=None,
    device: DeviceLike = None,
) -> Tuple[TrainState, Dict]:
    """Train ``model`` (moved to ``device``, trained in place) with AdamW;
    per-epoch eval with the full metric suite. Returns the train state and
    ``{"train_loss": [per epoch], "eval": [metrics per epoch]}``; each
    epoch's record (loss, accuracy, ``examples_per_s``, eval metrics) goes
    to ``sink`` or the log. ``mesh``: data-parallel over its batch axes
    (module docstring)."""
    device = resolve_device(device)
    model.to(device)
    train_data = {k: train_data[k] for k in ("x", "y")}
    if eval_data is not None:
        eval_data = {k: eval_data[k] for k in ("x", "y")}
    train_step, eval_step = make_classifier_steps(model, mesh)
    state = TrainState.create(model, adamw(cfg.learning_rate,
                                           cfg.weight_decay))
    lead = mesh is None or torch.distributed.get_rank() == 0
    if mesh is not None:
        state = state.replace(layout=Layout(
            mesh, {k: P() for k in state.params}))
        if not lead:
            ckpt_manager = _ReadOnly(ckpt_manager) if ckpt_manager else None
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    history: Dict[str, list] = {"train_loss": [], "eval": []}

    start_epoch = 0
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        state = _resume(ckpt_manager, state, generator)
        start_epoch = int(ckpt_manager.latest_step()) + 1
        log.info("resumed from epoch %d", start_epoch - 1)

    n_train = len(train_data["y"])
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        losses, accs = [], []
        for batch in train_batches(train_data, cfg.batch_size, cfg.seed,
                                   epoch):
            state, m = train_step(state, _to_device(batch, device, mesh),
                                  generator)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        # one device -> host fetch per epoch
        if losses:
            stacked = torch.stack(losses + accs).cpu().numpy()
            train_loss = float(stacked[: len(losses)].mean())
            train_acc = float(stacked[len(losses):].mean())
        else:
            train_loss = train_acc = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record = {"epoch": epoch, "train_loss": train_loss,
                  "train_accuracy": train_acc,
                  "examples_per_s": n_train / max(time.time() - t0, 1e-9)}
        history["train_loss"].append(train_loss)

        if eval_data is not None:
            em, _ = evaluate_classifier(eval_step, state, eval_data,
                                        cfg.batch_size, num_classes, mesh)
            record.update({
                "eval_loss": em["loss"], "eval_accuracy": em["accuracy"],
                "eval_f1_macro": em["f1_macro"],
                "eval_precision_macro": em["precision_macro"],
                "eval_recall_macro": em["recall_macro"],
            })
            history["eval"].append(em)
        if sink:
            sink.log(record, step=epoch)
        else:
            log.info("epoch %d: %s", epoch,
                     {k: round(v, 4) for k, v in record.items()
                      if isinstance(v, float)})
        if ckpt_manager is not None:
            ckpt_manager.save(epoch, _ckpt_tree(state, generator),
                              metrics={"val_loss": record.get("eval_loss",
                                                              train_loss)})
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return state, history
