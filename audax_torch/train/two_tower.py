"""Two-tower trainable-only checkpoints (port of the checkpoint half of
``audax/train/two_tower.py``: ``save_trainable_checkpoint``,
``load_trainable_checkpoint``).

The reference's space-saving scheme (.charles/music2midi/train.py:281-334):
only what training can change is written -- the adapter, the top
``top_k_unfrozen_layers`` LM layers (slices of the stacked layer tensors),
the LM's other leaves (embeddings, final norm, a separate head) and the
step, with the optimizer state when there is one. The frozen layers below
are rebuilt from the model the checkpoint is merged over (its seed, or the
``--lm-ckpt`` it was built from). ``top_k_unfrozen_layers`` is clamped to
the layer count on both sides: past it everything is trainable, and an
unclamped ``n - k`` slice would splice fresh layers under the trained
ones.

``load_trainable_checkpoint`` reads the port's format (``train/
checkpoints.py``) and, through ``read_orbax``, one the JAX package wrote.
``TwoTowerState`` is the part of the JAX train state these two functions
read; the dual-LR optimizer and the train step arrive with two-tower
training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from audax_torch.models.two_tower import TwoTowerModel
from audax_torch.models.whisper import tree_map
from audax_torch.train.checkpoints import load_pytree, save_pytree

__all__ = ["TwoTowerState", "save_trainable_checkpoint",
           "load_trainable_checkpoint"]


@dataclasses.dataclass
class TwoTowerState:
    step: int
    params: Dict[str, Any]          # {"adapter": ..., "lm": ...}
    opt_state: Any = None


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
                              return_saved: bool = False):
    """Merge a trainable-only checkpoint over ``model``'s params (on their
    devices and dtypes). ``return_saved=True`` also returns the saved tree
    (step, opt_state and extra when present, as plain containers)."""
    saved = load_pytree(path)
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
