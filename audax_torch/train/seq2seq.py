"""Seq2seq (Whisper) fine-tuning: the collator, the masked loss, and LoRA or
full-parameter train steps (port of ``audax/train/seq2seq.py``).

The JAX step is one jitted function that donates its state; the port's
step runs eagerly and updates the trainable tensors and the optimizer state
IN PLACE, which is what the donation achieves there. ``init_finetune``
therefore trains its own copy of the caller's parameters (full fine-tune)
or leaves them untouched (LoRA: the base tree is frozen, never updated).

Every attention of the forward goes through ``dot_product_attention``, so
on CUDA tensors the step runs the flash kernels forward (K2) and backward
(K7, K8); per-layer checkpointing (``remat``) replays each layer's forward
in the backward.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audax_torch.core.config import FineTuneConfig, WhisperConfig
from audax_torch.models.lora import apply_lora, init_lora
from audax_torch.models.whisper import (tree_leaves, tree_map, tree_unflatten,
                                        whisper_forward)
from audax_torch.parallel.mesh import use_mesh
from audax_torch.train.optim import (GradientTransformation, adamw_lp,
                                     apply_updates, seq2seq_schedule)

LABEL_PAD = -100

__all__ = ["collate_seq2seq", "accumulate_grads", "seq2seq_loss",
           "seq2seq_loss_sum", "make_finetune_step", "FTState",
           "init_finetune", "LABEL_PAD"]


def collate_seq2seq(
    label_ids: Sequence[Sequence[int]],
    *,
    decoder_start_id: int,
    pad_to: Optional[int] = None,
    pad_multiple: int = 8,
) -> Dict[str, np.ndarray]:
    """Label lists -> (decoder_input_ids, labels) with -100 masking.

    Labels are padded and the pad positions masked to -100; if every row
    starts with the decoder-start token it is stripped from the *labels*
    (the input side prepends it). decoder_input_ids = [start] +
    labels_without_pads.
    """
    rows = [list(map(int, r)) for r in label_ids]
    if rows and all(r and r[0] == decoder_start_id for r in rows):
        rows = [r[1:] for r in rows]
    max_len = max((len(r) for r in rows), default=0) + 1   # +1 for the shift
    max_len = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
    if pad_to:
        max_len = pad_to
    b = len(rows)
    dec_in = np.full((b, max_len), decoder_start_id, np.int32)
    labels = np.full((b, max_len), LABEL_PAD, np.int32)
    for i, r in enumerate(rows):
        r = r[: max_len - 1]
        dec_in[i, 1: 1 + len(r)] = r
        labels[i, : len(r)] = r
    return {"decoder_input_ids": dec_in, "labels": labels}


def seq2seq_loss_sum(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE over the non-masked (-100) positions, their count). The
    unnormalised form lets gradient accumulation reproduce the full-batch
    mean exactly: sum losses and counts over microbatches, divide once."""
    labels = labels.long()
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            labels.reshape(-1), ignore_index=LABEL_PAD,
                            reduction="sum")
    return total, (labels != LABEL_PAD).sum()


def accumulate_grads(loss_sum_fn: Callable, leaves: Sequence[torch.Tensor],
                     batch, accum_steps: int,
                     reduce: Optional[Callable] = None):
    """Gradient accumulation: ``batch`` (a tensor or a dict of tensors, B
    rows, B divisible by ``accum_steps``) split into ``accum_steps``
    microbatches run one after the other; the gradients of each one's
    summed loss (``loss_sum_fn(micro) -> (total, count)``) and the counts
    accumulate and are normalised once, so the update equals the
    full-batch step even with ragged label rows. Returns (gradients of
    ``leaves``, mean loss, summed count).

    ``reduce(grads, loss_sum, count) -> (grads, loss_sum, count)`` sums the
    three over the data ranks before the one normalisation (a mesh's
    ``Layout.reduce``): the loss is the global sum over the global count,
    never a mean of the ranks' means."""
    rows = (next(iter(batch.values())) if isinstance(batch, dict)
            else batch).shape[0]
    if rows % accum_steps:
        raise ValueError(f"batch size {rows} not divisible by "
                         f"accum_steps={accum_steps}")
    mb = rows // accum_steps
    gsum, lsum, csum = None, 0.0, 0.0
    for i in range(accum_steps):
        part = slice(i * mb, (i + 1) * mb)
        micro = ({k: v[part] for k, v in batch.items()}
                 if isinstance(batch, dict) else batch[part])
        total, count = loss_sum_fn(micro)
        g = torch.autograd.grad(total, leaves)
        gsum = list(g) if gsum is None else torch._foreach_add(gsum, g)
        lsum = lsum + total.detach()
        csum = csum + count.float()
    if reduce is not None:
        gsum, lsum, csum = reduce(gsum, lsum, csum)
    denom = torch.clamp_min(csum, 1.0)
    return [g / denom for g in gsum], lsum / denom, csum


def seq2seq_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the non-masked (-100) positions (count clamped at 1)."""
    total, count = seq2seq_loss_sum(logits, labels)
    return total / torch.clamp_min(count, 1)


@dataclasses.dataclass
class FTState:
    """Train state. ``trainable`` is the LoRA tree or the full parameters
    (leaves that require grad); ``base_params`` is the frozen base when
    LoRA is active, else empty.

    Under a mesh (``parallel/fsdp.py:shard_state``) both trees hold this
    rank's blocks: ``layout`` is the trainable tree's (TP and, with FSDP,
    the data axis), ``base_layout`` the frozen base's."""
    step: int
    base_params: Any
    trainable: Any
    opt_state: Any
    tx: GradientTransformation
    use_lora: bool = False
    lora_alpha: float = 16.0
    layout: Any = None
    base_layout: Any = None

    def model_params(self):
        """The tree the forward reads (under a mesh: this rank's TP blocks,
        the FSDP leaves gathered; call inside ``use_mesh``)."""
        trainable = (self.trainable if self.layout is None
                     else self.layout.use(self.trainable))
        if self.use_lora:
            return apply_lora(self.base_params, trainable, self.lora_alpha)
        return trainable

    def full_params(self, trainable=None):
        """The whole serving tree (LoRA merged) on every rank: gathered
        from the blocks under a mesh. ``trainable``: a tree laid out like
        the trainable one (an EMA) to serve instead."""
        trainable = self.trainable if trainable is None else trainable
        if self.layout is not None:
            trainable = self.layout.full(trainable)
        if not self.use_lora:
            return trainable
        base = (self.base_params if self.base_layout is None
                else self.base_layout.full(self.base_params))
        return apply_lora(base, trainable, self.lora_alpha)

    def replace(self, **changes) -> "FTState":
        return dataclasses.replace(self, **changes)


def init_finetune(params, cfg: FineTuneConfig, *,
                  lora_targets: Tuple[str, ...] = ("attn/q", "attn/v"),
                  generator: Optional[torch.Generator] = None) -> FTState:
    """The train state for ``params``: AdamW (``adamw_lp``, moments in
    ``cfg.moment_dtype``, clip 1.0) on the warmup + linear-decay schedule.
    LoRA adapters (``cfg.lora_rank > 0``) are drawn from ``generator``, a
    CPU generator seeded ``cfg.seed`` when None."""
    tx = adamw_lp(seq2seq_schedule(cfg.learning_rate, cfg.warmup_steps,
                                   cfg.max_steps),
                  moments=cfg.moment_dtype, grad_clip=1.0)
    if cfg.lora_rank > 0:
        base = tree_map(lambda t: t.detach(), params)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(cfg.seed)
        lora = init_lora(base, cfg.lora_rank, targets=lora_targets,
                         generator=gen)
        lora = tree_map(lambda t: t.requires_grad_(True), lora)
        return FTState(step=0, base_params=base, trainable=lora,
                       opt_state=tx.init(lora), tx=tx, use_lora=True,
                       lora_alpha=cfg.lora_alpha)
    trainable = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         params)
    return FTState(step=0, base_params={}, trainable=trainable,
                   opt_state=tx.init(trainable), tx=tx)


def make_finetune_step(model_cfg: WhisperConfig, *, remat=True,
                       dtype=torch.float32, accum_steps: int = 1) -> Callable:
    """The fine-tune step ``step(state, batch) -> (state, {"loss"})`` for
    batch = {"mel": [B, T, M], "decoder_input_ids", "labels"} tensors on
    one device. ``remat`` (True | "dots" | False) checkpoints each layer.

    ``accum_steps`` is gradient accumulation: the batch is split into that
    many microbatches run one after the other, the gradients of the SUMMED
    CE and the token counts are accumulated and normalised once, so the
    update equals the full-batch step even with ragged label rows. B must
    be divisible by ``accum_steps``. The loss stays on the device.

    A state laid out over a mesh (``parallel/fsdp.py:shard_state``) takes
    this rank's block of the batch: the forward runs under the mesh (TP
    collectives, FSDP gathers), the summed CE and the token count are
    summed over the data ranks before the one normalisation, and the
    clip's norm is the whole tree's."""
    fwd = partial(whisper_forward, remat=remat)

    def logits_of(state: FTState, batch):
        return fwd(state.model_params(), model_cfg, batch["mel"],
                   batch["decoder_input_ids"], dtype).float()

    def grads_and_loss(state: FTState, batch):
        leaves = tree_leaves(state.trainable)
        if accum_steps == 1:
            loss = seq2seq_loss(logits_of(state, batch), batch["labels"])
            return torch.autograd.grad(loss, leaves), loss.detach()
        grads, loss, _ = accumulate_grads(
            lambda micro: seq2seq_loss_sum(logits_of(state, micro),
                                           micro["labels"]),
            leaves, batch, accum_steps)
        return grads, loss

    def mesh_grads_and_loss(state: FTState, batch):
        with use_mesh(state.layout.mesh):
            grads, loss, _ = accumulate_grads(
                lambda micro: seq2seq_loss_sum(logits_of(state, micro),
                                               micro["labels"]),
                tree_leaves(state.trainable), batch, accum_steps,
                reduce=state.layout.reduce)
        return grads, loss

    def step(state: FTState, batch):
        lay = state.layout
        grads, loss = (grads_and_loss if lay is None
                       else mesh_grads_and_loss)(state, batch)
        grads = tree_unflatten(state.trainable, grads)
        kw = {} if lay is None else {"norm": lay.norm(grads), "layout": lay}
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.trainable, **kw)
        apply_updates(state.trainable, updates)
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    return step
