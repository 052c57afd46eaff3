"""Standalone causal-LM training: a token stream -> a next-token LM (port
of ``audax/train/lm.py``).

The reference's music decoder is a pretrained Qwen3-0.6B from the HF hub
(.charles/music2midi/model.py:209-213); ``fit_lm`` pretrains a
Qwen-family ``CausalLMConfig`` model on any tokenized corpus (e.g. the ABC
corpus of the gentokens stages), so ``build_two_tower(lm_params=...)`` can
start from a music-aware decoder -- the command line's ``train-lm``.

The corpus is packed into fixed [N, seq_len+1] windows with no padding
mask, so the causal GQA attention of every layer takes the flash path: K2
forward and K7/K8 backward on the card (per-layer ``remat`` replays each
layer's forward, K2 included, in the backward). Gradient accumulation runs
microbatches one after the other with summed CE and token counts,
normalised once, so the update equals the full-batch step. The step
updates the parameters and the optimizer state in place. ``dtype``
bfloat16 computes in bfloat16 over float32 master weights.

``fit_lm(mesh=)`` trains on every rank of a (data, model) mesh: the
parameters cut by ``CAUSAL_LM_TP_RULES`` (with ``fsdp``, also over
'data'), each batch's rows over 'data', the summed CE, the token count
and the MoE aux loss's statistics summed over the data ranks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.models.causal_lm import (CausalLMConfig,
                                          load_balance_loss, lm_forward)
from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten
from audax_torch.train.optim import (GradientTransformation, adamw_lp,
                                     apply_updates,
                                     warmup_cosine_decay_schedule)
from audax_torch.parallel.fsdp import shard_state
from audax_torch.parallel.mesh import batch_group, shard_batch, use_mesh
from audax_torch.parallel.sharding import CAUSAL_LM_TP_RULES
from audax_torch.train.seq2seq import accumulate_grads, seq2seq_loss_sum

log = get_logger("audax_torch.train.lm")

__all__ = ["LMTrainConfig", "LMState", "pack_corpus", "init_lm_state",
           "make_lm_train_step", "fit_lm"]

_REMAT = {"": False, "full": True, "dots": "dots"}


@dataclass(frozen=True)
class LMTrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    max_steps: int = 1000
    batch_size: int = 32
    seq_len: int = 256
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    accum_steps: int = 1
    dtype: str = "float32"           # compute dtype; params stay f32
    eval_every: int = 100
    eval_windows: int = 16           # held-out packed windows
    #: MoE models: Switch load-balancing aux loss coefficient
    #: (HF Qwen3-MoE router_aux_loss_coef default)
    aux_loss_coef: float = 0.001
    #: gradient checkpointing: "" off, "full" per-layer recompute,
    #: "dots" per-layer keeping the projection outputs
    remat: str = ""
    #: Adam moment storage dtype (train/optim.py:scale_by_adam_lp)
    moment_dtype: str = "float32"
    seed: int = 0


@dataclasses.dataclass
class LMState:
    step: int
    params: Any
    opt_state: Any
    tx: GradientTransformation
    #: the params' layout over a mesh (parallel/fsdp.py:shard_state)
    layout: Any = None

    def replace(self, **changes) -> "LMState":
        return dataclasses.replace(self, **changes)


def pack_corpus(ids: np.ndarray, seq_len: int) -> np.ndarray:
    """Contiguous packing of a token stream into [N, seq_len+1] windows
    (window w trains on w[:-1] -> w[1:]; consecutive windows overlap by one
    token so every transition is trained once). The tail shorter than a
    window is dropped."""
    ids = np.asarray(ids, np.int32).reshape(-1)
    n = (len(ids) - 1) // seq_len
    if n < 1:
        raise ValueError(f"corpus of {len(ids)} tokens is shorter than one "
                         f"{seq_len}-token window")
    out = np.empty((n, seq_len + 1), np.int32)
    for i in range(n):
        out[i] = ids[i * seq_len: i * seq_len + seq_len + 1]
    return out


def _dtype(cfg: LMTrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _make_tx(cfg: LMTrainConfig) -> GradientTransformation:
    sched = warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps,
        max(cfg.max_steps, cfg.warmup_steps + 1))
    return adamw_lp(sched, weight_decay=cfg.weight_decay,
                    moments=cfg.moment_dtype, grad_clip=cfg.clip_norm)


def init_lm_state(params: Any, cfg: LMTrainConfig) -> LMState:
    """The train state over ``params`` themselves (the step updates them in
    place: pass a copy to keep the originals)."""
    tx = _make_tx(cfg)
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    return LMState(step=0, params=params, opt_state=tx.init(params), tx=tx)


def make_lm_train_step(model_cfg: CausalLMConfig, train_cfg: LMTrainConfig):
    """The step ``(state, windows [B, T+1] int tensor) -> (state, {"loss",
    "tokens"})``, in place. Windows' negative ids (LABEL_PAD) are masked
    from the labels and clamped to 0 as inputs. The loss and the token count
    stay on the device. MoE models add the Switch load-balancing aux loss
    (``aux_loss_coef``), scaled by the microbatch's token count so that
    accumulation normalises it with the CE."""
    dtype = _dtype(train_cfg)
    accum = max(1, train_cfg.accum_steps)
    remat = _REMAT[train_cfg.remat]
    aux = model_cfg.num_experts > 0 and train_cfg.aux_loss_coef

    def batch_loss(params, windows, group=None):
        inp = torch.clamp_min(windows[:, :-1], 0)
        out = lm_forward(params, model_cfg, inp, dtype=dtype,
                         return_router_logits=bool(aux), remat=remat)
        logits, router = out if aux else (out, None)
        total, count = seq2seq_loss_sum(logits.float(), windows[:, 1:])
        if aux:
            total = total + train_cfg.aux_loss_coef * load_balance_loss(
                router, model_cfg.num_experts,
                model_cfg.experts_per_tok, group=group) * count
        return total, count

    def step(state: LMState, windows: torch.Tensor):
        lay = state.layout
        if lay is None:
            grads, loss, count = accumulate_grads(
                lambda micro: batch_loss(state.params, micro),
                tree_leaves(state.params), windows, accum)
        else:
            with use_mesh(lay.mesh):
                grads, loss, count = accumulate_grads(
                    lambda micro: batch_loss(lay.use(state.params), micro,
                                             batch_group(lay.mesh)),
                    tree_leaves(state.params), windows, accum,
                    reduce=lay.reduce)
        grads = tree_unflatten(state.params, grads)
        kw = {} if lay is None else {"norm": lay.norm(grads), "layout": lay}
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.params, **kw)
        apply_updates(state.params, updates)
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": loss, "tokens": count})

    return step


@torch.no_grad()
def _eval_loss(params, model_cfg: CausalLMConfig, windows: torch.Tensor,
               dtype) -> float:
    total, count = seq2seq_loss_sum(
        lm_forward(params, model_cfg, torch.clamp_min(windows[:, :-1], 0),
                   dtype=dtype).float(), windows[:, 1:])
    return float(total) / max(float(count), 1.0)


def fit_lm(params: Any, model_cfg: CausalLMConfig, train_cfg: LMTrainConfig,
           corpus_ids: np.ndarray, *, mesh=None, fsdp: bool = False,
           ckpt_dir: Optional[str] = None, sink=None,
           device: DeviceLike = None) -> Tuple[Any, List[Dict]]:
    """Train a copy of ``params`` on ``corpus_ids`` (one flat token stream)
    on ``device`` (default the CUDA card); returns (trained params,
    history).

    Held-out eval: the LAST ``eval_windows`` packed windows are reserved for
    perplexity and never trained on. Batches are drawn as the JAX loop draws
    them (``np.random.default_rng(seed).choice``). Saves checkpoints
    (latest + best by eval loss, ``train/checkpoints.py:CheckpointManager``,
    with the model config as ``config.json``) when ``ckpt_dir`` is set.

    ``mesh``: train on every rank of it (module docstring); ``fsdp`` also
    cuts parameters and moments over 'data'. The evaluation runs whole on
    every rank, rank 0 alone writes the checkpoints, and the returned
    params are whole."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    device = resolve_device(device)
    windows = pack_corpus(corpus_ids, train_cfg.seq_len)
    n_eval = min(train_cfg.eval_windows,
                 max(0, len(windows) - train_cfg.batch_size))
    train_w, eval_w = (windows[:-n_eval], windows[-n_eval:]) \
        if n_eval else (windows, None)
    if len(train_w) < train_cfg.batch_size:
        # tiny corpora: repeat windows so one fixed-shape batch exists
        reps = -(-train_cfg.batch_size // len(train_w))
        train_w = np.tile(train_w, (reps, 1))
    train_dev = torch.from_numpy(train_w).to(device)
    eval_dev = torch.from_numpy(eval_w).to(device) if n_eval else None
    dtype = _dtype(train_cfg)
    step = make_lm_train_step(model_cfg, train_cfg)
    state = init_lm_state(tree_map(lambda t: t.detach().to(device).clone(),
                                   params), train_cfg)
    lay = None
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp, rules=CAUSAL_LM_TP_RULES,
                            heads=model_cfg.heads)
        lay = state.layout
    lead = mesh is None or torch.distributed.get_rank() == 0
    rng = np.random.default_rng(train_cfg.seed)
    manager = None
    if ckpt_dir and lead:
        from audax_torch.train.checkpoints import CheckpointManager
        manager = CheckpointManager(ckpt_dir, best_metric="val_loss",
                                    config=dataclasses.asdict(model_cfg))
    history: List[Dict] = []
    for it in range(train_cfg.max_steps):
        idx = rng.choice(len(train_w), train_cfg.batch_size,
                         replace=len(train_w) < train_cfg.batch_size)
        batch = train_dev[torch.from_numpy(idx).to(device)]
        if mesh is not None:
            batch = shard_batch(mesh, batch, device)
        state, metrics = step(state, batch)
        is_eval = (train_cfg.eval_every
                   and (it + 1) % train_cfg.eval_every == 0)
        if is_eval or it + 1 == train_cfg.max_steps:
            row = {"step": it + 1, "loss": float(metrics["loss"])}
            if eval_dev is not None and lay is not None:
                with use_mesh(mesh), torch.no_grad():
                    ev = _eval_loss(lay.use(state.params), model_cfg,
                                    eval_dev, dtype)
            elif eval_dev is not None:
                ev = _eval_loss(state.params, model_cfg, eval_dev, dtype)
            if eval_dev is not None:
                row["eval_loss"] = ev
                row["eval_ppl"] = float(np.exp(min(ev, 30.0)))
            history.append(row)
            if sink is not None:
                sink.log(row)
            log.info("lm step %d: %s", it + 1,
                     {k: round(v, 4) for k, v in row.items()})
            if ckpt_dir:
                # every rank joins the gather; rank 0 writes
                whole = (state.params if lay is None
                         else lay.full(state.params))
            if manager is not None:
                manager.save(it + 1, whole, metrics={
                    "val_loss": row.get("eval_loss", row["loss"])})
    if manager is not None:
        manager.close()
    whole = state.params if lay is None else lay.full(state.params)
    return tree_map(lambda t: t.detach(), whole), history
