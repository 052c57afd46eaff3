"""Pipeline parallelism, GPipe over ``torch.distributed`` (port of
``audax/parallel/pp.py``): inference and training.

The layer stack is cut over a ``stage`` mesh axis: each rank holds the
layers of its stage (``pp_layer_specs`` / ``pp_shard``: every leaf under
``layers`` cut on its leading axis, parameters and Adam moments alike;
every rank builds the whole tree from one seed, then keeps its slice).
Microbatches flow through the stages: each of the ``n_micro + n_stages -
1`` ticks, stage 0 injects the next microbatch, every rank runs its local
layers, the last stage keeps its result, and the activations move one
stage on (``parallel/comm.py:ring_shift`` with ``wrap=False``, JAX's
``ppermute`` over ``[(i, i + 1)]``). The outputs leave through Megatron's
g over ``stage``: an all-reduce forward (only the last stage's are not
zeros) and an identity backward, since every rank computes the same loss
on them (an all-reduce backward would give every gradient S times).

The backward pipeline is autograd's: ``ring_shift`` sends the gradient the
other way. For that every rank must build the same graph, so the
injection and the output write are ``torch.where`` on every rank, never a
branch on the rank: each rank's exchanges then reach its loss and run
their backward, the same number of times in the same order on every rank
(a rank whose exchange were cut off its graph would leave its neighbour
waiting). ``remat=True`` checkpoints the local layer stack of each tick,
never the exchange.

Gradients: a stage's layer gradients stay on it; the embedding (read by
stage 0 alone, every rank computing it) passes Megatron's f over
``stage`` (``copy_over``), which sums the stages' parts so every rank
holds stage 0's; the final norm and head run on every rank alike. Under PP
x DP (``data_axis``) each microbatch's rows are cut over ``data`` (the
stage ring never crosses it) and the step sums the gradients, the summed
CE and its token count over ``data``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from audax_torch.core.config import WhisperConfig
from audax_torch.models.causal_lm import (CausalLMConfig, _attn_block,
                                          _mlp_block, _rope_tables,
                                          embed_tokens, lm_logits, rms_norm)
from audax_torch.models.whisper import (conv_stem, encoder_layer,
                                        layer_norm, layer_params,
                                        tree_leaves, tree_map,
                                        tree_unflatten)
from audax_torch.parallel.comm import copy_over, reduce_over, ring_shift
from audax_torch.parallel.mesh import (P, axis_group, axis_rank, axis_size,
                                       block_of, use_mesh)
from audax_torch.parallel.sharding import (_zip_map, local_slice,
                                           map_with_path)

__all__ = ["pipeline_apply", "encode_pipelined", "lm_forward_pipelined",
           "make_pp_lm_train_step", "pp_layer_specs", "pp_shard",
           "micro_rows"]


def _group(mesh, axis: Optional[str]):
    if axis is None or axis_size(mesh, axis) == 1:
        return None
    return axis_group(mesh, axis)


def _exchange(tensors, group):
    """The tick's activations one stage on, packed into one exchange."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    moved = ring_shift(flat, group, wrap=False)
    out, at = [], 0
    for t in tensors:
        out.append(moved[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def pipeline_apply(layers, block: Callable, micro, mesh, *,
                   stage_axis: str = "stage",
                   data_axis: Optional[str] = None, remat: bool = False):
    """Run ``micro`` through ``layers`` as a GPipe pipeline over the
    ``stage`` axis.

    ``layers``: THIS stage's slice of the stacked layer tree (leading axis
    L / S). ``micro``: a tensor [M, mb, ...] or a tuple of them (say, the
    activations and a key-padding lane: per-sample state rides the ring
    beside its microbatch, packed into the same exchange; the tuple's
    tensors share one dtype). ``block(x, layer) -> x`` is one layer over
    the non-M axes, the same structure in and out. ``data_axis`` cuts each
    microbatch's rows over that axis: the result then holds this rank's
    rows, [M, mb / data, ...]. Every rank returns the last stage's
    outputs, in ``micro``'s structure. Differentiable (module docstring);
    every rank of the stage group must call it alike."""
    single = isinstance(micro, torch.Tensor)
    micro = (micro,) if single else tuple(micro)
    n_stages = axis_size(mesh, stage_axis)
    stage = axis_rank(mesh, stage_axis)
    group = _group(mesh, stage_axis)
    if _group(mesh, data_axis) is not None:
        micro = tuple(block_of(m, axis_size(mesh, data_axis),
                                axis_rank(mesh, data_axis), dim=1)
                      for m in micro)
    n_micro = micro[0].shape[0]
    n_local = tree_leaves(layers)[0].shape[0]

    def run(*cur):
        x = cur[0] if single else cur
        for li in range(n_local):
            x = block(x, layer_params(layers, li))
        return (x,) if single else tuple(x)

    def stack(cur):
        if remat and torch.is_grad_enabled():
            return tuple(checkpoint(run, *cur, use_reentrant=False))
        return run(*cur)

    dev = micro[0].device
    yes, no = (torch.tensor(True, device=dev), torch.tensor(False,
                                                            device=dev))
    is_last = yes if stage == n_stages - 1 else no
    current = tuple(torch.zeros_like(m[0]) for m in micro)
    outputs = []
    total = n_micro + n_stages - 1
    for t in range(total):
        take = yes if stage == 0 and t < n_micro else no
        current = tuple(torch.where(take, m[min(t, n_micro - 1)], c)
                        for m, c in zip(micro, current))
        processed = stack(current)
        if t >= n_stages - 1:
            outputs.append(tuple(torch.where(is_last, p, torch.zeros_like(p))
                                 for p in processed))
        if t < total - 1:
            current = _exchange(processed, group)
    out = tuple(torch.stack([o[i] for o in outputs])
                for i in range(len(micro)))
    if group is not None:
        out = tuple(reduce_over(o, group) for o in out)
    return out[0] if single else out


def micro_rows(x: torch.Tensor, n_micro: int, mesh,
               data_axis: Optional[str]) -> torch.Tensor:
    """The rows of a global [B, ...] batch tensor that this rank's
    pipeline outputs hold, in their order: each microbatch's block over
    ``data_axis``, microbatch-major (the whole batch without one)."""
    if _group(mesh, data_axis) is None:
        return x
    m = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    m = block_of(m, axis_size(mesh, data_axis), axis_rank(mesh, data_axis),
                  dim=1)
    return m.reshape(-1, *x.shape[1:])


def _check_divisible(n_layers: int, n_stages: int, batch: int, n_micro: int):
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} stages")
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")


def _stage_layers(stack, n_layers: int, mesh, stage_axis: str):
    """This stage's slice of a stacked layer tree given whole (leading
    axis ``n_layers``) or already cut (``n_layers / stages``)."""
    n_stages = axis_size(mesh, stage_axis)
    lead = tree_leaves(stack)[0].shape[0]
    if lead == n_layers // n_stages:
        return stack
    if lead != n_layers:
        raise ValueError(f"layer stack of {lead} is neither the whole "
                         f"{n_layers} layers nor one of {n_stages} stages")
    r = axis_rank(mesh, stage_axis)
    return tree_map(lambda t: block_of(t, n_stages, r), stack)


def encode_pipelined(params, cfg: WhisperConfig, mel: torch.Tensor, mesh, *,
                     stage_axis: str = "stage",
                     data_axis: Optional[str] = None, n_micro: int = 4,
                     dtype=torch.float32, remat: bool = False
                     ) -> torch.Tensor:
    """mel [B, T_frames, n_mels] (the global batch on every rank) ->
    encoder states [B, S, d] (this rank's rows under ``data_axis``,
    ``micro_rows``), the encoder layers pipelined over ``stage_axis``.
    ``params``' encoder layers whole or this stage's slice. B must divide
    into n_micro microbatches; encoder_layers by the stage count."""
    group = _group(mesh, stage_axis)
    _check_divisible(cfg.encoder_layers, axis_size(mesh, stage_axis),
                     mel.shape[0], n_micro)
    with use_mesh(mesh):
        x = conv_stem(params, cfg, mel, dtype)
        if group is not None:
            x = copy_over(x, group)
        b = x.shape[0]
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        layers = _stage_layers(params["encoder"]["layers"],
                               cfg.encoder_layers, mesh, stage_axis)
        out = pipeline_apply(layers, lambda x, layer: encoder_layer(
            layer, cfg, x), micro, mesh, stage_axis=stage_axis,
            data_axis=data_axis, remat=remat)
        out = out.reshape(-1, *x.shape[1:])
        return layer_norm(params["encoder"]["ln"], out)


def lm_forward_pipelined(params, cfg: CausalLMConfig, tokens: torch.Tensor,
                         mesh, *, stage_axis: str = "stage",
                         data_axis: Optional[str] = None, n_micro: int = 4,
                         attention_mask: Optional[torch.Tensor] = None,
                         dtype=torch.float32, remat: bool = False
                         ) -> torch.Tensor:
    """tokens [B, T] (the global batch on every rank) -> logits [B, T, V]
    (this rank's rows under ``data_axis``, ``micro_rows``), the decoder
    layer stack pipelined over ``stage_axis`` (the training forward; exact
    against ``lm_forward``). The embedding, final norm and logits run on
    every rank. A key-padding ``attention_mask`` [B, T] rides the ring as a
    lane beside its microbatch."""
    group = _group(mesh, stage_axis)
    _check_divisible(cfg.layers, axis_size(mesh, stage_axis),
                     tokens.shape[0], n_micro)
    with use_mesh(mesh):
        x = embed_tokens(params, tokens, dtype, cfg.vocab_size)
        if group is not None:
            x = copy_over(x, group)
        b, t, d = x.shape
        rope = _rope_tables(torch.arange(t, device=x.device), cfg.head_dim,
                            cfg.rope_theta)
        layers = _stage_layers(params["layers"], cfg.layers, mesh,
                               stage_axis)
        micro_x = x.reshape(n_micro, b // n_micro, t, d)
        if attention_mask is None:
            def block(x, layer):
                x = x + _attn_block(layer, cfg, x, rope, causal=True)
                return x + _mlp_block(layer, cfg, x)

            out = pipeline_apply(layers, block, micro_x, mesh,
                                 stage_axis=stage_axis, data_axis=data_axis,
                                 remat=remat)
        else:
            micro_m = attention_mask.to(x.dtype).reshape(n_micro,
                                                         b // n_micro, t)

            def block(xm, layer):
                x, lane = xm
                mask = lane[:, None, None, :].bool()
                x = x + _attn_block(layer, cfg, x, rope, mask=mask,
                                    causal=True)
                return x + _mlp_block(layer, cfg, x), lane

            out, _ = pipeline_apply(layers, block, (micro_x, micro_m), mesh,
                                    stage_axis=stage_axis,
                                    data_axis=data_axis, remat=remat)
        hidden = rms_norm(params["norm"], out.reshape(-1, t, d), cfg.rms_eps)
        return lm_logits(params, cfg, hidden)


def pp_layer_specs(tree, mesh=None, *, stage_axis: str = "stage"):
    """The spec of every leaf of ``tree`` (parameters, or a moment tree
    that mirrors them): ``P(stage_axis)`` for a leaf under a ``layers`` key
    (its leading, stacked-layer axis), ``P()`` for the rest."""
    def spec(path, leaf):
        if "layers" in path.split("/") and leaf.dim() >= 1:
            return P(stage_axis)
        return P()
    return map_with_path(spec, tree)


def pp_shard(tree, mesh, *, stage_axis: str = "stage"):
    """This stage's tree: each leaf cut by ``pp_layer_specs`` (a copy of
    its own, so the whole tree can go). Takes a parameter tree or an
    optimizer state (a NamedTuple whose tree fields are cut alike)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(pp_shard(f, mesh, stage_axis=stage_axis)
                            if isinstance(f, dict) else f for f in tree))
    if not isinstance(tree, dict):
        return tree
    return _zip_map(lambda spec, leaf: local_slice(leaf, spec, mesh).clone()
                    if spec else leaf,
                    pp_layer_specs(tree, mesh, stage_axis=stage_axis), tree)


def make_pp_lm_train_step(cfg: CausalLMConfig, mesh, optimizer, *,
                          stage_axis: str = "stage",
                          data_axis: Optional[str] = None, n_micro: int = 4,
                          remat: bool = False) -> Callable:
    """The pipeline-parallel causal-LM training step: ``step(params,
    opt_state, tokens) -> (params, opt_state, loss)``. ``tokens`` [B, T]
    is the global batch on every rank; the next-token CE over it (labels
    = tokens shifted left, label ids < 0 masked, the collator's -100) is
    the global sum over the global count. ``params``/``opt_state`` hold
    this stage's layers (``pp_shard``) and the rest whole; ``optimizer``
    is the port's AdamW (``train/optim.py``), applied leaf by leaf, so the
    layer update is local to its stage. Under ``data_axis`` the gradients,
    the summed CE and the count are summed over ``data`` first. The
    parameters are updated in place and returned."""
    from audax_torch.parallel.fsdp import Layout
    from audax_torch.train.optim import apply_updates
    from audax_torch.train.seq2seq import seq2seq_loss_sum

    def step(params, opt_state, tokens):
        tokens = tokens.long()
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits = lm_forward_pipelined(
            params, cfg, tokens[:, :-1].clamp_min(0), mesh,
            stage_axis=stage_axis, data_axis=data_axis, n_micro=n_micro,
            remat=remat)
        total, count = seq2seq_loss_sum(
            logits.float(), micro_rows(tokens[:, 1:], n_micro, mesh,
                                       data_axis))
        # summed over the batch axis ('data'; never 'stage', where each
        # rank holds its own layers and the same loss)
        lay = Layout(mesh, pp_layer_specs(params, stage_axis=stage_axis))
        grads, total, count = lay.reduce(
            list(torch.autograd.grad(total, leaves)), total.detach(),
            count.float())
        denom = count.clamp_min(1.0)
        grads = tree_unflatten(params, [g / denom for g in grads])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, total / denom

    return step
