"""Sequence parallelism for the Whisper encoder (port of
``audax/parallel/sp.py``).

The encoder's frames are cut over a ``seq`` mesh axis: LayerNorm, MLP and
the projections are position-local, so only attention communicates. Two
attention schedules, both exact bidirectional attention:

  * ``ring=True`` (default): ring attention. The K/V blocks travel the
    ring (``parallel/comm.py:ring_shift``) while each rank folds every
    block it holds into its queries' result. Each step is one launch of the
    flash forward K2, which returns ``(o_j, lse_j)`` for the held block;
    the steps merge by the log-sum-exp rule (``lse = logaddexp(lse,
    lse_j)``, each ``o`` rescaled by ``exp(lse_old - lse)``), so a rank
    never holds more than one K/V block. The backward uses the global
    ``o``, the global ``lse`` and ``D = rowsum(dO * O)``: at each step K7
    adds the held block's share of dQ, and K8's dK/dV of the block are
    added to accumulators that travel with it, so after ``n_seq`` shifts
    every block's gradient is home. K7/K8 must take the global ``lse``:
    with the block's own they would be right at one rank only. On CPU
    tensors the same schedule runs the kernels' plain versions.
  * ``ring=False``: Ulysses-style. K/V are all-gathered over ``seq`` once a
    layer (``comm.py:gather_for_use``, whose backward reduce-scatters:
    every rank reads the whole K/V with its own queries) and the flash
    attention (K2, K7/K8) runs on them.

JAX writes the ring as an online softmax of einsums inside ``shard_map``;
the port writes the collectives and autograd the same sums take.

Gradient bookkeeping, which GSPMD and ``shard_map``'s transpose do for the
JAX package: the encoder's parameters are read through Megatron's f over
``seq`` (``copy_over``), because each rank's frames give a part of their
gradient; the encoder states are gathered over ``seq`` (``gather_over``,
whose backward keeps this rank's slice), because every rank of a ``seq``
group runs the same decoder on them and computes the same loss; and the
summed CE, its token count and every gradient are summed over ``data``
before the one normalisation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from audax_torch.core.config import FineTuneConfig, WhisperConfig
from audax_torch.models.whisper import (_remat_body, conv_stem, decode_train,
                                        encoder_layer, layer_norm,
                                        layer_params, tree_leaves, tree_map,
                                        tree_unflatten)
from audax_torch.ops.attention import (flash_attention,
                                       flash_backward_dkv_cuda,
                                       flash_backward_dkv_plain,
                                       flash_backward_dq_cuda,
                                       flash_backward_dq_plain, flash_forward)
from audax_torch.parallel.comm import (_shift, copy_over, gather_for_use,
                                       gather_over)
from audax_torch.parallel.mesh import (P, axis_group, axis_rank, axis_size,
                                       block_of, use_mesh)

__all__ = ["ring_attention", "ulysses_attention",
           "encode_sequence_parallel", "sp_whisper_forward",
           "make_sp_finetune_step"]


def _dq(q, k, v, o, lse, do, delta, scale):
    """K7 on CUDA tensors (``delta`` shared by the step's K8), else its
    plain version, which computes the same delta from the global o/do."""
    if q.is_cuda:
        return flash_backward_dq_cuda(q, k, v, o, lse, do, scale=scale,
                                      delta=delta)
    return flash_backward_dq_plain(q, k, v, o, lse, do, scale=scale)


def _dkv(q, k, v, o, lse, do, delta, scale):
    if q.is_cuda:
        return flash_backward_dkv_cuda(q, k, v, o, lse, do, scale=scale,
                                       delta=delta)
    return flash_backward_dkv_plain(q, k, v, o, lse, do, scale=scale)


def _pair_shift(a: torch.Tensor, b: torch.Tensor, group):
    """Two like-shaped blocks one hop round the ring, in one exchange."""
    both = _shift(torch.stack([a, b]), group, 1, True)
    return both[0], both[1]


class _RingAttention(torch.autograd.Function):
    """Exact attention of the local queries over the K/V blocks of every
    rank of ``group`` (module docstring). Saves q, k, v (home blocks), the
    global o and lse; every rank shifts the same number of times in the
    forward (n - 1) and the backward (2n - 1)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, group):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        n = dist.get_world_size(group)
        b, h, s, _ = q.shape
        o = lse = None
        kc, vc = k, v
        for step in range(n):
            o_j, lse_j = flash_forward(q, kc, vc, scale=scale)
            if o is None:
                o, lse = o_j.float(), lse_j
            else:
                new = torch.logaddexp(lse, lse_j)
                o = (o * torch.exp(lse - new).view(b, h, s, 1)
                     + o_j.float() * torch.exp(lse_j - new).view(b, h, s, 1))
                lse = new
            if step < n - 1:
                kc, vc = _pair_shift(kc, vc, group)
        o = o.to(q.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.group = scale, group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n = dist.get_world_size(group)
        do = do.contiguous()
        b, h, s, _ = q.shape
        delta = (do.float() * o.float()).sum(-1).reshape(b * h, s) \
            .contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for step in range(n):
            dq += _dq(q, kc, vc, o, lse, do, delta, scale).float()
            dk_j, dv_j = _dkv(q, kc, vc, o, lse, do, delta, scale)
            dk += dk_j.float()
            dv += dv_j.float()
            if step < n - 1:
                kc, vc = _pair_shift(kc, vc, group)
            # the accumulators travel with their block: after n shifts
            # each rank holds its own block's
            dk, dv = _pair_shift(dk, dv, group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, scale: float) -> torch.Tensor:
    """Ring attention over ``group``: q/k/v [B, H, S_local, hd] are this
    rank's frame block; the result is exact bidirectional attention of its
    queries over every rank's keys (K2 a step forward, K7 + K8 a step
    backward on CUDA tensors)."""
    if dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, scale=scale)
    return _RingAttention.apply(q, k, v, scale, group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group, scale: float) -> torch.Tensor:
    """The all-gather schedule: every rank's K/V gathered (the gradient
    reduce-scattered back), then flash attention."""
    if dist.get_world_size(group) > 1:
        k = gather_for_use(k.contiguous(), group, 2)
        v = gather_for_use(v.contiguous(), group, 2)
    return flash_attention(q, k, v, scale=scale)


def _check(s: int, n_seq: int, b: int, n_data: int) -> None:
    if s % n_seq:
        raise ValueError(f"sequence {s} not divisible by seq axis {n_seq}")
    if b % n_data:
        raise ValueError(f"batch {b} not divisible by data axis {n_data}")


def _sp_encode(params, cfg: WhisperConfig, mel: torch.Tensor, mesh, *,
               seq_axis: str, data_axis: str, dtype, ring: bool,
               remat=False) -> torch.Tensor:
    """This rank's data rows of the encoder states, their whole sequence:
    [B / data, S, d]. ``mel`` is the global batch (every rank the same)."""
    n_seq, n_data = axis_size(mesh, seq_axis), axis_size(mesh, data_axis)
    s, b = mel.shape[1] // 2, mel.shape[0]
    _check(s, n_seq, b, n_data)
    group = axis_group(mesh, seq_axis) if n_seq > 1 else None
    enc = params["encoder"]
    if group is not None:
        # each rank's frames give part of every encoder leaf's gradient
        enc = tree_map(lambda t: copy_over(t, group) if t.requires_grad
                       else t, enc)
    mel = block_of(mel, n_data, axis_rank(mesh, data_axis))
    x = conv_stem({"encoder": enc}, cfg, mel, dtype)       # whole sequence
    x = block_of(x, n_seq, axis_rank(mesh, seq_axis), dim=1)  # my frames
    if group is None:
        core = None
    else:
        attend = ring_attention if ring else ulysses_attention

        def core(q, k, v, scale):
            return attend(q, k, v, group=group, scale=scale)

    def body(x, layer):
        return encoder_layer(layer, cfg, x, core=core)

    body = _remat_body(body, remat)
    for li in range(cfg.encoder_layers):
        x = body(x, layer_params(enc["layers"], li))
    x = layer_norm(enc["ln"], x)
    return x if group is None else gather_over(x, group, 1)


def encode_sequence_parallel(params, cfg: WhisperConfig, mel: torch.Tensor,
                             mesh, *, seq_axis: str = "seq",
                             data_axis: str = "data", dtype=torch.float32,
                             ring: bool = True) -> torch.Tensor:
    """mel [B, T_frames, n_mels] (the global batch, the same on every rank)
    -> encoder states, the frame axis cut over ``seq_axis`` inside the
    transformer stack. ``conv_stem`` runs whole on every rank of this
    rank's data rows; the rank keeps its frame block [B / data, S / seq,
    d]; the stack runs on it; the result is gathered over ``seq``, so each
    rank returns its data rows' states whole: [B / data, S, d].

    ``ring=True`` is ring attention (one K/V block a rank at a time);
    ``ring=False`` all-gathers K/V once a layer. (T_frames / 2) must divide
    by the seq axis and B by the data axis."""
    with use_mesh(mesh):
        return _sp_encode(params, cfg, mel, mesh, seq_axis=seq_axis,
                          data_axis=data_axis, dtype=dtype, ring=ring)


def sp_whisper_forward(params, cfg: WhisperConfig, mel: torch.Tensor,
                       tokens: torch.Tensor, mesh, *, seq_axis: str = "seq",
                       data_axis: str = "data", dtype=torch.float32,
                       ring: bool = True, remat=False) -> torch.Tensor:
    """Differentiable seq2seq forward with the ENCODER sequence-parallel:
    ``mel`` [B, T, n_mels] and ``tokens`` [B, L] are the global batch; the
    result is the logits of this rank's data rows [B / data, L, V]. The
    decoder runs batch-cut over ``data`` on the encoder states gathered
    over ``seq``. ``remat`` checkpoints each layer of both stacks, ring
    included: the recompute replays the ring on every rank in the same
    order."""
    with use_mesh(mesh):
        enc = _sp_encode(params, cfg, mel, mesh, seq_axis=seq_axis,
                         data_axis=data_axis, dtype=dtype, ring=ring,
                         remat=remat)
        tokens = block_of(tokens, axis_size(mesh, data_axis),
                       axis_rank(mesh, data_axis))
        return decode_train(params, cfg, tokens, enc, dtype, remat=remat)


def make_sp_finetune_step(model_cfg: WhisperConfig, mesh,
                          cfg: FineTuneConfig, *, seq_axis: str = "seq",
                          data_axis: str = "data", dtype=torch.float32,
                          ring: bool = True) -> Callable:
    """The DP x SP fine-tune step, with the contract of
    ``train/seq2seq.py:make_finetune_step``: ``step(state, batch) ->
    (state, {"loss"})`` for batch = {"mel", "decoder_input_ids",
    "labels"}, the GLOBAL batch on every rank (JAX's step takes the global
    array too). ``state`` is ``init_finetune``'s, whole on every rank (full
    or LoRA); every rank applies the same update.

    ``cfg.accum_steps`` microbatches run one after the other, outside the
    ring (each its own SP forward and backward); the summed CE, the token
    count and the gradients are summed over ``data`` and normalised once,
    the exact full-batch update. ``cfg.gradient_checkpointing`` checkpoints
    each layer of both stacks."""
    from audax_torch.parallel.fsdp import Layout
    from audax_torch.train.optim import apply_updates
    from audax_torch.train.seq2seq import accumulate_grads, seq2seq_loss_sum

    accum_steps = max(1, cfg.accum_steps)
    remat = cfg.gradient_checkpointing
    n_data, r_data = axis_size(mesh, data_axis), axis_rank(mesh, data_axis)

    def loss_sum(state, micro):
        logits = sp_whisper_forward(
            state.model_params(), model_cfg, micro["mel"],
            micro["decoder_input_ids"], mesh, seq_axis=seq_axis,
            data_axis=data_axis, dtype=dtype, ring=ring, remat=remat)
        return seq2seq_loss_sum(logits.float(),
                                block_of(micro["labels"], n_data, r_data))

    def step(state, batch):
        b = batch["labels"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accum_steps={accum_steps}")
        # every leaf whole on every rank: the reduce sums the gradients,
        # the CE and the count over the batch axis ('data')
        lay = Layout(mesh, tree_map(lambda _: P(), state.trainable))
        grads, loss, _ = accumulate_grads(
            lambda micro: loss_sum(state, micro),
            tree_leaves(state.trainable), batch, accum_steps,
            reduce=lay.reduce)
        grads = tree_unflatten(state.trainable, grads)
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.trainable)
        apply_updates(state.trainable, updates)
        return (state.replace(step=state.step + 1, opt_state=opt_state),
                {"loss": loss})

    return step
