"""The collectives of the Megatron/ZeRO layout, written where GSPMD inserts
them for the JAX package.

Tensor parallelism (Megatron-LM, Shoeybi et al. 2019) needs two conjugate
operators around every column-parallel -> row-parallel pair:

  ``copy_to_model`` (f): identity forward, all-reduce over 'model' backward
      -- at the input of a column-parallel projection, whose input gradient
      is a partial sum on each rank;
  ``reduce_from_model`` (g): all-reduce over 'model' forward, identity
      backward -- at the output of a row-parallel projection.

``torch.distributed.nn.functional.all_reduce`` is neither: its backward
all-reduces again, which would scale every gradient below a row-parallel
output by the model-axis size. ``gather_from_model`` all-gathers a
vocab-sharded logit tensor (backward: this rank's slice), and
``vocab_embed``/``vocab_logits`` are the vocab-parallel token embedding.

FSDP (ZeRO-3) gathers a data-sharded leaf where it is used:
``gather_for_use`` all-gathers over 'data' forward and reduce-scatters the
gradient backward, so each rank keeps only its shard of the summed
gradient.

Every operator reads the current mesh (``parallel/mesh.py:use_mesh``) and
is the identity outside one, or when its axis has size 1.

``ring_shift`` is JAX's ``ppermute`` on a ring (sequence parallelism's K/V
blocks) or a chain (pipeline parallelism's stages). It is one
``all_to_all_single`` in which only the neighbour's split is non-empty, on
every backend: gloo does not carry ``send``/``recv``/``batch_isend_irecv``
on CUDA tensors (it hands the device pointer to its TCP transport, which
aborts with "Bad address"), and carries ``all_to_all_single`` on them; NCCL
runs the same call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from audax_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                       current_mesh)

__all__ = ["model_size", "model_rank", "copy_to_model", "reduce_from_model",
           "gather_from_model", "gather_over", "copy_over", "sum_over",
           "all_reduce_sum", "all_gather_cat",
           "gather_for_use", "vocab_embed", "vocab_logits", "tp_active",
           "local_block", "ring_shift", "reduce_over"]


def _axis(name: str):
    mesh = current_mesh()
    if mesh is None or axis_size(mesh, name) == 1:
        return None
    return mesh


def model_size() -> int:
    mesh = current_mesh()
    return 1 if mesh is None else axis_size(mesh, "model")


def model_rank() -> int:
    mesh = current_mesh()
    return 0 if mesh is None else axis_rank(mesh, "model")


def tp_active(local: int, full: int, what: str) -> bool:
    """Whether a width ``local`` (a projection's local output) is a model
    shard of ``full``; raises when it is one but no mesh is current."""
    if local == full:
        return False
    if local * model_size() != full:
        raise ValueError(f"{what}: local width {local} of {full} does not "
                         f"match the current mesh's model axis "
                         f"({model_size()}); run TP-sharded parameters "
                         "inside parallel/mesh.py:use_mesh(mesh)")
    return True


def local_block(full: int) -> slice:
    """This rank's contiguous block of ``full`` over 'model'."""
    n = full // model_size()
    r = model_rank()
    return slice(r * n, (r + 1) * n)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group`` (no autograd)."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in rank
    order (no autograd)."""
    n = dist.get_world_size(group)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group`` and split along ``dim``: this rank's
    block (no autograd)."""
    n = dist.get_world_size(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank = dist.get_rank(group)
        ctx.n = dist.get_world_size(group)
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _GatherForUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced over 'model'."""
    mesh = _axis("model")
    if mesh is None:
        return x
    return _CopyToModel.apply(x, axis_group(mesh, "model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: summed over 'model' forward, identity backward."""
    mesh = _axis("model")
    if mesh is None:
        return x
    return _ReduceFromModel.apply(x, axis_group(mesh, "model"))


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model shards of ``x`` concatenated along ``dim`` (backward:
    this rank's slice of the gradient, which every rank holds whole)."""
    mesh = _axis("model")
    if mesh is None:
        return x
    return _GatherFromModel.apply(x, axis_group(mesh, "model"),
                                  dim % x.dim())


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, for a statistic every rank's loss reads
    (synchronised BatchNorm, the load-balancing loss): the backward sums
    the ranks' gradients too."""
    return _SumOver.apply(x, group)


def copy_over(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over any ``group``: identity forward, the gradient
    (partial where each rank reads its part of ``x``) all-reduced."""
    return _CopyToModel.apply(x, group)


def reduce_over(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over any ``group``: summed forward, identity backward
    -- for a result every rank then reads alike (pipeline outputs that
    only the last stage fills)."""
    return _ReduceFromModel.apply(x, group)


def gather_over(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The shards of ``x`` over ``group`` concatenated along ``dim``, for a
    result every rank then uses alike (backward: this rank's slice)."""
    return _GatherFromModel.apply(x, group, dim % x.dim())


def gather_for_use(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """FSDP's gather at use: ``x``'s shards over ``group`` concatenated
    along ``dim``; the backward reduce-scatters the gradient (summing the
    ranks' batch contributions, each keeping its shard)."""
    return _GatherForUse.apply(x, group, dim)


def _shift(x: torch.Tensor, group, step: int, wrap: bool) -> torch.Tensor:
    """Rank r's ``x`` sent to rank r + ``step`` of ``group`` (no
    autograd): what this rank receives from r - ``step``. Without ``wrap``
    a rank past either end sends nothing and one that has no sender
    receives zeros."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone() if wrap else torch.zeros_like(x)
    r = dist.get_rank(group)
    dst, src = r + step, r - step
    send = wrap or 0 <= dst < n
    recv = wrap or 0 <= src < n
    flat = x.detach().contiguous().reshape(-1)
    m = flat.numel()
    ins, outs = [0] * n, [0] * n
    if send:
        ins[dst % n] = m
    if recv:
        outs[src % n] = m
    out = flat.new_empty(m if recv else 0)
    dist.all_to_all_single(out, flat if send else flat[:0],
                           output_split_sizes=outs, input_split_sizes=ins,
                           group=group)
    return out.view(x.shape) if recv else torch.zeros_like(x)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, wrap):
        ctx.group, ctx.wrap = group, wrap
        return _shift(x, group, 1, wrap)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1, ctx.wrap), None, None


def ring_shift(x: torch.Tensor, group, *, wrap: bool) -> torch.Tensor:
    """JAX's ``ppermute``: rank i's ``x`` goes to rank i + 1 of ``group``
    and this rank returns what rank i - 1 sent. ``wrap=True`` closes the
    ring (sequence parallelism's ``[(i, (i + 1) % n)]``); ``wrap=False`` is
    the chain ``[(i, i + 1)]``, where the last rank sends nothing and the
    first receives zeros. The backward shifts the gradient the other way.
    Every rank of ``group`` must call it, the same number of times."""
    return _RingShift.apply(x, group, wrap)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab: int) -> Optional[torch.Tensor]:
    """The vocab-parallel token embedding: when ``table`` holds this rank's
    block of ``vocab`` rows, a masked local lookup summed over 'model'
    (exact: one rank contributes each row, the others zeros). None when
    the table is whole."""
    rows = table.shape[0]
    if not tp_active(rows, vocab, "token embedding"):
        return None
    start = model_rank() * rows
    local = tokens.long() - start
    hit = (local >= 0) & (local < rows)
    emb = table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
    return reduce_from_model(emb)


def vocab_logits(table: torch.Tensor, x: torch.Tensor,
                 vocab: int) -> Optional[torch.Tensor]:
    """Tied logits against a vocab-sharded ``table`` [V/tp, d]: this
    rank's columns, all-gathered over 'model' into [..., V]. None when
    the table is whole."""
    if not tp_active(table.shape[0], vocab, "tied logits"):
        return None
    y = copy_to_model(x) @ table.to(x.dtype).t()
    return gather_from_model(y, dim=-1)
