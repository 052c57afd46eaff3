"""FSDP / ZeRO-3: parameters and optimizer state sharded over the data axis
(port of ``audax/parallel/fsdp.py``), and the ``Layout`` that trains a
tree laid out over a mesh.

Each parameter is sharded over 'data' on one extra dimension, on top of
any tensor-parallel split from the rule tables (``fsdp_specs``, JAX's spec
for spec). Parameters, gradients and both Adam moments live sharded
between steps. In the step a data-sharded leaf is all-gathered where it is
used (``parallel/comm.py:gather_for_use``, before the forward), and its
gradient comes back reduce-scattered: each rank keeps its shard of the sum
over the data ranks, so the optimizer update is local on the shard.

The moments keep their own parameter's layout. The JAX package assigns
them a spec by shape (the first parameter of each shape lends its spec), so
under TP a moment can take another leaf's layout there and XLA reshards it
in the update; the port's update stays local instead. Blockwise int8 first
moments match no parameter's shape: they stay whole on every rank, as in
JAX, and the update gathers a cut leaf's gradient for them
(``whole_leaf``, ``train/optim.py:scale_by_adam_lp``).

``Layout`` is what a step under a mesh needs of a trainable tree's specs:
its local blocks (``local``), the tree of whole-over-'data' tensors for the
forward (``use``), the gradient all-reduce over the batch axes for leaves
that are not data-sharded (``reduce_grads``), the clip's global norm across
shards (``norm``) and the whole tree back (``full``).
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from audax_torch.models.whisper import tree_leaves, tree_unflatten
from audax_torch.parallel.comm import (all_gather_cat, all_reduce_sum,
                                       gather_for_use)
from audax_torch.parallel.mesh import (P, axis_group, axis_size, batch_axes,
                                       batch_group, batch_size)
from audax_torch.parallel.sharding import (ATTENTION_LEAVES,
                                           WHISPER_TP_RULES, _in_int4,
                                           _int4_dense_prefixes, _zip_map,
                                           local_slice, map_with_path,
                                           shard_params, spec_for_path,
                                           tp_specs)

__all__ = ["fsdp_specs", "shard_params_fsdp", "fsdp_shard_state",
           "shard_state", "Layout"]


def _valid(spec: P, shape, mesh) -> P:
    """Replicate params whose sharded dims don't divide the mesh axis
    (same fallback rule as sharding.shard_params); drop trivial (size-1)
    or ABSENT mesh axes so they don't block the FSDP dim."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        size = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            size *= axis_size(mesh, a)
        if size == 1:
            out.append(None)
            continue
        if shape[dim] % size != 0:
            return P()
        out.append(axis)
    return P(*out)


def _add_fsdp_dim(spec: P, shape, mesh, axis: str, min_size: int) -> P:
    """Extend a (possibly TP-) spec with the FSDP axis on the largest
    still-unsharded, divisible dimension. Small tensors stay replicated --
    gathering a bias costs more in collective latency than its bytes."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return spec
    if math.prod(shape) < min_size:
        return spec
    ext = tuple(spec) + (None,) * (len(shape) - len(spec))
    cands = [d for d in range(len(shape))
             if ext[d] is None and shape[d] % n == 0 and shape[d] >= n]
    if not cands:
        return spec
    best = max(cands, key=lambda d: shape[d])
    return P(*(axis if d == best else ext[d] for d in range(len(shape))))


def fsdp_specs(params: Any, mesh, *,
               rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES,
               axis: str = "data", min_size: int = 1 << 12,
               heads: Optional[int] = None) -> Any:
    """Tree of partition specs: TP rules first (with the divisibility
    fallback, and ``heads`` as ``sharding.tp_specs`` takes them), then the
    FSDP ``axis`` on each tensor's largest free dim. int4-packed dense
    dicts stay replicated as a unit."""
    int4 = _int4_dense_prefixes(params)
    whole_attn = heads is not None and heads % axis_size(mesh, "model")

    def one(s, leaf):
        if _in_int4(s, int4):
            return P()
        spec = _valid(spec_for_path(s, rules, leaf.dim()), leaf.shape, mesh)
        if whole_attn and re.search(ATTENTION_LEAVES, s):
            spec = P()
        return _add_fsdp_dim(spec, tuple(leaf.shape), mesh, axis, min_size)

    return map_with_path(one, params)


def shard_params_fsdp(params: Any, mesh, *,
                      rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES,
                      axis: str = "data", min_size: int = 1 << 12,
                      heads: Optional[int] = None) -> Any:
    """This rank's local tree in the ZeRO-3 layout (TP rules + FSDP
    axis)."""
    specs = fsdp_specs(params, mesh, rules=rules, axis=axis,
                       min_size=min_size, heads=heads)
    return Layout(mesh, specs, axis).local(params)


def shard_state(state, mesh, *, fsdp: bool = False,
                rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES,
                axis: str = "data", min_size: int = 1 << 12,
                heads: Optional[int] = None):
    """A train state (``train/seq2seq.py:FTState``, ``train/lm.py:LMState``
    or ``train/steps.py:TrainState``) whose trees are whole on every rank,
    moved onto ``mesh``: the trainable leaves and each Adam moment cut to
    this rank's block (TP rules; with ``fsdp`` also the data axis; moments
    in their parameter's layout, module docstring) and the state's
    ``layout`` set. A LoRA state's adapters take no TP rule (they stay
    whole over 'model' and their delta is cut where it is applied,
    ``models/lora.py:apply_lora``) and its frozen base is cut by the rules.
    Optimizer leaves that are not per-parameter trees (the count) stay as
    they are. ``heads``: the model's attention heads (``sharding.
    tp_specs``)."""
    name = "trainable" if hasattr(state, "trainable") else "params"
    tree = getattr(state, name)
    lora = getattr(state, "use_lora", False)
    trules = () if lora else rules
    specs = (fsdp_specs(tree, mesh, rules=trules, axis=axis,
                        min_size=min_size, heads=heads) if fsdp
             else tp_specs(tree, mesh, trules, heads=heads))
    lay = Layout(mesh, specs, axis)
    changes = {name: lay.local(tree, grad=True),
               "opt_state": lay.local_opt_state(state.opt_state),
               "layout": lay}
    if lora:
        changes["base_params"] = shard_params(state.base_params, mesh, rules,
                                              heads=heads)
        changes["base_layout"] = Layout(
            mesh, tp_specs(state.base_params, mesh, rules, heads=heads), axis)
    return state.replace(**changes)


def fsdp_shard_state(state, mesh, *,
                     rules: Sequence[Tuple[str, P]] = WHISPER_TP_RULES,
                     axis: str = "data", min_size: int = 1 << 12,
                     heads: Optional[int] = None):
    """``shard_state`` into the ZeRO-3 layout (TP rules + FSDP axis)."""
    return shard_state(state, mesh, fsdp=True, rules=rules, axis=axis,
                       min_size=min_size, heads=heads)


class Layout:
    """A trainable tree's layout over ``mesh``: ``specs`` (a tree of
    partition specs matching it) name the axes each leaf is cut over;
    ``fsdp_axis`` is the axis gathered at use."""

    def __init__(self, mesh, specs: Any, fsdp_axis: str = "data"):
        self.mesh = mesh
        self.specs = specs
        self.fsdp_axis = fsdp_axis
        self.spec_list: List[P] = _spec_leaves(specs)

    # ---------------------------------------------------------- layout --
    def local(self, tree: Any, grad: bool = False) -> Any:
        """This rank's blocks of a whole tree (copies; ``grad`` makes them
        leaves that require grad)."""
        def one(spec, leaf):
            t = local_slice(leaf.detach(), spec, self.mesh).clone()
            return t.requires_grad_(True) if grad else t
        return _zip_map(one, self.specs, tree)

    def local_opt_state(self, opt_state):
        """``train/optim.py:ScaleByAdamLPState`` with each moment tree cut
        like the trainable tree. Blockwise int8 first moments are laid out
        over the flattened whole leaf: they stay whole (module
        docstring)."""
        mu, nu = opt_state.mu, opt_state.nu
        if not _is_q8(mu):
            mu = self.local(mu)
        return opt_state._replace(mu=mu, nu=self.local(nu))

    def _cut(self, spec: P):
        return [(d, a) for d, a in enumerate(spec)
                if a is not None and axis_size(self.mesh, a) > 1]

    def is_cut(self, i: int) -> bool:
        """Whether leaf ``i`` (in ``tree_leaves`` order) is cut over an
        axis of more than one rank."""
        return bool(self._cut(self.spec_list[i]))

    def whole_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s blocks ``t`` all-gathered whole over every axis it
        is cut over (no autograd)."""
        for d, a in self._cut(self.spec_list[i]):
            t = all_gather_cat(t, axis_group(self.mesh, a), d)
        return t

    def block_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor shaped like leaf ``i``."""
        return local_slice(t, self.spec_list[i], self.mesh)

    def _fsdp_dim(self, spec: P):
        for d, a in enumerate(spec):
            if a == self.fsdp_axis and axis_size(self.mesh, a) > 1:
                return d
        return None

    def use(self, tree: Any) -> Any:
        """The tree the forward reads: each data-sharded leaf all-gathered
        over the FSDP axis (backward: reduce-scatter), TP blocks left as
        they are."""
        out = []
        for leaf, spec in zip(tree_leaves(tree), self.spec_list):
            d = self._fsdp_dim(spec)
            out.append(leaf if d is None else gather_for_use(
                leaf, axis_group(self.mesh, self.fsdp_axis), d))
        return tree_unflatten(tree, out)

    # ------------------------------------------------------- gradients --
    def reduce_grads(self, grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Each gradient summed over the batch axes its leaf is not
        sharded over (the data-sharded ones arrive reduce-scattered)."""
        axes = [a for a in batch_axes(self.mesh)
                if axis_size(self.mesh, a) > 1]
        if not axes:
            return list(grads)
        out = []
        for g, spec in zip(grads, self.spec_list):
            missing = [a for a in axes if a not in spec]
            if len(missing) == len(axes):
                g = all_reduce_sum(g, batch_group(self.mesh)) \
                    if len(axes) > 1 else all_reduce_sum(
                        g, axis_group(self.mesh, axes[0]))
            else:
                for a in missing:
                    g = all_reduce_sum(g, axis_group(self.mesh, a))
            out.append(g)
        return out

    def reduce(self, grads, loss_sum, count):
        """``reduce_grads``, and the summed loss and token count summed
        over the batch axes (``train/seq2seq.py:accumulate_grads``)."""
        grads = self.reduce_grads(grads)
        if batch_size(self.mesh) > 1:
            both = all_reduce_sum(torch.stack([
                torch.as_tensor(loss_sum, dtype=torch.float32,
                                device=grads[0].device),
                torch.as_tensor(count, dtype=torch.float32,
                                device=grads[0].device)]),
                batch_group(self.mesh))
            loss_sum, count = both[0], both[1]
        return grads, loss_sum, count

    def _replicas(self, spec: P) -> int:
        world = dist.get_world_size()
        shards = math.prod(axis_size(self.mesh, a) for a in spec
                           if a is not None)
        return world // shards

    def norm(self, grads: Any) -> torch.Tensor:
        """The global norm of the whole gradient tree: each leaf's local
        square sum over its replica count, summed over the world (every
        element counted once)."""
        parts = [torch.sum(g.float() * g.float()) / self._replicas(s)
                 for g, s in zip(tree_leaves(grads), self.spec_list)]
        total = all_reduce_sum(torch.stack(parts).sum(), None)
        return torch.sqrt(total)

    # ----------------------------------------------------------- whole --
    @torch.no_grad()
    def full(self, tree: Any) -> Any:
        """The whole tree on every rank: each leaf's blocks all-gathered
        over every axis it is cut over."""
        def one(spec, leaf):
            t = leaf.detach()
            for d, a in self._cut(spec):
                t = all_gather_cat(t, axis_group(self.mesh, a), d)
            return t
        return _zip_map(one, self.specs, tree)


def _spec_leaves(specs: Any) -> List[P]:
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [specs]


def _is_q8(mu) -> bool:
    """Whether a first-moment tree is the int8 one, ``{"q", "s"}``."""
    if not (isinstance(mu, dict) and set(mu) == {"q", "s"}):
        return False
    leaves = tree_leaves(mu["q"])
    return bool(leaves) and leaves[0].dtype == torch.int8
