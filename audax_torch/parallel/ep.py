"""Expert parallelism: the GShard all_to_all dispatch (port of
``audax/parallel/ep.py``).

The complement of the dense-combine path (``CAUSAL_LM_TP_RULES`` shards the
expert axis, but every rank still computes every token x every LOCAL
expert -- E/k x the FLOPs):

  1. tokens are cut over the ``ep`` axis (M ranks, N/M contiguous tokens
     each);
  2. each rank routes its own tokens and builds token-granular
     dispatch/combine one-hots [N/M, E, C] via the rank-in-expert cumsum
     (capacity C = N/M is exact -- a rank can send an expert at most all
     of its tokens -- or ``capacity_factor`` bounds it, dropping overflow
     per rank as Switch/GShard do);
  3. ``all_to_all_single`` exchanges the dispatched [E, C, d] blocks so
     each rank holds [E/M, M*C, d] -- all tokens bound for ITS experts;
  4. the local SwiGLU expert FFN runs as [E/M]-batched matmuls;
  5. the reverse ``all_to_all_single`` returns expert outputs to the
     tokens' home ranks, where the combine einsum applies router weights.

Both exchanges are autograd functions whose backward is the reverse
exchange. The result is gathered over the axis, so every rank returns the
whole [B, T, d] (JAX returns the global array).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from audax_torch.models.causal_lm import CausalLMConfig, _moe_router, rms_norm
from audax_torch.parallel.comm import copy_over, gather_over
from audax_torch.parallel.mesh import axis_group, axis_rank, axis_size

__all__ = ["moe_expert_parallel"]


def _dispatch_masks(w: torch.Tensor, idx: torch.Tensor, num_experts: int,
                    capacity: int):
    """Token-granular dispatch/combine one-hots [Nl, E, C].

    ``pos`` ranks each (token, slot) selection within its expert in
    token-major order (the GShard position-in-expert cumsum); selections
    ranked past ``capacity`` are dropped (never at C = Nl)."""
    nl, k = idx.shape
    sel = F.one_hot(idx.reshape(-1), num_experts).float()       # [Nl*k, E]
    pos = (torch.cumsum(sel, dim=0) * sel).sum(-1) - 1.0        # [Nl*k]
    keep = (pos < capacity).float()
    # jax.nn.one_hot of an index past the last class is all zeros
    cap = F.one_hot(pos.long().clamp(0, capacity), capacity + 1)[
        :, :capacity].float()                                   # [Nl*k, C]
    both = (sel * keep[:, None])[:, :, None] * cap[:, None, :]
    both = both.reshape(nl, k, num_experts, capacity)
    dispatch = both.sum(1)                                      # [Nl, E, C]
    combine = torch.einsum("nkec,nk->nec", both, w.float())     # [Nl, E, C]
    return dispatch, combine


class _AllToAll(torch.autograd.Function):
    """[M, ...] blocks: block j goes to rank j, block i of the result came
    from rank i. Its own inverse, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # contiguous first: empty_like keeps a permuted gradient's strides,
    # which the collective would ignore
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_expert_parallel(layer, cfg: CausalLMConfig, x: torch.Tensor, mesh, *,
                        ep_axis: str = "model",
                        capacity_factor: float = 0.0,
                        dtype=torch.float32) -> torch.Tensor:
    """Sparse-MoE FFN block (pre-norm + routed SwiGLU experts, the same
    math as ``models/causal_lm.py:_moe_block``) with tokens cut over
    ``ep_axis`` and experts dispatched by all_to_all.

    x [B, T, d], the same on every rank; ``layer`` is one decoder layer's
    param dict (mlp_norm / router / experts) with the experts whole ([E,
    ...], this rank takes its E/M) or already this rank's block. B*T must
    divide by the axis size, num_experts too. ``capacity_factor`` 0 ->
    exact (C = local tokens); > 0 -> GShard-style C = ceil(cf * Nl * k /
    E) with overflow dropped. int4 experts raise."""
    b, t, d = x.shape
    n = b * t
    m = axis_size(mesh, ep_axis)
    if n % m:
        raise ValueError(f"tokens {n} not divisible by EP axis {m}")
    if cfg.num_experts % m:
        raise ValueError(f"experts {cfg.num_experts} not divisible by {m}")
    nl = n // m
    if capacity_factor > 0:
        cap = -(-int(capacity_factor * nl * cfg.experts_per_tok)
                // cfg.num_experts)
        cap = max(1, min(cap, nl))
    else:
        cap = nl
    group = axis_group(mesh, ep_axis)
    r = axis_rank(mesh, ep_axis)
    el = cfg.num_experts // m

    def ek(name):
        """This rank's expert weights in the activation dtype + optional
        int8 per-(expert, out-channel) scale [E/M, N]."""
        p = layer["experts"][name]
        if "kernel_q4" in p:
            raise ValueError(
                "int4 experts are the single-chip capacity tier (K9's "
                "packed layout is not cut over experts) -- use float or "
                "int8 experts for expert parallelism")
        key = "kernel_q" if "kernel_q" in p else "kernel"
        kern = p[key]
        mine = slice(r * el, (r + 1) * el) if kern.shape[0] == \
            cfg.num_experts else slice(None)
        sc = p["kernel_scale"][mine] if key == "kernel_q" else None
        return kern[mine], sc

    # each rank reads its block of the replicated x: its gradient, partial
    # on each rank, is summed over the axis (Megatron's f)
    xl = copy_over(x.to(dtype), group).reshape(n, d)[r * nl: (r + 1) * nl]
    h = rms_norm(layer["mlp_norm"], xl, cfg.rms_eps)
    w, idx, _ = _moe_router(layer, cfg, h)
    dispatch, combine = _dispatch_masks(w, idx, cfg.num_experts, cap)
    xd = torch.einsum("nd,nec->ecd", h.float(), dispatch).to(h.dtype)
    # exchange: each rank keeps its E/M experts' rows from everyone
    xe = _AllToAll.apply(xd.reshape(m, el, cap, d), group)   # [M, E/M, C, d]
    xe = xe.permute(1, 0, 2, 3).reshape(el, m * cap, d)      # [E/M, M*C, d]

    def scale(t_, s_):                                       # t_ [E/M, C', o]
        return t_ if s_ is None else t_ * s_[:, None, :].to(t_.dtype)

    gk, gsc = ek("gate")
    uk, usc = ek("up")
    dk, dsc = ek("down")
    g = scale(torch.einsum("ecd,edf->ecf", xe, gk.to(h.dtype)), gsc)
    u = scale(torch.einsum("ecd,edf->ecf", xe, uk.to(h.dtype)), usc)
    o = scale(torch.einsum("ecf,efd->ecd", F.silu(g) * u, dk.to(h.dtype)),
              dsc)
    # return expert outputs to the tokens' home ranks
    o = o.reshape(el, m, cap, d).permute(1, 0, 2, 3)         # [M, E/M, C, d]
    od = _AllToAll.apply(o.contiguous(), group).reshape(
        cfg.num_experts, cap, d)                             # [E, C, d]
    y = torch.einsum("ecd,nec->nd", od.float(), combine).to(xl.dtype)
    return gather_over(y, group, 0).reshape(b, t, d)
