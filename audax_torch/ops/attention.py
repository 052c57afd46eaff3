"""Attention: the CUDA kernels K2 (flash forward), K7/K8 (flash backward)
and K3 (stacked decode attention) with their plain PyTorch versions.

Port of ``audax/ops/attention.py``:

  * ``flash_forward`` -- the forward of ``flash_attention`` (TPU kernel
    ``_fwd_kernel``): online-softmax attention writing O and the logsumexp,
    with grouped-query heads (kv head = q head // group), a ragged Tk and an
    optional causal mask (Tq == Tk). Its plain version mirrors the JAX
    package's ``xla_attention``.
  * ``flash_backward`` -- the gradients of ``flash_attention`` (TPU kernels
    ``_dq_kernel`` and ``_dkv_kernel`` of ``_bwd_pallas``): P is recomputed
    from the saved logsumexp, delta = rowsum(dO * O) is a plain float32 pass
    (the JAX package leaves it to XLA), and a kv head's gradient sums its
    whole q-head group. ``flash_attention`` is a ``torch.autograd.Function``
    whose forward is K2 and whose backward is K7 + K8.
  * ``xla_attention`` (the materialised twin, any mask), ``flash_applicable``
    and ``dot_product_attention``, which takes the flash path wherever
    ``flash_applicable`` holds -- the rule the TPU path follows -- and the
    twin otherwise. Whisper's attention sites all go through it.
  * ``decode_attention_stacked`` -- small-Tq attention over the
    layer-stacked ``[L, B, Hkv, S, D]`` KV cache (TPU kernel
    ``_dec_kernel_stacked``), the layer picked by index inside the kernel,
    keys masked per slot by ``pos``. Whisper's decoder runs it twice per
    layer per token (self- and cross-attention). The cache is float (K3)
    or int8 with per-vector float32 scales (``QuantKV``, K3's int8 arm,
    counted on its own). Its plain version mirrors ``_decode_attention_xla``.
  * ``decode_attention`` -- the same for one unstacked ``[B, Hkv, S, D]``
    cache (TPU kernel ``_dec_kernel``, K6): K3's kernel launched with L = 1.

Each kernel function dispatches on the tensor it is given: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises. Head
folding (``fold``) was a TPU VMEM device and is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from audax_torch.ops import native

__all__ = ["flash_forward", "flash_forward_cuda", "flash_forward_plain",
           "flash_backward", "flash_backward_plain", "flash_backward_dq_plain",
           "flash_backward_dkv_plain", "flash_backward_dq_cuda",
           "flash_backward_dkv_cuda", "flash_attention", "FlashAttention",
           "xla_attention", "flash_applicable", "dot_product_attention",
           "decode_attention_stacked", "decode_attention_stacked_cuda",
           "decode_attention_stacked_plain",
           "decode_attention_stacked_int8_cuda",
           "decode_attention_stacked_int8_plain", "decode_attention",
           "decode_attention_cuda", "decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_DECODE_ROWS = 16
#: dynamic shared memory one block may use on an H100 (227 KB)
_SMEM_LIMIT = 232448

Pos = Union[None, int, torch.Tensor]


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale if scale is not None else q.shape[-1] ** -0.5)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev, dt = ts[0].device, ts[0].dtype
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {t.device}")
        if t.dtype != dt or dt not in _DTYPES:
            raise ValueError(f"{name}: operands must share one dtype of "
                             f"{list(_DTYPES)}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


# ------------------------------------------------------------------ flash --

def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised attention (the JAX ``xla_attention`` math): softmax in
    float32, probabilities cast to q's dtype before PV. Returns
    ``(o [B, Hq, Tq, D], lse [B*Hq, Tq] float32)``."""
    flash_forward_plain.launches += 1
    b, hq, tq, _ = q.shape
    group = hq // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * _scale(q, scale), k)
    if causal:
        tk = s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    s32 = s.float()
    p = torch.softmax(s32, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, torch.logsumexp(s32, dim=-1).reshape(b * hq, tq)


flash_forward_plain.launches = 0


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (``csrc/flash_fwd.cu``); same contract as
    ``flash_forward_plain``."""
    _check_cuda("flash_forward", q, k, v)
    b, hq, tq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_forward: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if causal and tq != tk:
        raise ValueError("causal flash attention requires Tq == Tk")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_forward: head_dim {d} not in {_HEAD_DIMS}")
    o = torch.empty_like(q)
    lse = torch.empty(b * hq, tq, device=q.device, dtype=torch.float32)
    if tq == 0:
        return o, lse
    lib = native.library("flash_fwd")
    status = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, tq, tk, d, _scale(q, scale), int(causal),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "flash_forward")
    flash_forward_cuda.launches += 1
    return o, lse


flash_forward_cuda.launches = 0


def flash_forward(q, k, v, *, causal=False, scale=None):
    """``(o, lse)``: the CUDA kernel for CUDA tensors, else the plain version."""
    fn = flash_forward_cuda if q.is_cuda else flash_forward_plain
    return fn(q, k, v, causal=causal, scale=scale)


def _probs_plain(q, k, lse, causal, scale):
    """P = exp(scale * q k^T - lse) recomputed from the saved logsumexp, as
    the kernels do, in float32 (keys repeated over the q-head group).
    Returns (P [B, Hq, Tq, Tk], k repeated)."""
    b, hq, tq, _ = q.shape
    group = hq // k.shape[1]
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    p = torch.exp(s - lse.reshape(b, hq, tq, 1))
    if causal:
        tk = s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~keep, 0.0)
    return p, kr


def _dp_ds_plain(q, k, v, o, lse, do, causal, scale):
    p, kr = _probs_plain(q, k, lse, causal, scale)
    group = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vr.float())
    return p, p * (dp - delta) * scale, kr


def _fold_group(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, T, D] -> [B, Hkv, T, D], summing each kv head's q heads."""
    b, hq, t, d = x.shape
    return x.reshape(b, hkv, hq // hkv, t, d).sum(2)


def flash_backward_dq_plain(q, k, v, o, lse, do, *, causal=False,
                            scale=None) -> torch.Tensor:
    """dQ = dS K with dS = P * (dO V^T - rowsum(dO * O)) * scale, dS cast
    to K's dtype before the product (the TPU ``_dq_kernel`` math)."""
    flash_backward_dq_plain.launches += 1
    _, ds, kr = _dp_ds_plain(q, k, v, o, lse, do, causal, _scale(q, scale))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kr.float())
    return dq.to(q.dtype)


flash_backward_dq_plain.launches = 0


def flash_backward_dkv_plain(q, k, v, o, lse, do, *, causal=False,
                             scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = dS^T Q (dS cast to Q's dtype) and dV = P^T dO (P cast to dO's
    dtype), each kv head summing its q-head group (the ``_dkv_kernel``
    math)."""
    flash_backward_dkv_plain.launches += 1
    p, ds, _ = _dp_ds_plain(q, k, v, o, lse, do, causal, _scale(q, scale))
    hkv = k.shape[1]
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    return (_fold_group(dk, hkv).to(k.dtype),
            _fold_group(dv, hkv).to(v.dtype))


flash_backward_dkv_plain.launches = 0


def flash_backward_plain(q, k, v, o, lse, do, *, causal=False, scale=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention from the forward's ``o`` and
    ``lse [B*Hq, Tq]`` and the output gradient ``do``, recomputing P from
    the logsumexp as the kernels do."""
    dq = flash_backward_dq_plain(q, k, v, o, lse, do, causal=causal,
                                 scale=scale)
    dk, dv = flash_backward_dkv_plain(q, k, v, o, lse, do, causal=causal,
                                      scale=scale)
    return dq, dk, dv


def _check_backward(q, k, v, o, lse, do, causal):
    _check_cuda("flash_backward", q, k, v, o, do)
    b, hq, tq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_backward: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_backward: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (b * hq, tq) or not lse.is_contiguous()):
        raise ValueError(f"flash_backward: lse must be a contiguous float32 "
                         f"[{b * hq}, {tq}] on {q.device}")
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if causal and tq != tk:
        raise ValueError("causal flash attention requires Tq == Tk")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_backward: head_dim {d} not in {_HEAD_DIMS}")


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in float32, [B*Hq, Tq]."""
    b, hq, tq, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * hq, tq).contiguous()


def flash_backward_dq_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                           delta: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Kernel K7 (``csrc/flash_bwd.cu``); same contract as
    ``flash_backward_dq_plain``. ``delta`` may be passed precomputed."""
    _check_backward(q, k, v, o, lse, do, causal)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tk == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    if tq == 0:
        return dq
    delta = _delta(o, do) if delta is None else delta
    status = native.library("flash_bwd").flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, hq, hkv, tq, tk,
        d, _scale(q, scale), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "flash_backward_dq")
    flash_backward_dq_cuda.launches += 1
    return dq


flash_backward_dq_cuda.launches = 0


def flash_backward_dkv_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                            delta: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K8 (``csrc/flash_bwd.cu``); same contract as
    ``flash_backward_dkv_plain``. ``delta`` may be passed precomputed."""
    _check_backward(q, k, v, o, lse, do, causal)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if tq == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if tk == 0:
        return dk, dv
    delta = _delta(o, do) if delta is None else delta
    status = native.library("flash_bwd").flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq,
        hkv, tq, tk, d, _scale(q, scale), int(causal), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "flash_backward_dkv")
    flash_backward_dkv_cuda.launches += 1
    return dk, dv


flash_backward_dkv_cuda.launches = 0


def flash_backward(q, k, v, o, lse, do, *, causal=False, scale=None):
    """``(dq, dk, dv)``: kernels K7 and K8 for CUDA tensors (one delta pass
    shared by both), else the plain version."""
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                    scale=scale)
    delta = _delta(o, do)
    dq = flash_backward_dq_cuda(q, k, v, o, lse, do, causal=causal,
                                scale=scale, delta=delta)
    dk, dv = flash_backward_dkv_cuda(q, k, v, o, lse, do, causal=causal,
                                     scale=scale, delta=delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward K2, backward K7 + K8 (their
    plain versions on CPU tensors). Saves q, k, v, o and the logsumexp;
    nothing O(Tq * Tk) is kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention output. q [B, Hq, Tq, D]; k/v [B, Hkv, Tk, D] with
    Hq % Hkv == 0. Causal requires Tq == Tk. Differentiable: the backward
    runs the flash backward kernels."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention requires Tq == Tk")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of Hkv={k.shape[1]}")
    return FlashAttention.apply(q, k, v, causal, _scale(q, scale))


# ----------------------------------------------------------- twin / dispatch --

def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The materialised twin (the JAX ``xla_attention`` math): softmax in
    float32, probabilities cast to q's dtype before PV; GQA, an end-aligned
    causal mask and any boolean ``mask`` broadcastable to [B, H, Tq, Tk].
    Differentiable through autograd."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * _scale(q, scale), k)
    if causal:
        tq, tk = s.shape[-2:]
        cm = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        mask = cm if mask is None else mask & cm
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_applicable(q_shape, k_shape, mask, causal: bool = False) -> bool:
    """Flash path: no arbitrary mask, head dims equal, q heads a multiple of
    kv heads, at least 16 rows and 16 keys, and for causal a square
    Tq == Tk (the JAX package's rule)."""
    return (mask is None and q_shape[-1] == k_shape[-1]
            and q_shape[1] % k_shape[1] == 0 and q_shape[2] >= 16
            and k_shape[2] >= 16
            and (not causal or q_shape[2] == k_shape[2]))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention (K2 forward, K7/K8 backward on CUDA) wherever
    ``flash_applicable`` holds, the materialised twin otherwise."""
    if flash_applicable(q.shape, k.shape, mask, causal):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return xla_attention(q, k, v, causal=causal, mask=mask, scale=scale)


# ----------------------------------------------------------------- decode --

def _split_kv(kv: Sequence[torch.Tensor]):
    """(k, k_scale, v, v_scale): the scales are None for a float pair."""
    if len(kv) == 4:
        return tuple(kv)
    k, v = kv
    return k, None, v, None


def _decode_plain(q, k, ks, v, vs, pos, scale):
    """The JAX ``_decode_attention_xla`` math on one layer's cache [B, Hkv,
    S, D]: query row i sees keys <= pos + i (``pos`` scalar or per-slot
    [B]; None = all keys), softmax in float32, probabilities cast to q's
    dtype before PV. Int8 K/V (``ks``/``vs`` [B, Hkv, S] given) scale the
    scores by k_scale over the key axis and the probabilities by v_scale."""
    dt = q.dtype
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        if ks is not None:
            ks = ks.repeat_interleave(group, dim=1)
            vs = vs.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * _scale(q, scale), k.to(dt))
    if ks is not None:
        s = s * ks[:, :, None, :].to(dt)
    if pos is not None:
        tq, s_len = s.shape[-2:]
        cols = torch.arange(s_len, device=q.device)[None, :]
        rows = torch.arange(tq, device=q.device)[:, None]
        pos_b = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
        if pos_b.dim() == 0:
            mask = (cols <= pos_b + rows)[None, None]
        else:                   # per-slot decode depths
            mask = (cols[None] <= pos_b[:, None, None] + rows[None])[:, None]
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(dt)
    if vs is not None:
        p = p * vs[:, :, None, :].to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(dt))


def decode_attention_stacked_plain(q: torch.Tensor, kv, layer: int, *,
                                   pos: Pos = None,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """Plain version of K3 on the selected layer (float pair; an int8
    4-tuple takes ``decode_attention_stacked_int8_plain``)."""
    if len(kv) == 4:
        return decode_attention_stacked_int8_plain(q, kv, layer, pos=pos,
                                                   scale=scale)
    decode_attention_stacked_plain.launches += 1
    k, v = kv
    return _decode_plain(q, k[layer], None, v[layer], None, pos, scale)


decode_attention_stacked_plain.launches = 0


def decode_attention_stacked_int8_plain(q: torch.Tensor, kv, layer: int, *,
                                        pos: Pos = None,
                                        scale: Optional[float] = None
                                        ) -> torch.Tensor:
    """Plain version of K3's int8 arm: ``kv`` = (k_q, k_scale, v_q,
    v_scale) with int8 [L, B, Hkv, S, D] codes and float32 [L, B, Hkv, S]
    scales."""
    decode_attention_stacked_int8_plain.launches += 1
    k, ks, v, vs = kv
    return _decode_plain(q, k[layer], ks[layer], v[layer], vs[layer], pos,
                         scale)


decode_attention_stacked_int8_plain.launches = 0


def _pos_vector(pos: Pos, b: int, s_len: int, device) -> torch.Tensor:
    if pos is None:
        pos = s_len
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape[0] != b:
            raise ValueError(f"pos has {pos.shape[0]} entries for batch {b}")
        return pos.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _launch_decode(name: str, q, k, ks, v, vs, layer: int, pos: Pos,
                   scale) -> torch.Tensor:
    """Launch the K3 kernel (float or int8 arm) on ``layer`` of the stacked
    cache k, v [L, B, Hkv, S, D] (int8 with float32 [L, B, Hkv, S] scales
    ``ks``/``vs``, or None)."""
    quant = ks is not None
    if quant:
        _check_cuda(name, q)
        for t, dt in ((k, torch.int8), (v, torch.int8), (ks, torch.float32),
                      (vs, torch.float32)):
            if t.device != q.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"{name}: int8 K/V and float32 scales must "
                                 f"be contiguous on {q.device}, got "
                                 f"{t.dtype} on {t.device}")
    else:
        _check_cuda(name, q, k, v)
    b, h, tq, d = q.shape
    if k.dim() != 5 or k.shape != v.shape or k.shape[1] != b or k.shape[4] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"cache {tuple(k.shape)}")
    n_layers, _, hkv, s_len, _ = k.shape
    if quant and (ks.shape != k.shape[:4] or vs.shape != k.shape[:4]):
        raise ValueError(f"{name}: scales {tuple(ks.shape)} do not match the "
                         f"cache {tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if not 0 <= int(layer) < n_layers:
        raise IndexError(f"layer {layer} outside a {n_layers}-layer cache")
    if not 1 <= tq <= _MAX_DECODE_ROWS or d not in _HEAD_DIMS:
        raise ValueError(f"{name}: Tq={tq} (1..16) and head_dim={d} "
                         f"{_HEAD_DIMS} not supported")
    lib = native.library("decode_attention")
    if lib.decode_smem(d, tq, s_len) > _SMEM_LIMIT:
        raise ValueError(f"{name}: Tq*S={tq * s_len} scores exceed one "
                         "block's shared memory")
    pos_v = _pos_vector(pos, b, s_len, q.device)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if quant:
        status = lib.decode_attention_stacked_q8(
            q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(),
            vs.data_ptr(), o.data_ptr(), pos_v.data_ptr(), int(layer), b, h,
            hkv, tq, s_len, d, _scale(q, scale), _DTYPES[q.dtype], stream)
    else:
        status = lib.decode_attention_stacked(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos_v.data_ptr(), int(layer), b, h, hkv, tq, s_len, d,
            _scale(q, scale), _DTYPES[q.dtype], stream)
    native.check(status, name)
    return o


def decode_attention_stacked_cuda(q: torch.Tensor, kv, layer: int, *,
                                  pos: Pos = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Kernel K3 (``csrc/decode_attention.cu``), float K/V; same contract
    as ``decode_attention_stacked_plain``. An int8 4-tuple takes
    ``decode_attention_stacked_int8_cuda``."""
    if len(kv) == 4:
        return decode_attention_stacked_int8_cuda(q, kv, layer, pos=pos,
                                                  scale=scale)
    k, v = kv
    o = _launch_decode("decode_attention_stacked", q, k, None, v, None,
                       layer, pos, scale)
    decode_attention_stacked_cuda.launches += 1
    return o


decode_attention_stacked_cuda.launches = 0


def decode_attention_stacked_int8_cuda(q: torch.Tensor, kv, layer: int, *,
                                       pos: Pos = None,
                                       scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """K3's int8 arm (``decode_attention_stacked_q8`` of
    ``csrc/decode_attention.cu``); same contract as
    ``decode_attention_stacked_int8_plain``."""
    k, ks, v, vs = kv
    o = _launch_decode("decode_attention_stacked_int8", q, k, ks, v, vs,
                       layer, pos, scale)
    decode_attention_stacked_int8_cuda.launches += 1
    return o


decode_attention_stacked_int8_cuda.launches = 0


def decode_attention_stacked(q: torch.Tensor, kv, layer: int, *,
                             pos: Pos = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention against the layer-stacked cache. q [B, H, Tq, D];
    ``kv`` the float pair (k, v) [L, B, Hkv, S, D] or the int8 4-tuple
    (k_q, k_scale, v_q, v_scale) with [L, B, Hkv, S] scales (``QuantKV``);
    ``layer`` picks the layer; ``pos`` a scalar, a per-slot [B] vector, or
    None (every key -- cross-attention). The CUDA kernel for CUDA tensors,
    else the plain version."""
    fn = (decode_attention_stacked_cuda if q.is_cuda
          else decode_attention_stacked_plain)
    return fn(q, kv, layer, pos=pos, scale=scale)


# ------------------------------------------------------- one-layer decode --

def decode_attention_plain(q: torch.Tensor, kv, *, pos: Pos = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K6: the decode attention of one unstacked cache,
    float (k, v) [B, Hkv, S, D] or the int8 4-tuple with [B, Hkv, S]
    scales."""
    decode_attention_plain.launches += 1
    k, ks, v, vs = _split_kv(kv)
    return _decode_plain(q, k, ks, v, vs, pos, scale)


decode_attention_plain.launches = 0


def decode_attention_cuda(q: torch.Tensor, kv, *, pos: Pos = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """K6 (the TPU ``_dec_kernel``): K3's kernel on the cache viewed as one
    layer, [1, B, Hkv, S, D] -- no copy; same contract as
    ``decode_attention_plain``."""
    k, ks, v, vs = _split_kv(kv)
    if k.dim() != 4:
        raise ValueError(f"decode_attention: the cache must be [B, Hkv, S, "
                         f"D], got {tuple(k.shape)}")
    one = [None if t is None else t.unsqueeze(0) for t in (k, ks, v, vs)]
    o = _launch_decode("decode_attention", q, *one, 0, pos, scale)
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0


def decode_attention(q: torch.Tensor, kv, *, pos: Pos = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention for the KV-cached decode path (Tq of 1..16) over one
    unstacked cache: q [B, H, Tq, D]; ``kv`` float (k, v) [B, Hkv, S, D] or
    the int8 4-tuple with [B, Hkv, S] scales; ``pos`` scalar, per-slot [B],
    or None (every key). K6 for CUDA tensors, else the plain version."""
    fn = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return fn(q, kv, pos=pos, scale=scale)
