"""Attention: the CUDA kernels K2 (flash forward) and K3 (stacked decode
attention) with their plain PyTorch versions.

Port of ``audax/ops/attention.py``:

  * ``flash_forward`` -- the forward of ``flash_attention`` (TPU kernel
    ``_fwd_kernel``): online-softmax attention writing O and the logsumexp,
    with grouped-query heads (kv head = q head // group), a ragged Tk and an
    optional causal mask (Tq == Tk). Whisper's encoder self-attention calls
    ``flash_attention`` directly: the JAX ``dot_product_attention``
    dispatcher's explicit-mask path has no caller in this slice. Its plain
    version mirrors the JAX package's ``xla_attention``.
  * ``decode_attention_stacked`` -- small-Tq attention over the
    layer-stacked ``[L, B, Hkv, S, D]`` KV cache (TPU kernel
    ``_dec_kernel_stacked``), the layer picked by index inside the kernel,
    keys masked per slot by ``pos``. Whisper's decoder runs it twice per
    layer per token (self- and cross-attention). Its plain version mirrors
    ``_decode_attention_xla``.

Each public function dispatches on the tensor it is given: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises. The
flash backward kernels (K7, K8) and the int8 ``QuantKV`` arm of K3 belong to
later slices. Head folding (``fold``) was a TPU VMEM device and is not
ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from audax_torch.ops import native

__all__ = ["flash_forward", "flash_forward_cuda", "flash_forward_plain",
           "flash_attention",
           "decode_attention_stacked", "decode_attention_stacked_cuda",
           "decode_attention_stacked_plain"]

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention output. q [B, Hq, Tq, D]; k/v [B, Hkv, Tk, D] with
    Hq % Hkv == 0. Causal requires Tq == Tk. Forward only in this slice."""
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]


# ----------------------------------------------------------------- decode --

def _split_kv(kv: Sequence[torch.Tensor]):
    if len(kv) == 4:
        raise NotImplementedError("int8 QuantKV decode attention arrives "
                                  "with the kv_quant serving slice")
    return kv


def decode_attention_stacked_plain(q: torch.Tensor, kv, layer: int, *,
                                   pos: Pos = None,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """The JAX ``_decode_attention_xla`` math on the selected layer: query
    row i sees keys <= pos + i (``pos`` scalar or per-slot [B]; None = all
    keys), softmax in float32, probabilities cast to q's dtype before PV."""
    decode_attention_stacked_plain.launches += 1
    k, v = _split_kv(kv)
    k, v = k[layer], v[layer]
    dt = q.dtype
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * _scale(q, scale), k)
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
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


decode_attention_stacked_plain.launches = 0


def decode_attention_stacked_cuda(q: torch.Tensor, kv, layer: int, *,
                                  pos: Pos = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """The CUDA kernel (``csrc/decode_attention.cu``); same contract as
    ``decode_attention_stacked_plain``."""
    k, v = _split_kv(kv)
    _check_cuda("decode_attention_stacked", q, k, v)
    b, h, tq, d = q.shape
    if k.dim() != 5 or k.shape != v.shape or k.shape[1] != b or k.shape[4] != d:
        raise ValueError(f"decode_attention_stacked: q {tuple(q.shape)} does "
                         f"not match the cache {tuple(k.shape)}")
    n_layers, _, hkv, s_len, _ = k.shape
    if h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if not 0 <= int(layer) < n_layers:
        raise IndexError(f"layer {layer} outside a {n_layers}-layer cache")
    if not 1 <= tq <= _MAX_DECODE_ROWS or d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention_stacked: Tq={tq} (1..16) and "
                         f"head_dim={d} {_HEAD_DIMS} not supported")
    lib = native.library("decode_attention")
    if lib.decode_smem(d, tq, s_len) > _SMEM_LIMIT:
        raise ValueError(f"decode_attention_stacked: Tq*S={tq * s_len} "
                         "scores exceed one block's shared memory")
    if pos is None:
        pos = s_len
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape[0] != b:
            raise ValueError(f"pos has {pos.shape[0]} entries for batch {b}")
        pos_v = pos.to(device=q.device, dtype=torch.int32).contiguous()
    else:
        pos_v = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    status = lib.decode_attention_stacked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        pos_v.data_ptr(), int(layer), b, h, hkv, tq, s_len, d,
        _scale(q, scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "decode_attention_stacked")
    decode_attention_stacked_cuda.launches += 1
    return o


decode_attention_stacked_cuda.launches = 0


def decode_attention_stacked(q: torch.Tensor, kv, layer: int, *,
                             pos: Pos = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention against the layer-stacked cache. q [B, H, Tq, D];
    ``kv`` the float pair (k, v) [L, B, Hkv, S, D]; ``layer`` picks the
    layer; ``pos`` a scalar, a per-slot [B] vector, or None (every key --
    cross-attention). The CUDA kernel for CUDA tensors, else the plain
    version."""
    fn = (decode_attention_stacked_cuda if q.is_cuda
          else decode_attention_stacked_plain)
    return fn(q, kv, layer, pos=pos, scale=scale)
