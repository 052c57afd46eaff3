"""Attention: the CUDA kernels K2 (flash forward), K7/K8 (flash backward)
and K3 (stacked decode attention) with their plain PyTorch versions.

Port of ``audax/ops/attention.py``:

  * ``flash_forward`` -- the forward of ``flash_attention`` (TPU kernel
    ``_fwd_kernel``): online-softmax attention writing O and the logsumexp,
    with grouped-query heads (kv head = q head // group), a ragged Tk and an
    optional causal mask (Tq == Tk). Its plain version mirrors the JAX
    package's ``xla_attention``. ``fold`` heads of the fused B*H axis may
    share one block (the TPU probe ``tools/attn_headfold_probe.py``'s P1,
    a template parameter of K2's kernel); ``launch_flash_forward`` is the
    kernel launch itself, with a key count ``kv_len`` apart from the K/V
    row stride, for callers that keep their own counter.
    ``flash_forward_tf32x3_cuda`` launches K2's float32 body on the tensor
    cores (3xTF32), ``flash_forward_wgmma_cuda`` its bf16 body.
  * ``flash_backward`` -- the gradients of ``flash_attention`` (TPU kernels
    ``_dq_kernel`` and ``_dkv_kernel`` of ``_bwd_pallas``): P is recomputed
    from the saved logsumexp, delta = rowsum(dO * O) is a plain float32 pass
    (the JAX package leaves it to XLA), and a kv head's gradient sums its
    whole q-head group. ``flash_attention`` is a ``torch.autograd.Function``
    whose forward is K2 and whose backward is K7 + K8.
    ``flash_backward_dq_tf32x3_cuda`` / ``flash_backward_dkv_tf32x3_cuda``
    launch K7/K8's float32 bodies on the tensor cores (3xTF32),
    ``flash_backward_dq_wgmma_cuda`` / ``flash_backward_dkv_wgmma_cuda``
    their bf16 bodies.
  * ``xla_attention`` (the materialised twin, any mask), ``flash_applicable``
    and ``dot_product_attention``, which takes the flash path wherever
    ``flash_applicable`` holds -- the rule the TPU path follows -- and the
    twin otherwise, or the twin always with ``backend="xla"`` (JAX's
    ``backend=``). ``attention_backend`` sets the default of ``backend=None``
    for a ``with`` block (JAX's ``AUDAX_ATTN_BACKEND``); the default is
    "flash". Whisper's attention sites all go through it.
  * ``decode_attention_stacked`` -- small-Tq attention over the
    layer-stacked ``[L, B, Hkv, S, D]`` KV cache (TPU kernel
    ``_dec_kernel_stacked``), the layer picked by index inside the kernel,
    keys masked per slot by ``pos``. Whisper's decoder runs it twice per
    layer per token (self- and cross-attention). The cache is float (K3)
    or int8 with per-vector float32 scales (``QuantKV``, K3's int8 arm,
    counted on its own). Its plain version mirrors ``_decode_attention_xla``.
    The kernel takes at most 16 query rows; a longer span (a speculative
    prefill) is launched in chunks of 16, chunk r0 at ``pos + r0``.
  * ``decode_attention`` -- the same for one unstacked ``[B, Hkv, S, D]``
    cache (TPU kernel ``_dec_kernel``, K6): K3's kernel launched with L = 1.

Tiles. ``block_q`` is the query rows per block of K2 and K7 and the query
tile K8 loops over; ``block_k`` the keys per tile of K2 and K7 and the keys
per block of K8. ``None`` keeps each kernel's default: in float32 (64, 64);
in bf16 ``WGMMA_TILE`` for K2 and ``BWD_WGMMA_TILE`` for K7 and K8. The caller-set tiles are ``TILES`` --
every pair of 32, 64 and 128 -- at head_dim 64, for all three kernels;
``fold`` 2 or 4 (``FOLDS``) runs at head_dim 64 with the 64 x 64 tile.

Bodies. K2, K7 and K8 have three each, and one table per direction
maps every call the kernels are built for to one of them: ``FWD_BODIES``
((dtype, head_dim, tile, fold) of K2) and ``BWD_BODIES`` ((kernel, dtype,
head_dim, tile) of K7 "dq" and K8 "dkv"). K2 in float32 runs on the tensor
cores in 3xTF32 (``csrc/flash_fwd_tf32x3.cu``, mma.sync) at 64 query rows,
unfolded, and on the CUDA cores (``csrc/flash_fwd.cu``) at 32 or 128 rows
and in the folds; K7 in float32 runs in 3xTF32 (``csrc/flash_bwd_tf32x3.cu``)
at 64 query rows, K8 at 64 keys, and both on the CUDA cores
(``csrc/flash_bwd.cu``) at their other tiles; bf16 runs on the tensor cores
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``, wgmma) wherever
wgmma takes the tile -- K2 and K7 at 64 or 128 query rows, K8 at 64 or
128 keys -- and its other tiles and K2's folds on the CUDA cores. A
wrapper checks (block_q, block_k, head_dim, fold) and the (dtype, ...)
against those tables before it dispatches, so a CPU call raises the same
``ValueError`` as the card would; nothing is silently replaced. Each body
counts its own launches: ``flash_forward_cuda``,
``flash_backward_dq_cuda`` and ``flash_backward_dkv_cuda`` those on the
CUDA cores, the ``*_tf32x3_cuda`` launchers the float32 ones on the tensor
cores, the ``*_wgmma_cuda`` launchers the bf16 ones on the tensor cores.
JAX's tiles (2048, 512, ...) are TPU VMEM blocks.

Each kernel function dispatches on the tensor it is given: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence, Tuple, Union

import torch

from audax_torch.ops import native

__all__ = ["TILES", "FOLDS", "WGMMA_TILE", "BWD_WGMMA_TILE", "FWD_BODIES",
           "BWD_BODIES", "fwd_body", "bwd_body", "resolve_tile", "pick_fold",
           "flash_forward", "flash_forward_cuda", "flash_forward_plain",
           "flash_forward_wgmma_cuda", "flash_forward_tf32x3_cuda",
           "launch_flash_forward", "attention_backend",
           "flash_backward", "flash_backward_plain", "flash_backward_dq_plain",
           "flash_backward_dkv_plain", "flash_backward_dq_cuda",
           "flash_backward_dkv_cuda", "flash_backward_dq_wgmma_cuda",
           "flash_backward_dkv_wgmma_cuda", "flash_backward_dq_tf32x3_cuda",
           "flash_backward_dkv_tf32x3_cuda", "flash_attention",
           "FlashAttention",
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

#: the caller-set (block_q, block_k) tiles of K2, K7 and K8 at head_dim 64
TILES = tuple((bq, bk) for bq in (32, 64, 128) for bk in (32, 64, 128))
#: K2's head folds above 1, at head_dim 64 and the default tile
FOLDS = (2, 4)
_FOLD_HEAD_DIM, _FOLD_TILE = 64, (64, 64)
_BACKENDS = ("flash", "xla")
#: the default of dot_product_attention(backend=None), set for a block by
#: attention_backend. Process-wide, as JAX's environment switch is: a layer
#: checkpointed in the forward is recomputed during the backward on
#: autograd's device thread, and must take the path the forward took.
_backend_default = "flash"

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


# ------------------------------------------------------------------ tiles --

#: K2's bf16 tile on the tensor-core body at every head dim (block_q,
#: block_k): the fastest of the card's ``attn_block_probe`` sweep
WGMMA_TILE = (64, 128)
#: K7's and K8's bf16 tile on their tensor-core bodies at every head dim
#: (block_q, block_k): the fastest backward of the card's
#: ``attn_block_probe`` sweep among the tiles both bodies take
BWD_WGMMA_TILE = (128, 128)
_BWD_KERNELS = ("dq", "dkv")


def _fwd_bodies() -> dict:
    """``{(dtype, head_dim, (block_q, block_k), fold): body}``: every K2
    call the kernels are built for, and the body that serves it --
    "cuda_core" (float32 FMAs, ``csrc/flash_fwd.cu``, built in either
    dtype at every (head_dim, tile, fold) float32 takes), "tf32x3" (float32
    on the tensor cores in 3xTF32, ``csrc/flash_fwd_tf32x3.cu``) or "wgmma"
    (bf16 on the tensor cores, ``csrc/flash_fwd_sm90.cu``). float32 runs on
    the tensor cores wherever a block holds 64 query rows, unfolded (4
    warps, one m16n8k8 row tile of 16 rows each): the default 64 x 64 tile
    at every head dim (16, 32, 64 and 128) and the caller-set tiles
    (64, 32) and (64, 128) at head_dim 64; its caller-set 32- and 128-row
    tiles and the folds (the head-fold probe's A/B within one body) stay
    on the CUDA cores. bf16 runs on the tensor cores at ``WGMMA_TILE`` for
    every head dim and at every caller-set tile of 64 or 128 query rows
    (wgmma takes 64-row tiles); its 32-row tiles and its folds stay on the
    CUDA cores."""
    f32, bf16 = torch.float32, torch.bfloat16
    table = {}
    for d in _HEAD_DIMS:
        table[(f32, d, (64, 64), 1)] = "tf32x3"
        table[(bf16, d, WGMMA_TILE, 1)] = "wgmma"
    for tile in TILES:
        table[(f32, 64, tile, 1)] = "tf32x3" if tile[0] == 64 else "cuda_core"
        table[(bf16, 64, tile, 1)] = "wgmma" if tile[0] >= 64 else "cuda_core"
    for dt in (f32, bf16):
        for fold in FOLDS:
            table[(dt, _FOLD_HEAD_DIM, _FOLD_TILE, fold)] = "cuda_core"
    return table


#: the K2 body table (``_fwd_bodies``): ``resolve_tile`` and
#: ``launch_flash_forward`` read it, and a call off it raises
FWD_BODIES = _fwd_bodies()


def _default_tile(kernel: str, d: int, dtype: torch.dtype = torch.float32,
                  fold: int = 1) -> Tuple[int, int]:
    if kernel == "fwd":
        return WGMMA_TILE if dtype == torch.bfloat16 and fold == 1 else (64, 64)
    return BWD_WGMMA_TILE if dtype == torch.bfloat16 else (64, 64)


def _bwd_bodies() -> dict:
    """``{(kernel, dtype, head_dim, (block_q, block_k)): body}`` for K7
    ("dq") and K8 ("dkv"): every call the kernels are built for, and the
    body that serves it -- "cuda_core" (float32 FMAs, ``csrc/flash_bwd.cu``,
    built in either dtype at every caller-set tile), "tf32x3" (float32 on
    the tensor cores in 3xTF32, ``csrc/flash_bwd_tf32x3.cu``) or "wgmma"
    (bf16 on the tensor cores, ``csrc/flash_bwd_sm90.cu``). A kernel's rows
    are K7's query rows and K8's keys per block (``block_q`` and
    ``block_k``). float32 runs on the tensor cores wherever a block holds
    64 rows (4 warps, one m16n8k8 row tile of 16 rows each): the default
    64 x 64 tile at every head dim (16, 32, 64 and 128) and the caller-set
    tiles of 64 rows at head_dim 64; its caller-set tiles of 32 or 128 rows
    stay on the CUDA cores. bf16 runs on the tensor cores at
    ``BWD_WGMMA_TILE`` for every head dim and at each caller-set tile of 64
    or 128 rows (one warp group per 64 of them); its 32-row tiles stay on
    the CUDA cores."""
    f32, bf16 = torch.float32, torch.bfloat16
    table = {}
    for kernel in _BWD_KERNELS:
        for d in _HEAD_DIMS:
            table[(kernel, f32, d, _default_tile(kernel, d))] = "tf32x3"
        for tile in TILES:
            rows = tile[0] if kernel == "dq" else tile[1]
            table[(kernel, f32, 64, tile)] = ("tf32x3" if rows == 64
                                              else "cuda_core")
            table[(kernel, bf16, 64, tile)] = ("wgmma" if rows >= 64
                                               else "cuda_core")
        for d in _HEAD_DIMS:
            table[(kernel, bf16, d, BWD_WGMMA_TILE)] = "wgmma"
    return table


#: the K7/K8 body table (``_bwd_bodies``): ``resolve_tile`` and the
#: backward wrappers read it, and a call off it raises
BWD_BODIES = _bwd_bodies()


def _fwd_smem(d: int, block_q: int, block_k: int, fold: int) -> int:
    """Shared memory of K2's CUDA-core body (``csrc/flash_fwd.cu``): per
    folded head a q tile, a K tile (rows padded to d + 4 floats), a V tile
    and the per-warp probability rows."""
    return 4 * fold * ((block_q + block_k) * (d + 4) + block_k * d
                       + 16 * block_k)


def bwd_body(kernel: str, dtype: torch.dtype, d: int,
             block_q: Optional[int] = None,
             block_k: Optional[int] = None) -> str:
    """The body ``BWD_BODIES`` gives a K7 ("dq") or K8 ("dkv") call (tiles
    as ``resolve_tile`` takes them); raises ``ValueError`` off the table."""
    if kernel not in _BWD_KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {_BWD_KERNELS}")
    tile = resolve_tile(kernel, d, block_q, block_k, dtype=dtype)
    if (kernel, dtype, d, tile) not in BWD_BODIES:
        raise ValueError(f"{kernel} has no body for {dtype} at head_dim {d}")
    return BWD_BODIES[(kernel, dtype, d, tile)]


def fwd_body(dtype: torch.dtype, d: int, block_q: Optional[int] = None,
             block_k: Optional[int] = None, fold: int = 1) -> str:
    """The body ``FWD_BODIES`` gives a K2 call (tiles as ``resolve_tile``
    takes them); raises ``ValueError`` off the table."""
    tile = resolve_tile("fwd", d, block_q, block_k, fold, dtype=dtype)
    if (dtype, d, tile, fold) not in FWD_BODIES:
        raise ValueError(f"K2 has no body for {dtype} at head_dim {d}")
    return FWD_BODIES[(dtype, d, tile, fold)]


def resolve_tile(kernel: str, d: int, block_q: Optional[int] = None,
                 block_k: Optional[int] = None, fold: int = 1, *,
                 dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(block_q, block_k)`` of ``kernel`` ("fwd" K2, "dq" K7, "dkv" K8)
    at head_dim ``d``: ``None`` takes the kernel's default (K2's depends on
    ``dtype``: ``WGMMA_TILE`` for unfolded bf16). Raises ``ValueError`` for
    a (block_q, block_k, head_dim, fold) the kernels are not instantiated
    at -- ``TILES`` at head_dim 64, ``fold`` in ``FOLDS`` (K2 only) at
    head_dim 64 with the 64 x 64 tile, and any (dtype, head_dim, tile,
    fold) off ``FWD_BODIES`` (K2) or ``BWD_BODIES`` (K7, K8) at a head dim
    they take -- naming the shared memory limit when a fold does not fit.
    The defaults of K7/K8 depend on ``dtype`` too (``BWD_WGMMA_TILE`` for
    bf16). (Which head dims the kernels take at the default tile, the CUDA
    wrappers check; the plain versions take any.)"""
    default = _default_tile(kernel, d, dtype, fold)
    tile = (default[0] if block_q is None else int(block_q),
            default[1] if block_k is None else int(block_k))
    if fold != 1:
        if kernel != "fwd" or fold not in FOLDS:
            raise ValueError(f"fold {fold}: only the forward (K2) folds, by "
                             f"one of {FOLDS}")
        smem = _fwd_smem(d, *tile, fold)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"fold {fold} at block_q {tile[0]}, block_k "
                             f"{tile[1]}, head_dim {d} needs {smem} B of "
                             f"shared memory; one block may use "
                             f"{_SMEM_LIMIT} B")
        if (d, tile) != (_FOLD_HEAD_DIM, _FOLD_TILE):
            raise ValueError(f"fold {fold} is built at head_dim "
                             f"{_FOLD_HEAD_DIM} with the tile {_FOLD_TILE}, "
                             f"not head_dim {d} with {tile}")
    elif tile != default and not (d == 64 and tile in TILES):
        raise ValueError(f"{kernel} tile (block_q, block_k) = {tile} is not "
                         f"built at head_dim {d}: the default {default}, or "
                         f"at head_dim 64 one of {TILES}")
    if (kernel == "fwd" and dtype in _DTYPES and d in _HEAD_DIMS
            and (dtype, d, tile, fold) not in FWD_BODIES):
        raise ValueError(f"fwd tile (block_q, block_k) = {tile} with fold "
                         f"{fold} has no {dtype} body at head_dim {d}: see "
                         f"FWD_BODIES")
    if (kernel in _BWD_KERNELS and dtype in _DTYPES and d in _HEAD_DIMS
            and (kernel, dtype, d, tile) not in BWD_BODIES):
        raise ValueError(f"{kernel} tile (block_q, block_k) = {tile} has no "
                         f"{dtype} body at head_dim {d}: see BWD_BODIES")
    return tile


def pick_fold(fold: int, *, causal: bool, group: int, bhq: int) -> int:
    """The fold the product call runs (JAX's ``_pick_fold``): folding
    applies only to non-causal MHA (group 1), capped at 2, and only when
    the fused B*Hq axis divides by it; otherwise 1."""
    if causal or group != 1 or fold <= 1:
        return 1
    fold = min(int(fold), 2)
    return 1 if bhq % fold else fold


# ------------------------------------------------------------------ flash --

def _forward_math(q, k, v, causal, scale):
    """Materialised attention: softmax in float32, probabilities cast to
    q's dtype before PV. Returns (o, lse [B*Hq, Tq] float32)."""
    b, hq, tq, _ = q.shape
    group = hq // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if causal:
        tk = s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    s32 = s.float()
    p = torch.softmax(s32, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, torch.logsumexp(s32, dim=-1).reshape(b * hq, tq)


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised attention (the JAX ``xla_attention`` math): softmax in
    float32, probabilities cast to q's dtype before PV. Returns
    ``(o [B, Hq, Tq, D], lse [B*Hq, Tq] float32)`` -- whatever tile or fold
    the kernel would run."""
    flash_forward_plain.launches += 1
    return _forward_math(q, k, v, causal, _scale(q, scale))


flash_forward_plain.launches = 0


def launch_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         scale: Optional[float] = None,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None, fold: int = 1,
                         kv_len: Optional[int] = None,
                         name: str = "flash_forward",
                         body: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K2 on the body ``FWD_BODIES`` names (the CUDA-core
    ``csrc/flash_fwd.cu``, or on the tensor cores, each counted by its own
    launcher, ``csrc/flash_fwd_tf32x3.cu`` for float32 and
    ``csrc/flash_fwd_sm90.cu`` for bf16), otherwise counted by no one:
    q [B, Hq, Tq, D], k/v [B, Hkv, Tk, D] with keys at or past ``kv_len``
    (default Tk) masked and never read; ``fold`` heads of the fused B*Hq
    axis per block. ``body="cuda_core"`` takes the CUDA-core body at any
    (head_dim, tile, fold) float32 takes, whatever the dtype (the
    head-fold probe's A/B within that body). Returns
    ``(o, lse [B*Hq, Tq])``."""
    _check_cuda(name, q, k, v)
    b, hq, tq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    kv_len = tk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= tk:
        raise ValueError(f"{name}: kv_len {kv_len} outside 0..{tk}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if causal and tq != tk:
        raise ValueError("causal flash attention requires Tq == Tk")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    bq, bk = resolve_tile("fwd", d, block_q, block_k, fold, dtype=q.dtype)
    if fold > 1 and (hq != hkv or causal or (b * hq) % fold):
        raise ValueError(f"{name}: fold {fold} needs non-causal MHA and B*Hq "
                         f"= {b * hq} divisible by it")
    if body is not None and (body != "cuda_core" or (
            torch.float32, d, (bq, bk), fold) not in FWD_BODIES):
        raise ValueError(f"{name}: no {body!r} body at head_dim {d}, tile "
                         f"{(bq, bk)}, fold {fold}")
    tensor_core = {"wgmma": flash_forward_wgmma_cuda,
                   "tf32x3": flash_forward_tf32x3_cuda}.get(
        FWD_BODIES[(q.dtype, d, (bq, bk), fold)] if body is None else body)
    if tensor_core is not None:
        return tensor_core(q, k, v, causal=causal, scale=scale, block_q=bq,
                           block_k=bk, kv_len=kv_len, name=name)
    o = torch.empty_like(q)
    lse = torch.empty(b * hq, tq, device=q.device, dtype=torch.float32)
    if tq == 0:
        return o, lse
    status = native.library("flash_fwd").flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, tq, kv_len, tk, d, _scale(q, scale),
        int(causal), _DTYPES[q.dtype], bq, bk, int(fold),
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, name)
    return o, lse


def _tensor_core_forward(lib: str, dtype: torch.dtype,
                         default_tile: Tuple[int, int], q, k, v, causal,
                         scale, block_q, block_k, kv_len, name):
    """One launch of the tensor-core body of K2 in library ``lib`` (entry
    point of the same name) on ``dtype`` operands: ``(o, lse, launched)``.
    Checks what the C entry point does not (device, dtype, shapes,
    ``kv_len``, 16-byte alignment for its copies); the library refuses a
    (head_dim, tile) it is not built at with ``cudaErrorInvalidValue``,
    which raises."""
    _check_cuda(name, q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    kv_len = tk if kv_len is None else int(kv_len)
    tile = (default_tile[0] if block_q is None else int(block_q),
            default_tile[1] if block_k is None else int(block_k))
    if q.dtype != dtype:
        raise ValueError(f"{name}: the {lib} body takes {dtype}, not "
                         f"{q.dtype}")
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != d or hq % hkv or not 0 <= kv_len <= tk
            or (causal and tq != tk)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, kv_len {kv_len}, causal "
                         f"{causal} is not a call the {lib} body takes")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the {lib} body copies 16-byte chunks; "
                         f"q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty(b * hq, tq, device=q.device, dtype=torch.float32)
    if tq == 0:
        return o, lse, False
    status = getattr(native.library(lib), lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, tq, kv_len, tk, d, _scale(q, scale),
        int(causal), tile[0], tile[1],
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, name)
    return o, lse, True


def flash_forward_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None,
                             kv_len: Optional[int] = None,
                             name: str = "flash_forward"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's bf16 tensor-core body (``csrc/flash_fwd_sm90.cu``): one
    counted launch, same contract as ``flash_forward_plain`` with keys at or
    past ``kv_len`` masked. Takes bf16, 16-byte-aligned operands at a
    (head_dim, tile) that ``FWD_BODIES`` gives this body (default
    ``WGMMA_TILE``), as ``launch_flash_forward`` routes them; the library
    refuses any other with ``cudaErrorInvalidValue``, which raises."""
    o, lse, launched = _tensor_core_forward(
        "flash_fwd_sm90", torch.bfloat16, WGMMA_TILE, q, k, v, causal,
        scale, block_q, block_k, kv_len, name)
    flash_forward_wgmma_cuda.launches += launched
    return o, lse


flash_forward_wgmma_cuda.launches = 0


def flash_forward_tf32x3_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              scale: Optional[float] = None,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None,
                              kv_len: Optional[int] = None,
                              name: str = "flash_forward"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's float32 body on the tensor cores (``csrc/flash_fwd_tf32x3.cu``,
    3xTF32 on mma.sync): one counted launch, same contract as
    ``flash_forward_plain`` with keys at or past ``kv_len`` masked. Takes
    float32, 16-byte-aligned operands at a (head_dim, tile) that
    ``FWD_BODIES`` gives this body (default 64 x 64), as
    ``launch_flash_forward`` routes them; the library refuses any other
    with ``cudaErrorInvalidValue``, which raises."""
    o, lse, launched = _tensor_core_forward(
        "flash_fwd_tf32x3", torch.float32, (64, 64), q, k, v, causal, scale,
        block_q, block_k, kv_len, name)
    flash_forward_tf32x3_cuda.launches += launched
    return o, lse


flash_forward_tf32x3_cuda.launches = 0


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, scale: Optional[float] = None,
                       block_q: Optional[int] = None,
                       block_k: Optional[int] = None, fold: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel K2 on the body ``FWD_BODIES`` gives the call
    (``csrc/flash_fwd.cu`` on the CUDA cores, or on the tensor cores
    ``csrc/flash_fwd_tf32x3.cu`` in float32 and ``csrc/flash_fwd_sm90.cu``
    in bf16); same contract as ``flash_forward_plain``. Its count holds
    K2's launches on the CUDA cores; those on the tensor cores are
    ``flash_forward_tf32x3_cuda``'s and ``flash_forward_wgmma_cuda``'s."""
    out = launch_flash_forward(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k, fold=fold)
    if fwd_body(q.dtype, q.shape[-1], block_q, block_k, fold) == "cuda_core":
        flash_forward_cuda.launches += 1
    return out


flash_forward_cuda.launches = 0


def flash_forward(q, k, v, *, causal=False, scale=None, block_q=None,
                  block_k=None, fold=1):
    """``(o, lse)``: the CUDA kernel for CUDA tensors -- the body
    ``FWD_BODIES`` gives (dtype, head_dim, tile, fold) -- else the plain
    version; the tiles and fold are checked first, on either device."""
    resolve_tile("fwd", q.shape[-1], block_q, block_k, fold, dtype=q.dtype)
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal=causal, scale=scale)
    return flash_forward_cuda(q, k, v, causal=causal, scale=scale,
                              block_q=block_q, block_k=block_k, fold=fold)


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


def _tensor_core_backward(kernel: str, lib: str, dtype: torch.dtype,
                          default_tile: Tuple[int, int], q, k, v, do, lse,
                          delta, causal, scale, block_q, block_k,
                          name: str) -> Tuple[torch.Tensor, ...]:
    """One launch of K7 ("dq": ``(dq,)``) or K8 ("dkv": ``(dk, dv)``) on the
    tensor-core body in library ``lib`` (entry point of the same name) on
    ``dtype`` operands: q, do [B, Hq, Tq, D], k, v [B, Hkv, Tk, D] (Tq, Tk
    > 0), lse and ``delta`` = rowsum(dO * O) [B*Hq, Tq] float32. Checks what
    the C entry point does not (dtype, device, 16-byte alignment for its
    copies); the library refuses a (head_dim, tile) it is not built at with
    ``cudaErrorInvalidValue``, which raises."""
    if q.dtype != dtype:
        want = "bf16" if dtype == torch.bfloat16 else "float32"
        raise ValueError(f"{name}: the tensor-core body {lib} takes {want}, "
                         f"not {q.dtype}")
    _check_cuda(name, q, k, v, do)
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError(f"{name}: the tensor-core body copies 16-byte "
                         f"chunks; q, k, v and do must be 16-byte aligned")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    outs = ((torch.empty_like(q),) if kernel == "dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    status = getattr(native.library(lib), lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs), b,
        hq, hkv, tq, tk, d, _scale(q, scale), int(causal),
        block_q or default_tile[0], block_k or default_tile[1],
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, name)
    return outs


def flash_backward_dq_wgmma_cuda(q, k, v, do, lse, delta, *, causal=False,
                                 scale=None, block_q=None, block_k=None
                                 ) -> torch.Tensor:
    """One counted launch of K7's bf16 tensor-core body
    (``csrc/flash_bwd_sm90.cu``) on the library's operands
    (``_tensor_core_backward``). ``flash_backward_dq_cuda`` checks the call
    and routes it here where ``BWD_BODIES`` names this body (default tile
    ``BWD_WGMMA_TILE``); this takes bf16, 16-byte-aligned operands."""
    dq, = _tensor_core_backward(
        "dq", "flash_bwd_dq_sm90", torch.bfloat16, BWD_WGMMA_TILE, q, k, v,
        do, lse, delta, causal, scale, block_q, block_k,
        "flash_backward_dq_wgmma")
    flash_backward_dq_wgmma_cuda.launches += 1
    return dq


flash_backward_dq_wgmma_cuda.launches = 0


def flash_backward_dkv_wgmma_cuda(q, k, v, do, lse, delta, *, causal=False,
                                  scale=None, block_q=None, block_k=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One counted launch of K8's bf16 tensor-core body
    (``csrc/flash_bwd_sm90.cu``), ``(dk, dv)``; operands and routing as
    ``flash_backward_dq_wgmma_cuda`` takes them, from
    ``flash_backward_dkv_cuda``."""
    dk, dv = _tensor_core_backward(
        "dkv", "flash_bwd_dkv_sm90", torch.bfloat16, BWD_WGMMA_TILE, q, k, v,
        do, lse, delta, causal, scale, block_q, block_k,
        "flash_backward_dkv_wgmma")
    flash_backward_dkv_wgmma_cuda.launches += 1
    return dk, dv


flash_backward_dkv_wgmma_cuda.launches = 0


def flash_backward_dq_tf32x3_cuda(q, k, v, do, lse, delta, *, causal=False,
                                  scale=None, block_q=None, block_k=None
                                  ) -> torch.Tensor:
    """One counted launch of K7's float32 body on the tensor cores
    (``csrc/flash_bwd_tf32x3.cu``, 3xTF32 on mma.sync) on the library's
    operands (``_tensor_core_backward``). ``flash_backward_dq_cuda`` checks
    the call and routes it here where ``BWD_BODIES`` names this body
    (default tile 64 x 64); this takes float32, 16-byte-aligned operands."""
    dq, = _tensor_core_backward(
        "dq", "flash_bwd_dq_tf32x3", torch.float32, (64, 64), q, k, v, do,
        lse, delta, causal, scale, block_q, block_k,
        "flash_backward_dq_tf32x3")
    flash_backward_dq_tf32x3_cuda.launches += 1
    return dq


flash_backward_dq_tf32x3_cuda.launches = 0


def flash_backward_dkv_tf32x3_cuda(q, k, v, do, lse, delta, *, causal=False,
                                   scale=None, block_q=None, block_k=None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One counted launch of K8's float32 body on the tensor cores
    (``csrc/flash_bwd_tf32x3.cu``), ``(dk, dv)``; operands and routing as
    ``flash_backward_dq_tf32x3_cuda`` takes them, from
    ``flash_backward_dkv_cuda``."""
    dk, dv = _tensor_core_backward(
        "dkv", "flash_bwd_dkv_tf32x3", torch.float32, (64, 64), q, k, v, do,
        lse, delta, causal, scale, block_q, block_k,
        "flash_backward_dkv_tf32x3")
    flash_backward_dkv_tf32x3_cuda.launches += 1
    return dk, dv


flash_backward_dkv_tf32x3_cuda.launches = 0


def flash_backward_dq_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                           block_q=None, block_k=None,
                           delta: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Kernel K7 on the body ``BWD_BODIES`` names: ``csrc/flash_bwd.cu`` on
    the CUDA cores, counted here, or on the tensor cores
    ``flash_backward_dq_tf32x3_cuda`` (float32) or
    ``flash_backward_dq_wgmma_cuda`` (bf16), counted there; same contract
    as ``flash_backward_dq_plain``. ``delta`` may be passed precomputed."""
    _check_backward(q, k, v, o, lse, do, causal)
    b, hq, tq, d = q.shape
    bq, bk = resolve_tile("dq", d, block_q, block_k, dtype=q.dtype)
    hkv, tk = k.shape[1], k.shape[2]
    if tk == 0:
        return torch.zeros_like(q)
    if tq == 0:
        return torch.empty_like(q)
    delta = _delta(o, do) if delta is None else delta
    tensor_core = {"tf32x3": flash_backward_dq_tf32x3_cuda,
                   "wgmma": flash_backward_dq_wgmma_cuda}.get(
        BWD_BODIES[("dq", q.dtype, d, (bq, bk))])
    if tensor_core is not None:
        return tensor_core(q, k, v, do, lse, delta, causal=causal,
                           scale=scale, block_q=bq, block_k=bk)
    dq = torch.empty_like(q)
    status = native.library("flash_bwd_dq").flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, hq, hkv, tq, tk,
        d, _scale(q, scale), int(causal), _DTYPES[q.dtype], bq, bk,
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "flash_backward_dq")
    flash_backward_dq_cuda.launches += 1
    return dq


flash_backward_dq_cuda.launches = 0


def flash_backward_dkv_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                            block_q=None, block_k=None,
                            delta: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K8 on the body ``BWD_BODIES`` names: ``csrc/flash_bwd.cu``,
    counted here, or ``flash_backward_dkv_tf32x3_cuda`` /
    ``flash_backward_dkv_wgmma_cuda``, counted there; same contract as
    ``flash_backward_dkv_plain``. ``delta`` as ``flash_backward_dq_cuda``
    takes it."""
    _check_backward(q, k, v, o, lse, do, causal)
    b, hq, tq, d = q.shape
    bq, bk = resolve_tile("dkv", d, block_q, block_k, dtype=q.dtype)
    hkv, tk = k.shape[1], k.shape[2]
    if tq == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    if tk == 0:
        return torch.empty_like(k), torch.empty_like(v)
    delta = _delta(o, do) if delta is None else delta
    tensor_core = {"tf32x3": flash_backward_dkv_tf32x3_cuda,
                   "wgmma": flash_backward_dkv_wgmma_cuda}.get(
        BWD_BODIES[("dkv", q.dtype, d, (bq, bk))])
    if tensor_core is not None:
        return tensor_core(q, k, v, do, lse, delta, causal=causal,
                           scale=scale, block_q=bq, block_k=bk)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = native.library("flash_bwd_dkv").flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq,
        hkv, tq, tk, d, _scale(q, scale), int(causal), _DTYPES[q.dtype], bq,
        bk, torch.cuda.current_stream(q.device).cuda_stream)
    native.check(status, "flash_backward_dkv")
    flash_backward_dkv_cuda.launches += 1
    return dk, dv


flash_backward_dkv_cuda.launches = 0


def flash_backward(q, k, v, o, lse, do, *, causal=False, scale=None,
                   block_q=None, block_k=None):
    """``(dq, dk, dv)``: kernels K7 and K8 for CUDA tensors, each on the
    body ``BWD_BODIES`` names (one delta pass shared by both), else the
    plain version. ``block_q``/``block_k`` are the tiles of both kernels
    (None: each kernel's default), checked first on either device."""
    d = q.shape[-1]
    resolve_tile("dq", d, block_q, block_k, dtype=q.dtype)
    resolve_tile("dkv", d, block_q, block_k, dtype=q.dtype)
    tiles = dict(block_q=block_q, block_k=block_k)
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                    scale=scale)
    delta = _delta(o, do)
    dq = flash_backward_dq_cuda(q, k, v, o, lse, do, causal=causal,
                                scale=scale, delta=delta, **tiles)
    dk, dv = flash_backward_dkv_cuda(q, k, v, o, lse, do, causal=causal,
                                     scale=scale, delta=delta, **tiles)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward K2, backward K7 + K8 (their
    plain versions on CPU tensors). Saves q, k, v, o and the logsumexp;
    nothing O(Tq * Tk) is kept for the backward. The backward takes the
    forward's tiles and never folds, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q, block_k,
                fold: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k, fold=fold)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.tiles = dict(block_q=block_q, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale,
                                    **ctx.tiles)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    fold: int = 1) -> torch.Tensor:
    """Fused attention output. q [B, Hq, Tq, D]; k/v [B, Hkv, Tk, D] with
    Hq % Hkv == 0. Causal requires Tq == Tk. Differentiable: the backward
    runs the flash backward kernels.

    ``block_q``/``block_k`` set the tiles of K2, K7 and K8 (module
    docstring; None keeps each kernel's default). ``fold`` asks the forward
    to fold heads (JAX's ``AUDAX_ATTN_FOLD``); ``pick_fold`` decides what
    runs: non-causal MHA only, at most 2, else 1. Every tile and fold is
    checked before anything runs."""
    b, hq, tq, d = q.shape
    if causal and tq != k.shape[2]:
        raise ValueError("causal flash attention requires Tq == Tk")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    fold = pick_fold(fold, causal=causal, group=hq // k.shape[1], bhq=b * hq)
    resolve_tile("fwd", d, block_q, block_k, fold, dtype=q.dtype)
    resolve_tile("dq", d, block_q, block_k, dtype=q.dtype)
    resolve_tile("dkv", d, block_q, block_k, dtype=q.dtype)
    return FlashAttention.apply(q, k, v, causal, _scale(q, scale), block_q,
                                block_k, fold)


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


@contextlib.contextmanager
def attention_backend(backend: str) -> Iterator[None]:
    """``with attention_backend("xla"):`` makes the materialised twin the
    default of ``dot_product_attention(backend=None)`` inside the block
    (and ``"flash"`` the flash path), for the whole process -- autograd's
    threads included -- until the block ends. Outside any such block the
    default is "flash". Not for threads that want different defaults at
    once."""
    global _backend_default
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
    outer, _backend_default = _backend_default, backend
    try:
        yield
    finally:
        _backend_default = outer


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          backend: Optional[str] = None) -> torch.Tensor:
    """``backend="flash"``: flash attention (K2 forward, K7/K8 backward on
    CUDA) wherever ``flash_applicable`` holds, the materialised twin
    otherwise; ``"xla"``: the twin always. ``None`` takes the default that
    ``attention_backend`` sets ("flash" outside it)."""
    backend = _backend_default if backend is None else backend
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
    if backend == "flash" and flash_applicable(q.shape, k.shape, mask, causal):
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


def _decode_rows(launch: Callable[[torch.Tensor, Pos], torch.Tensor],
                 q: torch.Tensor, pos: Pos) -> torch.Tensor:
    """``launch(q_rows, pos_rows)`` over chunks of at most 16 query rows of
    q [B, H, Tq, D], concatenated along Tq. Row i sees keys <= pos + i, so
    the chunk starting at row r0 runs at ``pos + r0`` (scalar or per slot;
    None, every key, stays None). The decode kernel's scores of all its rows
    share one block's shared memory, so each chunk is checked at its own
    length (16 at most), never at Tq."""
    tq = q.shape[2]
    if tq <= _MAX_DECODE_ROWS:
        return launch(q, pos)
    outs = []
    for r0 in range(0, tq, _MAX_DECODE_ROWS):
        rows = q[:, :, r0:r0 + _MAX_DECODE_ROWS].contiguous()
        outs.append(launch(rows, None if pos is None else pos + r0))
    return torch.cat(outs, dim=2)


def _launch_decode(name: str, q, k, ks, v, vs, layer: int, pos: Pos,
                   scale) -> torch.Tensor:
    """Launch the K3 kernel (float or int8 arm) once on ``layer`` of the
    stacked cache k, v [L, B, Hkv, S, D] (int8 with float32 [L, B, Hkv, S]
    scales ``ks``/``vs``, or None), for 1..16 query rows."""
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

    def launch(rows, at):
        o = _launch_decode("decode_attention_stacked", rows, k, None, v,
                           None, layer, at, scale)
        decode_attention_stacked_cuda.launches += 1
        return o
    return _decode_rows(launch, q, pos)


decode_attention_stacked_cuda.launches = 0


def decode_attention_stacked_int8_cuda(q: torch.Tensor, kv, layer: int, *,
                                       pos: Pos = None,
                                       scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """K3's int8 arm (``decode_attention_stacked_q8`` of
    ``csrc/decode_attention.cu``); same contract as
    ``decode_attention_stacked_int8_plain``."""
    k, ks, v, vs = kv

    def launch(rows, at):
        o = _launch_decode("decode_attention_stacked_int8", rows, k, ks, v,
                           vs, layer, at, scale)
        decode_attention_stacked_int8_cuda.launches += 1
        return o
    return _decode_rows(launch, q, pos)


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

    def launch(rows, at):
        o = _launch_decode("decode_attention", rows, *one, 0, at, scale)
        decode_attention_cuda.launches += 1
        return o
    return _decode_rows(launch, q, pos)


decode_attention_cuda.launches = 0


def decode_attention(q: torch.Tensor, kv, *, pos: Pos = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention for the KV-cached decode path (any Tq >= 1; the kernel
    takes 16 rows per launch) over one unstacked cache: q [B, H, Tq, D];
    ``kv`` float (k, v) [B, Hkv, S, D] or the int8 4-tuple with [B, Hkv, S]
    scales; ``pos`` scalar, per-slot [B], or None (every key). K6 for CUDA tensors, else the plain version."""
    fn = decode_attention_cuda if q.is_cuda else decode_attention_plain
    return fn(q, kv, pos=pos, scale=scale)
