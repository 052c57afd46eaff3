"""The kernel-experiment tools (port of ``tools/``): the four int4 tools
(``int4_layout_ab.py``, ``int4_plane_probe.py``, ``w4a8_probe.py``,
``int4_unpack_probe.py``) and the four attention tools
(``attn_headfold_probe.py``, ``attn_block_probe.py``,
``train_step_breakdown.py``, ``mfu_study.py``).

Each int4 tool A/Bs one int4 design against kernel K9
(``ops/int4_matmul.py``) on the card, with a hand-written kernel of its own
(``csrc/``) and a plain PyTorch version. The attention tools measure the
flash kernels K2/K7/K8 and the fine-tune step: the head-fold probe P1 (a
fold of K2's kernel, ``csrc/flash_fwd.cu``), the tile sweep, the step's
stages, and the MFU grid. Their entry points:

    python -m audax_torch.tools.int4_layout_ab check|bench [--device cpu] [--out PATH]
    python -m audax_torch.tools.int4_plane_probe [--device cpu] [--out PATH]
    python -m audax_torch.tools.w4a8_probe [--device cpu] [--out PATH]
    python -m audax_torch.tools.int4_unpack_probe [--device cpu] [--out PATH]
    python -m audax_torch.tools.attn_headfold_probe [--device cpu] [--out PATH]
    python -m audax_torch.tools.attn_block_probe [--device cpu] [--out PATH]
    python -m audax_torch.tools.train_step_breakdown [--attn flash|xla] ... [--device cpu] [--out PATH]
    python -m audax_torch.tools.mfu_study [--only 0,10] ... [--device cpu] [--out PATH]

They run on the CUDA card unless ``--device cpu`` is given (and raise on a
host without one); on the CPU they run the plain versions at a small shape
or a tiny width, so the times they print there say nothing of the card.
Every row is printed as a JSON line; ``--out`` also writes the tool's
report as JSON. Nothing is written into ``results/`` (the TPU's record).

This module holds what the tools share: the timing of an int4 arm with its
weights from device memory and from L2, the verdict rule, the report, the
command line, and the registry of the tools' own kernels and launch
counters (``probe_kernels``: P1-P5). Nothing here runs CUDA work or builds
a kernel at import.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from audax_torch.utils.profiling import slope_timed

__all__ = ["L2_BYTES", "KEEP_RATIO", "device_name", "hbm_copies",
           "arm_times", "arm_row", "verdict", "report", "cli",
           "kernel_operands", "split_half_shape", "current_arm",
           "probe_kernels",
           "reset_probe_launches", "probe_launch_counts"]

#: the H100's L2 cache; timed weights cycle over copies of more than twice
#: this, so every call reads its weights from device memory (HBM3), as a
#: decode step does once the step's other weights have evicted them
L2_BYTES = 50 * 10 ** 6
#: a candidate is kept when it takes less than this share of the current
#: kernel's time (``tools/int4_plane_probe.py``'s rule, used by every tool)
KEEP_RATIO = 0.85
#: slope lengths and repeats on the card; on the CPU a short rehearsal
_CUDA_TIMING = ((100, 1100), 5)
_CPU_TIMING = ((2, 12), 2)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def hbm_copies(tensors: Sequence[torch.Tensor]) -> list:
    """Copies of ``tensors`` (as tuples) totalling more than twice the L2
    on a CUDA device; on the CPU (or with no tensors) the tensors
    themselves, once."""
    if not tensors or not tensors[0].is_cuda:
        return [tuple(tensors)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors)
            for _ in range(2 * L2_BYTES // nbytes + 1)]


def arm_times(fn: Callable, x: torch.Tensor,
              weights: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """(seconds per call with the weights from device memory, seconds per
    call with one copy warm in L2) of ``fn(x, *weights)``, slope-timed on
    ``x``'s device. The cold arm's closure takes the next copy at each
    call; on the card the shorter run reads every copy at least once."""
    (n1, n2), repeats = _CUDA_TIMING if x.is_cuda else _CPU_TIMING
    copies = hbm_copies(weights)
    it = itertools.cycle(copies)
    dev = x.device if x.is_cuda else None
    lo = max(n1, len(copies)) if x.is_cuda else n1
    cold = slope_timed(lambda: fn(x, *next(it)), (), iters=(lo, lo + n2 - n1),
                       repeats=repeats, device=dev)
    del copies, it
    warm = slope_timed(lambda: fn(x, *weights), (), iters=(n1, n2),
                       repeats=repeats, device=dev)
    return cold, warm


def arm_row(arm: str, shape, cold: float, warm: float, nbytes: int,
            **extra) -> dict:
    """One timed arm: microseconds from HBM and L2-warm, the weight bytes
    it streams (packed values and scales) and their rate from HBM."""
    return {"arm": arm, "shape": list(shape), "us": 1e6 * cold,
            "us_l2": 1e6 * warm, "bytes": int(nbytes),
            "gb_s": nbytes / cold / 1e9, **extra}


def verdict(t_candidate: float, t_current: float) -> str:
    return "keep" if t_candidate < KEEP_RATIO * t_current else "reject"


def report(tool: str, dev: torch.device, rows: Sequence[dict], verdict_: str,
           out: Optional[str] = None, **extra) -> dict:
    """Print every row as a JSON line and return the tool's report; write
    it to ``out`` as JSON when given."""
    for row in rows:
        print(json.dumps(row), flush=True)
    rep = {"tool": tool, "device": device_name(dev), "rows": list(rows),
           "verdict": verdict_, **extra}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(rep, fh, indent=1)
    return rep


def cli(main: Callable, argv=None, modes: Sequence[str] = ()) -> dict:
    """``--device`` (default: the CUDA card) and ``--out``; ``modes`` adds
    a positional mode, the first one the default."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    if modes:
        parser.add_argument("mode", nargs="?", choices=modes,
                            default=modes[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu: the plain "
                             "versions at a small shape")
    parser.add_argument("--out", default=None,
                        help="write the report here as JSON")
    args = parser.parse_args(argv)
    kw = {"device": args.device, "out": args.out}
    if modes:
        kw["mode"] = args.mode
    return main(**kw)


def kernel_operands(who: str, x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, packed_dtype: torch.dtype) -> int:
    """Raise unless x (float32 or bfloat16), ``packed`` (of
    ``packed_dtype``) and float32 ``scales`` lie on one CUDA device, with
    ``packed`` and ``scales`` contiguous; returns x's dtype code for the
    kernels' C entry points (0 float32, 1 bfloat16)."""
    if not (x.is_cuda and packed.is_cuda and scales.is_cuda
            and x.device == packed.device == scales.device):
        raise ValueError(f"{who}: every operand must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if packed.dtype != packed_dtype or scales.dtype != torch.float32:
        raise ValueError(f"{who}: weights must be {packed_dtype} and scales "
                         f"float32, got {packed.dtype} / {scales.dtype}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{who}: weights and scales must be contiguous")
    return 0 if x.dtype == torch.float32 else 1


def split_half_shape(who: str, x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor) -> Tuple[int, int, int]:
    """(K, N, group) of x [..., K] @ K9-packed [K/2, N] with scales
    [G, N]; raises when the shapes do not match."""
    if packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{who}: packed [K/2, N] and scales [G, N] expected")
    kh, n = packed.shape
    k_dim, num_g = 2 * kh, scales.shape[0]
    if (x.shape[-1] != k_dim or scales.shape[1] != n or num_g % 2
            or k_dim % num_g):
        raise ValueError(f"{who}: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} and scales "
                         f"{tuple(scales.shape)} do not match")
    return k_dim, n, k_dim // num_g


def current_arm(dev: torch.device, k_dim: int, group: int = 128) -> str:
    """What serves a tool's "current" arm (``ops.int4_matmul.int4_matmul``
    at M = 8): on the card the K9 body ``ops/int4_matmul.py:BODIES`` gives
    [8, K] x [K/2, N] at ``group``, on the CPU K9's plain version."""
    from audax_torch.ops import int4_matmul as i4
    if dev.type != "cuda":
        return "K9 plain version (int4_matmul_plain)"
    body = i4.int4_body(k_dim, group)
    return f"K9 {body} body ({i4.BODIES[body][0]})"


def probe_kernels() -> Dict[str, tuple]:
    """The tools' kernels: name -> (CUDA wrapper, plain version)."""
    from audax_torch.tools import (attn_headfold_probe, int4_layout_ab,
                                   int4_plane_probe, int4_unpack_probe,
                                   w4a8_probe)
    return {
        "flash_forward_fold": (attn_headfold_probe.fold_fwd_cuda,
                               attn_headfold_probe.fold_fwd_plain),
        "int4_word_matmul": (int4_layout_ab.int4_matmul_v2_cuda,
                             int4_layout_ab.int4_matmul_v2_plain),
        "int4_plane_matmul": (int4_plane_probe.plane_matmul_cuda,
                              int4_plane_probe.plane_matmul_plain),
        "w4a8_matmul": (w4a8_probe.w4a8_matmul_cuda,
                        w4a8_probe.w4a8_matmul_plain),
        "int4_unpack_v1": (int4_unpack_probe.unpack_v1_cuda,
                           int4_unpack_probe.unpack_v1_plain),
        "int4_unpack_v2": (int4_unpack_probe.unpack_v2_cuda,
                           int4_unpack_probe.unpack_v2_plain),
    }


def reset_probe_launches() -> None:
    for cuda_fn, plain_fn in probe_kernels().values():
        cuda_fn.launches = plain_fn.launches = 0


def probe_launch_counts() -> dict:
    """``{name: {"cuda": n, "plain": n}}`` of the tools' kernels."""
    return {name: {"cuda": c.launches, "plain": p.launches}
            for name, (c, p) in probe_kernels().items()}
