"""Build and load the hand-written CUDA kernels of ``audax_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds, not minutes.

Libraries go to ``audax_torch/build/`` (listed in ``.gitignore``), named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags: an
edited source or header builds anew, an unchanged one is reused. One source
may make more than one library: ``flash_bwd.cu`` (and its tensor-core
twins ``flash_bwd_sm90.cu`` and ``flash_bwd_tf32x3.cu``) is built once
with ``-DAUDAX_FLASH_BWD_DQ`` (K7) and once with ``-DAUDAX_FLASH_BWD_DKV``
(K8), so that its two kernels' many tile instantiations compile in
parallel; ``int4_matmul_mma.cu`` makes K9's tensor-core body and, with
``-DAUDAX_INT4_V1``, ``-DAUDAX_INT4_V2``, ``-DAUDAX_INT4_W4A8`` and
``-DAUDAX_INT4_WORD``, the int4 tool kernels P5 v1, P5 v2, P4 and the word
kernel of P2 and P3 redesigned on its skeleton.
``build()`` starts one ``nvcc`` per missing library and waits for all of
them, so the kernels compile in parallel.

The wrappers in ``ops/fused_mel.py``, ``ops/direct_mel.py`` (K4, K5 and
the FFT log-mel body ``log_mel_fft.cu`` of K1's, K4's and K5's tiers),
``ops/attention.py`` (K2's three bodies, ``flash_fwd.cu``,
``flash_fwd_tf32x3.cu`` and ``flash_fwd_sm90.cu``, the last two of which
also serve the head-fold probe
``tools/attn_headfold_probe.py``, and K7/K8's three, ``flash_bwd.cu``,
``flash_bwd_tf32x3.cu`` and ``flash_bwd_sm90.cu``, and K3/K6's two,
``decode_attention_sm90.cu`` and ``decode_attention.cu``),
``ops/int4_matmul.py``
(K9's two bodies, ``int4_matmul_mma.cu`` and ``int4_matmul.cu``) and the int4
experiment tools (``tools/int4_layout_ab.py``, ``tools/int4_plane_probe.py``,
``tools/w4a8_probe.py``, ``tools/int4_unpack_probe.py``; their
tensor-core bodies from ``int4_matmul_mma.cu``) call
``library(name)`` the first time they launch on a CUDA tensor. A CUDA host
without ``nvcc`` raises there; a CPU tensor never reaches this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "build", "library", "lib_path", "check",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

#: library name -> source file under csrc/
KERNEL_SOURCES = {
    "log_mel_overlap": "log_mel_overlap.cu",
    "log_mel_direct": "log_mel_direct.cu",
    "log_mel_fft": "log_mel_fft.cu",
    "flash_fwd": "flash_fwd.cu",
    "flash_fwd_sm90": "flash_fwd_sm90.cu",
    "flash_fwd_tf32x3": "flash_fwd_tf32x3.cu",
    "flash_bwd_dq": "flash_bwd.cu",
    "flash_bwd_dkv": "flash_bwd.cu",
    "flash_bwd_dq_sm90": "flash_bwd_sm90.cu",
    "flash_bwd_dkv_sm90": "flash_bwd_sm90.cu",
    "flash_bwd_dq_tf32x3": "flash_bwd_tf32x3.cu",
    "flash_bwd_dkv_tf32x3": "flash_bwd_tf32x3.cu",
    "decode_attention": "decode_attention.cu",
    "decode_attention_sm90": "decode_attention_sm90.cu",
    "int4_matmul": "int4_matmul.cu",
    "int4_matmul_mma": "int4_matmul_mma.cu",
    "int4_unpack_v1_mma": "int4_matmul_mma.cu",
    "int4_unpack_v2_mma": "int4_matmul_mma.cu",
    "w4a8_matmul_mma": "int4_matmul_mma.cu",
    "int4_word_matmul_mma": "int4_matmul_mma.cu",
    "int4_word_matmul": "int4_word_matmul.cu",
    "w4a8_matmul": "w4a8_matmul.cu",
    "int4_unpack_variants": "int4_unpack_variants.cu",
}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: C entry points of each library: name -> (argtypes, restype). Every
#: pointer and the stream are c_void_p, so ctypes never cuts them to 32 bits.
SIGNATURES = {
    "log_mel_overlap": {
        "log_mel_overlap_smem_bytes": ([_I] * 5, _LL),
        "log_mel_overlap_f32": ([_P, _I, _LL, _I, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "log_mel_direct": {
        "log_mel_direct_f32": ([_I, _P, _LL, _I, _I, _LL, _I, _P, _P, _I, _P,
                                _P, _I, _I, _I, _F, _P], _I),
    },
    "log_mel_fft": {
        "log_mel_fft_f32": ([_P, _LL, _I, _I, _LL, _I, _P, _P, _P, _P, _P,
                             _I, _I, _F, _P], _I),
    },
    "flash_fwd": {
        "flash_fwd": ([_P] * 5 + [_I] * 7 + [_F] + [_I] * 5 + [_P], _I),
    },
    "flash_fwd_sm90": {
        "flash_fwd_sm90": ([_P] * 5 + [_I] * 7 + [_F] + [_I] * 4 + [_P], _I),
    },
    "flash_fwd_tf32x3": {
        "flash_fwd_tf32x3": ([_P] * 5 + [_I] * 7 + [_F] + [_I] * 4 + [_P],
                             _I),
    },
    "flash_bwd_dq": {
        "flash_bwd_dq": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    },
    "flash_bwd_dkv": {
        "flash_bwd_dkv": ([_P] * 8 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    },
    "flash_bwd_dq_sm90": {
        "flash_bwd_dq_sm90": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
                              _I),
    },
    "flash_bwd_dkv_sm90": {
        "flash_bwd_dkv_sm90": ([_P] * 8 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
                               _I),
    },
    "flash_bwd_dq_tf32x3": {
        "flash_bwd_dq_tf32x3": ([_P] * 7 + [_I] * 6 + [_F] + [_I] * 3
                                + [_P], _I),
    },
    "flash_bwd_dkv_tf32x3": {
        "flash_bwd_dkv_tf32x3": ([_P] * 8 + [_I] * 6 + [_F] + [_I] * 3
                                 + [_P], _I),
    },
    "decode_attention": {
        "decode_smem": ([_I, _I, _I], _LL),
        "decode_attention_stacked": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _F, _I, _P], _I),
        "decode_attention_stacked_q8": ([_P] * 7 + [_I] * 7 + [_F, _I, _P],
                                        _I),
    },
    "decode_attention_sm90": {
        "decode_sm90_smem": ([_I] * 10, _LL),
        "decode_sm90": ([_P] * 7 + [_I] * 8 + [_F, _I, _I, _P], _I),
    },
    "int4_matmul": {
        "int4_matmul_splits": ([_I, _I, _I], _I),
        "int4_matmul": ([_P] * 5 + [_I] * 6 + [_P, _I, _I, _P], _I),
    },
    "int4_matmul_mma": {
        "int4_matmul_mma": ([_P] * 4 + [_I] * 5 + [_P, _I, _I, _P], _I),
    },
    "int4_unpack_v1_mma": {
        "int4_unpack_v1_mma": ([_P] * 4 + [_I] * 6 + [_P], _I),
    },
    "int4_unpack_v2_mma": {
        "int4_unpack_v2_mma": ([_P] * 4 + [_I] * 6 + [_P], _I),
    },
    "w4a8_matmul_mma": {
        "w4a8_matmul_mma": ([_P] * 4 + [_I] * 5 + [_P], _I),
    },
    "int4_word_matmul_mma": {
        "int4_word_matmul_mma": ([_P] * 4 + [_I] * 5 + [_P], _I),
    },
    "int4_word_matmul": {
        "int4_word_matmul_splits": ([_I, _I, _I], _I),
        "int4_word_matmul": ([_P] * 5 + [_I] * 6 + [_P], _I),
    },
    "w4a8_matmul": {
        "w4a8_matmul_splits": ([_I, _I, _I], _I),
        "w4a8_matmul": ([_P] * 6 + [_I] * 6 + [_P], _I),
    },
    "int4_unpack_variants": {
        "int4_unpack_v1_splits": ([_I] * 3, _I),
        "int4_unpack_v1": ([_P] * 5 + [_I] * 6 + [_P], _I),
        "int4_unpack_v2": ([_P] * 4 + [_I] * 5 + [_P], _I),
    },
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: library name -> the macros that select its part of a shared source
DEFINES = {"flash_bwd_dq": ("-DAUDAX_FLASH_BWD_DQ",),
           "flash_bwd_dkv": ("-DAUDAX_FLASH_BWD_DKV",),
           "flash_bwd_dq_sm90": ("-DAUDAX_FLASH_BWD_DQ",),
           "flash_bwd_dkv_sm90": ("-DAUDAX_FLASH_BWD_DKV",),
           "flash_bwd_dq_tf32x3": ("-DAUDAX_FLASH_BWD_DQ",),
           "flash_bwd_dkv_tf32x3": ("-DAUDAX_FLASH_BWD_DKV",),
           "int4_unpack_v1_mma": ("-DAUDAX_INT4_V1",),
           "int4_unpack_v2_mma": ("-DAUDAX_INT4_V2",),
           "w4a8_matmul_mma": ("-DAUDAX_INT4_W4A8",),
           "int4_word_matmul_mma": ("-DAUDAX_INT4_WORD",)}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of audax_torch are "
                       "built from csrc/ at first use and need the CUDA "
                       "toolkit's compiler on PATH")


def lib_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built: keyed by a hash of its
    source, the shared headers and the flags."""
    src = (CSRC / KERNEL_SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = NVCC_FLAGS + DEFINES.get(name, ())
    digest = hashlib.sha256(src + headers
                            + " ".join(flags).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library that is not built yet, all at once.

    Returns ``{name: report}`` for the libraries compiled by this call: a
    first line ``nvcc <name>: <seconds> s`` (the compile's wall time, all
    running at once), then nvcc's -Xptxas -v report (registers, shared
    memory and spills per kernel). Raises with the compiler's output when
    one fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc, *NVCC_FLAGS, *DEFINES.get(n, ()), "-o", str(tmp),
               str(CSRC / KERNEL_SOURCES[n])]
        with open(log, "w") as fh:       # a file, not a pipe: never fills
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        procs[n] = (proc, tmp, out, log)
    seconds, pending = {}, set(procs)
    while pending:
        for n in [n for n in pending if procs[n][0].poll() is not None]:
            seconds[n] = time.perf_counter() - t0
            pending.discard(n)
        if pending:
            time.sleep(0.05)
    reports, failed = {}, []
    for n, (proc, tmp, out, log) in procs.items():
        text = log.read_text()
        log.unlink()
        if proc.returncode != 0:      # the head: the first errors
            failed.append(f"--- {n} (exit {proc.returncode}, "
                          f"{seconds[n]:.2f} s)\n{text[:4000]}")
            continue
        os.replace(tmp, out)             # atomic: a reader never sees half
        reports[n] = f"nvcc {n}: {seconds[n]:.2f} s\n{text}"
    if failed:
        built = "; ".join(r.splitlines()[0] for r in reports.values())
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)
                           + f"\n(built: {built})")
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its C signatures set, built first
    if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")

