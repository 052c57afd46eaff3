"""Profiling and timing utilities (port of ``audax/utils/profiling.py``).

``trace()`` wraps ``torch.profiler`` and writes a Chrome trace; ``time_fn``
measures steady-state wall time per call, synchronizing the CUDA device
(PyTorch returns before the card finishes, so a host clock without a
synchronize measures the enqueue); ``slope_timed`` and
``slope_timed_chained`` measure one call's device time as the slope between
two run lengths, which cancels the fixed costs of a measurement.

On CUDA the two run lengths are two CUDA graphs captured once and replayed
between CUDA events: eager Python launches of a kernel wrapper cost several
microseconds each, so timing a 10-20 us kernel eagerly would time the host.
On the CPU the slopes are taken with ``time.perf_counter`` over eager loops.

The peaks are the NVIDIA H100 SXM data sheet's (dense, at the full 700 W
power limit): ``mfu`` reports against them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["trace", "time_fn", "flops_estimate_matmul", "slope_timed",
           "slope_timed_chained", "step_flops", "mfu", "H100_BF16_FLOPS",
           "H100_F32_FLOPS", "H100_INT8_OPS", "H100_HBM_BPS"]

#: NVIDIA H100 SXM data-sheet peaks (dense): bf16 tensor cores, float32 on
#: CUDA cores, int8 tensor cores, and HBM3 bytes/s
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_INT8_OPS = 1979e12
H100_HBM_BPS = 3.35e12


@contextlib.contextmanager
def trace(logdir: str = "artifacts/trace"):
    """``with trace("dir") as prof:`` profiles the block with
    ``torch.profiler`` (CPU, and CUDA where a card is present) and writes
    the Chrome trace to ``dir/trace.json``; ``prof.key_averages()`` sums
    the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_device(obj: Any) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor in ``obj`` (a tensor or a
    nest of tuples, lists and dict values), else None."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        for it in obj:
            dev = _cuda_device(it)
            if dev is not None:
                return dev
    return None


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Steady-state wall time per call (seconds); the CUDA device of the
    arguments or the result is synchronized before and after the run."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kwargs)
    dev = _cuda_device((args, kwargs, result))
    if dev is not None:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    if dev is not None:
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    return {"seconds_per_call": dt, "calls_per_second": 1.0 / dt}


def flops_estimate_matmul(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def step_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args)``, counted by PyTorch's
    ``FlopCounterMode`` while the call runs (it runs once). The counter
    knows PyTorch's matmuls, convolutions and attention; the port's own
    CUDA kernels, called through ``ctypes``, are invisible to it."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops_per_step: float, sec_per_step: float, n_chips: int = 1,
        peak: float = H100_BF16_FLOPS) -> Dict[str, float]:
    """{"achieved_tflops": per-card delivered TFLOP/s, "mfu_pct": % of
    ``peak`` (default: the H100's bf16 tensor-core peak; pass
    ``H100_F32_FLOPS`` for float32 work)}. Zeros without a FLOPs count."""
    if not flops_per_step or sec_per_step <= 0:
        return {"achieved_tflops": 0.0, "mfu_pct": 0.0}
    per_chip = flops_per_step / sec_per_step / max(n_chips, 1)
    return {"achieved_tflops": round(per_chip / 1e12, 2),
            "mfu_pct": round(100.0 * per_chip / peak, 2)}


def _two_length_slope(run: Callable[[int], Callable[[], Any]], iters,
                      repeats: int, dev: Optional[torch.device]) -> float:
    """``run(n)`` returns a callable that performs n calls. Best-of-
    ``repeats`` time per length; returns (t2 - t1) / (n2 - n1) seconds.

    On CUDA each length is captured once into a CUDA graph (after one eager
    warm-up call, which builds kernels and cuBLAS handles outside the
    capture) and replayed between CUDA events."""
    n1, n2 = iters
    best = []
    if dev is None:
        for n in (n1, n2):
            f = run(n)
            f()
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                f()
                ts.append(time.perf_counter() - t0)
            best.append(min(ts))
        return (best[1] - best[0]) / (n2 - n1)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(1)()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for n in (n1, n2):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run(n)()
            graph.replay()
            ts = []
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            best.append(min(ts))
            del graph
    return (best[1] - best[0]) / (n2 - n1)


def slope_timed(fn: Callable, args=(), iters=(100, 1100), repeats: int = 5,
                device: Optional[torch.device] = None) -> float:
    """Per-call time (seconds) of ``fn(*args)`` by slope timing: the same
    call repeated ``iters[0]`` and ``iters[1]`` times, best of ``repeats``
    each, (t2 - t1) / (n2 - n1).

    It runs on the CUDA device of the first CUDA tensor in ``args`` (or
    ``device``), as CUDA graphs replayed between CUDA events; with neither
    it takes ``time.perf_counter`` slopes on the host. A closure that
    cycles through copies of its operands is captured call by call, so
    each replayed call reads the copy it took at capture -- the way to
    time a kernel with its weights coming from device memory, not L2.

    The JAX version carries a perturbation of the first argument through
    its loop so that XLA cannot hoist a loop-invariant call out of it.
    Nothing here needs one: every eager call is launched, and captured, as
    written."""
    dev = device if device is not None else _cuda_device(args)
    if dev is not None and dev.type != "cuda":
        dev = None

    def run(n):
        def calls():
            for _ in range(n):
                fn(*args)
        return calls

    return _two_length_slope(run, iters, repeats, dev)


def slope_timed_chained(fn: Callable, x0: torch.Tensor, extra=(),
                        iters=(30, 230), repeats: int = 3) -> float:
    """``slope_timed`` for shape-preserving ops, each call fed the last
    one's output: ``x <- fn(x, *extra)``, so every call depends on the one
    before it. Keep ``fn``'s magnitudes stable (scale a matmul's weights by
    1/sqrt(k)) so a bf16 carry stays finite."""
    def run(n):
        def calls():
            x = x0
            for _ in range(n):
                x = fn(x, *extra)
            return x
        return calls

    return _two_length_slope(run, iters, repeats, _cuda_device((x0, extra)))
