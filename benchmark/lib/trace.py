"""What a traced run (``--trace 1``) reads, and the harness's own spans.

* Spans: the harness's clock around its calls into the program (each
  ``step()``, each submission, each train step), kept in memory. They are
  taken in every run; end-to-end metrics read them with the profiler off.
* Device activity: ``torch.profiler`` with CUDA activity alone over the
  traced part of the window (``Window``); the raw kineto events (name,
  start, duration) are read without building the profiler's Python event
  tree.
* Calls: during the traced part the harness wraps the program's kernel
  entry points that a roofline names (``rooflines/*.py``: ``PATCHES``) and
  records the shapes of each call, so each kernel's least time is counted
  from the calls the window made.
"""

from __future__ import annotations

import bisect
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Clock:
    """Seconds since the window opened (``perf_counter``), and the epoch
    nanoseconds the profiler stamps its events with."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.epoch0 = time.time_ns()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def from_epoch_ns(self, ns: int) -> float:
        return (ns - self.epoch0) / 1e9


@dataclass
class Spans:
    items: List[Tuple[str, float, float]] = field(default_factory=list)

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))


@dataclass
class DeviceTrace:
    """Device operations of the traced window: (name, start s, end s) on
    the harness clock."""
    ops: List[Tuple[str, float, float]]
    window_s: float

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))]

    def time_of(self, names) -> Tuple[float, int]:
        """Summed seconds and count of the operations whose name holds one
        of ``names``."""
        t, n = 0.0, 0
        for name, a, b in self.ops:
            if any(s in name for s in names):
                t += b - a
                n += 1
        return t, n


class Profiler:
    """``torch.profiler`` over the window, CUDA activity only (on a CPU
    rehearsal, the CPU's operations stand in for the device's)."""

    def __init__(self, enabled: bool, device="cuda"):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
            self.prof = profile(activities=[act])
            self.prof.__enter__()

    def stop(self, clock: Clock, window_s: float) -> Optional[DeviceTrace]:
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        ops = []
        kind = (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != kind:
                continue
            a = clock.from_epoch_ns(e.start_ns())
            ops.append((e.name(), a, a + e.duration_ns() / 1e9))
        self.prof = None
        return DeviceTrace(ops, window_s)


class Window:
    """The measured window on the harness's clock. A run with tracing off
    measures it whole. A traced run measures its first half untraced,
    which the per-layer metrics taken on the host's clock read, and at
    ``split`` synchronizes, wraps the rooflines' entry points and starts
    the profiler for the second half, which the device's metrics read: the
    profiler's cost falls on the traced half alone. The profiler starts
    only there, the first time in the process: CUPTI's start, which takes
    seconds, falls between the halves, and the traced half is timed from
    the moment it has started and lasts its half all the same."""

    def __init__(self, seconds: float, profiler: "Profiler",
                 on_trace: Callable[[], None], sync: Callable[[], None]):
        self.seconds = float(seconds)
        self.split = self.seconds / 2 if profiler.enabled else self.seconds
        #: when the window closes (moved by the profiler's start)
        self.end = self.seconds
        self.prof, self.on_trace, self.sync = profiler, on_trace, sync
        #: the untraced part's end, once it has closed in a synchronize
        self.host_s: Optional[float] = None
        self.trace_t0: Optional[float] = None
        self.clock = Clock()

    def open(self) -> bool:
        """True while the window is open; past ``split`` of a traced run,
        closes the untraced part and starts the trace (once)."""
        t = self.clock.now()
        if self.prof.enabled and self.host_s is None and t >= self.split:
            self.sync()
            self.host_s = self.clock.now()
            self.on_trace()
            self.prof.start()
            self.trace_t0 = t = self.clock.now()
            self.end = self.trace_t0 + self.seconds - self.split
        return t < self.end

    def close(self) -> Optional["DeviceTrace"]:
        """Synchronize; the traced part's device operations, if any."""
        self.sync()
        if self.host_s is None:
            self.host_s = self.clock.now()
        if self.trace_t0 is None:
            return None
        return self.prof.stop(self.clock,
                              self.clock.now() - self.trace_t0)


class Calls:
    """Wraps entry points while active and records each call's shapes."""

    def __init__(self):
        self.records: Dict[str, List[dict]] = {}
        self._undo: List[Tuple[object, str, Callable]] = []

    def patch(self, key: str, module: str, name: str,
              record: Callable[..., dict]) -> None:
        mod = importlib.import_module(module)
        orig = getattr(mod, name)
        out = self.records.setdefault(key, [])

        def wrapper(*args, **kwargs):
            out.append(record(*args, **kwargs))
            return orig(*args, **kwargs)

        wrapper.__wrapped__ = orig
        setattr(mod, name, wrapper)
        self._undo.append((mod, name, orig))

    def restore(self) -> None:
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()


def breakdown(trace: DeviceTrace, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time (by name, templates cut
    at the first ``<`` or ``(``) and the longest idle gaps, each named by
    the harness span the host was in and the operation that ended it."""
    by_name: Dict[str, float] = {}
    for name, a, b in trace.ops:
        short = name.split("(")[0].split("<")[0].strip()[:120]
        by_name[short] = by_name.get(short, 0.0) + (b - a)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy_intervals()
    ends = sorted(zip(busy, busy[1:]), key=lambda w: -(w[1][0] - w[0][1]))
    starts = sorted(trace.ops, key=lambda o: o[1])
    first = [o[1] for o in starts]
    idle_gaps = []
    for (a0, b0), (a1, _) in ends[:top]:
        j = bisect.bisect_left(first, a1)
        nxt = starts[j][0] if j < len(starts) else "end"
        mid = 0.5 * (b0 + a1)
        host = next((s for s, t0, t1 in spans.items if t0 <= mid <= t1),
                    "harness")
        short = nxt.split("(")[0].split("<")[0].strip()[:80]
        idle_gaps.append((f"{host} before {short}", a1 - b0))
    return {"device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[n, s] for n, s in idle_gaps]}
