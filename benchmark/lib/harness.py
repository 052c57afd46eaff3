"""One run of one cell: the manifest, the cell's files, the metrics and the
result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` joins a
workload to a configuration file (``configs/*.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix's ``loop`` names the loop module
(``loops/<loop>.py``, its ``run(h)``); every metric is read by
``metrics/<name>.py`` (or, for ``<base>.<group>``, ``metrics/<base>.py``)
and every kernel's least time by ``rooflines/<kernel>.py``. A new cell,
mix, metric or kernel is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

BENCH = Path(__file__).resolve().parent.parent


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file
    of the part before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(path, "benchmark.metrics." +
                              stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{BENCH / 'metrics'}")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Harness:
    """What a loop needs: the cell's data, its arguments, the clock of
    set-up, and the result it hands back."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 overrides: Optional[dict] = None):
        self.t_start = time.perf_counter()
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        entry = configs[self.cell["config"]]
        self.cfg = json.loads((self.root / entry["file"]).read_text())
        self.mix = json.loads((BENCH / "traffic" /
                               f"{self.cell['traffic']}.json").read_text())
        for key, value in (overrides or {}).items():
            target, _, field = key.rpartition(".")
            (self.cfg if target == "cfg" else self.mix)[field] = value
        self.peaks = json.loads((BENCH / "peaks.json").read_text())
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        #: set by the control tool: the checks read the control in the
        #: program's place, and the program's own numbers go here
        self.control = False
        self.program_checks: Optional[dict] = None
        self.setup_s: Optional[float] = None
        if self.is_cuda:
            torch.cuda.reset_peak_memory_stats()

    @property
    def is_cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        if self.is_cuda:
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start
        self.note(f"set-up {self.setup_s:.3f} s")

    def note_parts(self, win, trace, steps: int, traced_steps: int) -> None:
        """Steps a second in each part of a traced window: what the
        profiler costs the loop."""
        if trace is not None:
            traced_s = trace.window_s
            self.note(f"untraced part {steps} steps in {win.host_s:.3f} s, "
                      f"traced part {traced_steps} in {traced_s:.3f} s: "
                      f"{steps / win.host_s:.4f} and "
                      f"{traced_steps / traced_s:.4f} steps/s")

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.is_cuda else 0

    def metrics(self, kind: str) -> list:
        return [m for m in self.manifest[kind]
                if reports(m, self.cell["name"])]

    def install_patches(self, calls) -> None:
        """Wrap the entry points of every roofline a per-layer metric of
        this cell reads."""
        for m in self.metrics("per_layer"):
            name = getattr(metric_reader(m["name"]), "ROOFLINE", None)
            if name and name not in calls.records:
                mod = importlib.import_module(f"benchmark.rooflines.{name}")
                for module, fn in mod.PATCHES:
                    calls.patch(name, module, fn, mod.record)

    def context(self, **kw) -> SimpleNamespace:
        base = dict(cfg=self.cfg, mix=self.mix, peaks=self.peaks,
                    cell=self.cell["name"], setup_s=self.setup_s, trace=None,
                    calls={}, work={}, traced_work={}, spans=None,
                    memory_peak_bytes=0)
        base.update(kw)
        return SimpleNamespace(**base)

    def result(self, ctx, checks: dict, attempted: int, failed: int) -> dict:
        """The result line; ``checks`` maps a name to (value, limit), where
        a value at or under its limit passes. ``ctx.window_s`` and
        ``ctx.work`` are the untraced part of the window (all of it with
        tracing off), ``ctx.trace`` and ``ctx.traced_work`` the traced
        part (``trace.Window``)."""
        kind = "per_layer" if self.trace else "end_to_end"
        metrics = {}
        for m in self.metrics(kind):
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        passed = failed == 0 and all(
            v is not None and lim is not None and v <= lim
            for v, lim in checks.values())
        device = {"platform": "gpu" if self.is_cuda else "cpu",
                  "kind": (torch.cuda.get_device_name() if self.is_cuda
                           else "cpu"),
                  "count": self.cell["chips"],
                  "memory_peak_bytes": ctx.memory_peak_bytes}
        out = {"correct": bool(passed), "attempted": int(attempted),
               "failed": int(failed), "metrics": metrics, "device": device}
        if self.trace and ctx.trace is not None:
            from benchmark.lib.trace import breakdown
            device["busy_s"] = ctx.trace.busy_s()
            device["window_s"] = ctx.trace.window_s
            out["breakdown"] = breakdown(ctx.trace, ctx.spans)
        if self.program_checks is not None:
            out["program"] = {k: {"value": v, "limit": lim}
                              for k, (v, lim) in self.program_checks.items()}
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}
        return out


def run(root, workload, seed, seconds, trace, device="cuda",
        overrides=None, control=False) -> dict:
    """One run of ``workload``. ``overrides`` ({"cfg.<key>" or "mix.<key>":
    value}) serve the tests, ``control`` the control tool, never
    ``run.py``."""
    h = Harness(root, workload, seed, seconds, trace, device, overrides)
    h.control = control
    loop = importlib.import_module(f"benchmark.loops.{h.mix['loop']}")
    return loop.run(h)
