"""Backlog: a queue kept full (at least a slot's worth of requests always
waiting), as when a folder of recordings is transcribed in bulk. The loop
tops the queue up and runs ``step()`` until the window closes; what counts
is the work completed inside it."""

from __future__ import annotations

from benchmark.lib import gen
from benchmark.lib.serve import Served
from benchmark.lib.trace import Calls, Profiler, Window


def run(h) -> dict:
    s = Served(h)
    s.warm_up()
    prof = Profiler(h.trace, h.device)
    h.setup_done()
    mix = h.mix
    slots, block = mix["engine"]["slots"], mix["block"]
    stream, nxt = [], 0
    calls = Calls()
    win = Window(h.seconds, prof, lambda: h.install_patches(calls), s.sync)
    while win.open():
        while s.engine.pending() < slots:
            if nxt == len(stream):
                stream += gen.requests(mix, h.seed, block, first=nxt,
                                       block=block)
            s.submit(stream[nxt], win.clock)
            nxt += 1
        s.step(win.clock, win)
    trace = win.close()
    h.note_parts(win, trace, s.work["steps"], s.traced["steps"])
    calls.restore()
    memory = h.memory_peak()
    returned = list(s.returned)
    s.free()
    checks = s.check(returned)
    ctx = h.context(window_s=win.split, trace=trace, calls=calls.records,
                    spans=s.spans, memory_peak_bytes=memory, work=s.work,
                    traced_work=s.traced)
    return h.result(ctx, checks, attempted=len(returned), failed=0)
