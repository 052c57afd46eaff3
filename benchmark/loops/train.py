"""Fine-tune: one train state, built once, driven step after step through
``make_finetune_step``'s step with a fresh batch each step (rows at
different places of the audio bank, labels drawn from the seed),
featurized by the program's log-mel frontend. The batch reaches the card
as the program's own ``finetune`` loop sends it (pageable copies, which
wait for the card). The first steps (the mix's ``checked_steps``) are
set-up and warm-up, and the reference follows them; the window then runs
steps until it has lasted ``--seconds`` and ends in a synchronize. Once
it has closed, one more step through the same call, from the state the
window left, is followed by the reference from that state."""

from __future__ import annotations

import time

import torch

from benchmark.lib import gen, weights
from benchmark.lib.serve import build_libraries, whisper_config
from benchmark.lib.trace import Calls, Profiler, Spans, Window
from benchmark.reference import compare
from benchmark.reference import whisper_ref as ref


class Feed:
    """Batch ``s`` of the run: audio rows from the bank, label rows, and
    their collation by the program's ``collate_seq2seq``."""

    def __init__(self, h, frontend):
        from audax_torch.train.seq2seq import collate_seq2seq
        self.h, self.frontend, self.collate = h, frontend, collate_seq2seq
        self.dep = h.cfg["deployment"]
        n = int(h.mix["clip_seconds"][1] * gen.SAMPLE_RATE)
        bank = torch.from_numpy(gen.speech_bank(h.seed)).to(h.device)
        self.rows_of = bank.unfold(0, n, 1)          # a view, every offset

    def raw(self, s: int):
        return gen.train_batch(self.h.mix, self.h.seed, s,
                               self.dep["batch_size"], self.dep["prompt"],
                               self.h.cfg["eos_token_id"])

    def __call__(self, s: int):
        offsets, rows = self.raw(s)
        audio = self.rows_of[torch.from_numpy(offsets).to(self.h.device)]
        coll = self.collate(rows, decoder_start_id=self.dep["prompt"][0])
        dev = self.h.device
        return {"mel": self.frontend(audio),
                "decoder_input_ids": torch.from_numpy(
                    coll["decoder_input_ids"]).to(dev),
                "labels": torch.from_numpy(coll["labels"]).to(dev)}


def program_numbers(h, state, step, feed, k: int):
    """The first ``k`` steps: their losses, the first gradient as the
    optimizer got it (from its first moment after one step), and, after
    the k-th, the trainable leaves (on the host)."""
    b1 = h.cfg["deployment"]["b1"]
    losses, grad_norms = [], None
    for s in range(k):
        state, out = step(state, feed(s))
        losses.append(out["loss"])
        if s == 0:
            grad_norms = {name: float(m.float().norm()) / (1 - b1)
                          for name, m in compare.leaf_items(
                              state.opt_state.mu)}
    after = {name: t.detach().to("cpu", copy=True)
             for name, t in compare.leaf_items(state.trainable)}
    return state, {"losses": [float(x) for x in losses],
                   "grad_norms": grad_norms}, after


def late_step(h, state, step, feed, s: int):
    """Step ``s``, past the window, through the same call: its loss, the
    gradient as the optimizer got it (from the first moment before and
    after it), the change of each leaf, and the state it started from."""
    b1 = h.cfg["deployment"]["b1"]
    opt = state.opt_state
    start = {"params": compare.clone_tree(state.trainable),
             "mu": {k: t.detach().clone()
                    for k, t in compare.leaf_items(opt.mu)},
             "nu": {k: t.detach().clone()
                    for k, t in compare.leaf_items(opt.nu)}}
    state, out = step(state, feed(s))
    mu = dict(compare.leaf_items(state.opt_state.mu))
    p0 = dict(compare.leaf_items(start["params"]))
    prog = {"losses": [float(out["loss"])],
            "grad_norms": {k: float((mu[k].double() - b1 * m0.double())
                                    .norm()) / (1 - b1)
                           for k, m0 in start["mu"].items()},
            "change": {k: float((t.detach().double() - p0[k].double())
                                .norm())
                       for k, t in compare.leaf_items(state.trainable)}}
    return prog, start


def run(h) -> dict:
    from audax_torch.core.config import FineTuneConfig
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.train.seq2seq import init_finetune, make_finetune_step
    cfg, mix, dep = h.cfg, h.mix, h.cfg["deployment"]
    dev = h.device
    params = weights.make_whisper(cfg, h.seed, dtype=torch.float32,
                                  device=dev)
    build_libraries(cfg, dev)
    ftc = FineTuneConfig(batch_size=dep["batch_size"],
                         learning_rate=dep["learning_rate"],
                         warmup_steps=dep["warmup_steps"],
                         max_steps=dep["max_steps"], dtype=dep["dtype"],
                         moment_dtype=dep["moment_dtype"],
                         gradient_checkpointing=dep["remat"])
    state = init_finetune(params, ftc)
    del params
    step = make_finetune_step(whisper_config(cfg), remat=dep["remat"],
                              dtype=getattr(torch, dep["dtype"]))
    feed = Feed(h, LogMelFrontend.whisper(cfg["num_mel_bins"], device=dev))
    k = mix["checked_steps"]
    state, prog, after = program_numbers(h, state, step, feed, k)
    prof = Profiler(h.trace, h.device)
    h.setup_done()

    def sync():
        if h.is_cuda:
            torch.cuda.synchronize()

    spans, calls = Spans(), Calls()
    win = Window(h.seconds, prof, lambda: h.install_patches(calls), sync)
    s, losses, host_lens = k, [], []
    while win.open():
        t0 = win.clock.now()
        batch = feed(s)
        state, out = step(state, batch)
        spans.add("train.step", t0, win.clock.now())
        losses.append(out["loss"])
        if win.host_s is None:
            host_lens.append(int(batch["labels"].shape[1]))
        s += 1
    trace = win.close()
    h.note_parts(win, trace, len(host_lens), len(losses) - len(host_lens))
    took = sorted(1e3 * (b - a) for _, a, b in spans.items)
    if took:
        h.note(f"step spans (host): median {took[len(took) // 2]:.2f} ms, "
               f"p90 {took[int(0.9 * (len(took) - 1))]:.2f}, "
               f"max {took[-1]:.2f}")
    calls.restore()
    memory = h.memory_peak()
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    late, late_start = late_step(h, state, step, feed, s)
    del state, step
    if h.is_cuda:
        torch.cuda.empty_cache()
    checks = check(h, feed, prog, after, late, late_start, s)
    ctx = h.context(window_s=win.host_s, trace=trace, calls=calls.records,
                    spans=spans, memory_peak_bytes=memory,
                    work={"train_label_lens": host_lens,
                          "batch": dep["batch_size"]})
    return h.result(ctx, checks, attempted=len(losses), failed=failed)


def check(h, feed, prog: dict, after: dict, late: dict, late_start: dict,
          s: int) -> dict:
    """The reference follows the checked steps from the same weights and
    batches, and step ``s`` from the program's state before it
    (``reference/compare.py``). With the control, the control's numbers
    are the ones held against the limits."""
    ref.exact()
    cfg, dev = h.cfg, h.device
    k = h.mix["checked_steps"]
    start = weights.make_whisper(cfg, h.seed, dtype=torch.float32, device=dev)
    leaves0 = dict(compare.leaf_items(start))
    prog = dict(prog, change={
        name: float((after[name].to(dev) - leaves0[name]).norm())
        for name in leaves0})

    def batch(i):
        offsets, rows = feed.raw(i)
        return feed.rows_of[torch.from_numpy(offsets).to(dev)], rows

    batches = [batch(i) for i in range(k)]
    moments = (late_start["mu"], late_start["nu"])

    def follow(low=ref.FULL):
        first = compare.reference_steps(start, cfg, batches, low)
        last = compare.reference_steps(late_start["params"], cfg, [batch(s)],
                                       low, count0=s, moments=moments)
        return first, last

    t = time.perf_counter()
    refr, ref_late = follow()
    h.note(f"reference over {k} steps and step {s}: "
           f"{time.perf_counter() - t:.2f} s")
    h.note(f"leaves compared for the change: "
           f"{len(compare.moved_leaves(refr))} of {len(refr['grad_norms'])}"
           f" (step {s}: {len(compare.moved_leaves(ref_late))})")
    nums = dict(compare.train_numbers(prog, refr),
                **compare.train_numbers(late, ref_late, "late_"))
    if h.control:
        first, last = follow(ref.Lower(*ref.CONTROL[cfg["deployment"]
                                                    ["dtype"]]))
        h.program_checks = {n: (v, cfg["limits"][n]) for n, v in nums.items()}
        nums = dict(compare.train_numbers(first, refr),
                    **compare.train_numbers(last, ref_late, "late_"))
    return {name: (value, cfg["limits"][name]) for name, value in nums.items()}
