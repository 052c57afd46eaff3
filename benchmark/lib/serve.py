"""Serving cells: set-up of the continuous-batching engine, the check of its
transcripts against the reference, and what both loops share.

The program under test is ``audax_torch.infer.continuous.ContinuousBatcher``
driven through its public ``submit``/``step``/``pending``/``live``; the
harness never reads its private state.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import gen, weights
from benchmark.lib.trace import Clock, Spans


def whisper_config(cfg: dict):
    from audax_torch.core.config import WhisperConfig
    return WhisperConfig(
        n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
        d_model=cfg["d_model"], encoder_layers=cfg["encoder_layers"],
        decoder_layers=cfg["decoder_layers"],
        heads=cfg["encoder_attention_heads"], vocab_size=cfg["vocab_size"],
        n_text_ctx=cfg["max_target_positions"])


CORPUS = ["the quick brown fox jumps over the lazy dog",
          "hello world how are you today",
          "speech recognition on a graphics card",
          "one two three four five six seven eight nine ten"] * 4


def tokenizer(cfg: dict):
    """A Whisper tokenizer of the published layout: a BPE trained on a few
    sentences, padded with filler tokens to the 50,257-token base."""
    from audax_torch.symbolic.bpe import BPE, train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer
    bpe = train_bpe(CORPUS, vocab_size=400)
    vocab = dict(bpe.vocab)
    for i in range(len(vocab), cfg["eos_token_id"]):
        vocab[f"<unused{i}>"] = i
    tok = WhisperTokenizer.for_vocab_size(BPE(vocab, bpe.merges),
                                          cfg["vocab_size"])
    dep = cfg["deployment"]
    if tok.sot_sequence(lang=dep.get("lang", "en")) != dep["prompt"]:
        raise RuntimeError("the tokenizer's start sequence is not the "
                           "configuration's prompt")
    return tok


def build_libraries(cfg: dict, device) -> None:
    if torch.device(device).type == "cuda":
        from audax_torch.ops import native
        native.build(cfg["deployment"]["libraries"])


class Served:
    """One serving run: the engine, its traffic and what the harness saw."""

    def __init__(self, h):
        self.h = h
        cfg, mix = h.cfg, h.mix
        dep = cfg["deployment"]
        from audax_torch.infer.continuous import ContinuousBatcher
        self.params = weights.make_whisper(cfg, h.seed, dtype=torch.bfloat16,
                                           device=h.device)
        build_libraries(cfg, h.device)
        self.engine = ContinuousBatcher(
            self.params, whisper_config(cfg), tokenizer(cfg),
            slots=mix["engine"]["slots"],
            window_seconds=dep["window_seconds"], lang=dep["lang"],
            max_new_tokens=dep["max_new_tokens"],
            steps_per_sync=mix["engine"]["steps_per_sync"],
            dtype=torch.bfloat16, kv_quant=dep["kv_quant"],
            suppress_tokens=dep["suppress_tokens"], device=h.device)
        self.bank = gen.speech_bank(h.seed)
        self.spans = Spans()
        self.records: Dict[int, dict] = {}
        self.waiting = 0                  # submitted, not yet admitted
        self.returned: List[dict] = []
        #: work by part of the window (``trace.Window``): the untraced
        #: part's, read with the harness's clock, and the traced part's
        self.work = {"steps": 0, "admitted": [], "completed": []}
        self.traced = {"steps": 0, "completed": []}

    def warm_up(self) -> None:
        """One full admit and one chunk of the cell's own traffic (a stream
        of its own, not the window's), then drained, so the window starts
        from an empty engine with every kernel and shape warm (a drain that
        has not ended in two minutes is left; the window then shows it)."""
        slots = self.h.mix["engine"]["slots"]
        for r in gen.requests(self.h.mix, self.h.seed + 1, slots):
            self.engine.submit(f"warm{r.index}", gen.clip(self.bank, r),
                               max_new_tokens=r.budget)
        self.engine.step()
        deadline = time.perf_counter() + 120.0
        while (self.engine.pending() or self.engine.live()) and \
                time.perf_counter() < deadline:
            self.engine.step()
        self.sync()

    def sync(self) -> None:
        if self.h.is_cuda:
            torch.cuda.synchronize()

    def submit(self, r: gen.Request, clock: Clock) -> None:
        t = clock.now()
        self.engine.submit(str(r.index), gen.clip(self.bank, r),
                           max_new_tokens=r.budget)
        self.spans.add("traffic.submit", t, clock.now())
        self.records[r.index] = {"tokens": None, "audio_s": r.audio_seconds,
                                 "budget": r.budget, "request": r}
        self.waiting += 1

    def step(self, clock: Clock, window) -> None:
        """One public ``step()``: admissions are read from ``pending()``,
        completions from its results, each counted in the part of
        ``window`` (``trace.Window``) it fell in."""
        t0 = clock.now()
        out = self.engine.step()
        t1 = clock.now()
        self.spans.add("engine.step", t0, t1)
        admitted = self.waiting - self.engine.pending()
        self.waiting -= admitted
        if t0 < window.split:
            self.work["steps"] += 1
            self.work["admitted"].append(admitted)
        elif t0 < window.end:
            self.traced["steps"] += 1
        for res in out:
            rec = self.records[int(res.request_id)]
            rec["tokens"] = list(res.tokens)
            if t1 <= window.split:
                self.work["completed"].append(rec)
            elif t1 <= window.end:
                self.traced["completed"].append(rec)
            if t1 <= window.end:
                self.returned.append(rec)

    def free(self) -> None:
        """Drop the engine's state (caches, slots) before the reference."""
        del self.engine
        if self.h.is_cuda:
            torch.cuda.empty_cache()

    def check(self, returned: List[dict]) -> dict:
        """Every returned request decoded exactly its budget; a sample
        drawn from the seed, the longest among them, against the
        reference (``reference/compare.py``)."""
        from benchmark.reference import compare
        from benchmark.reference import whisper_ref as ref
        cfg, mix = self.h.cfg, self.h.mix
        miss = sum(len(r["tokens"]) != r["budget"] for r in returned)
        rng = gen.rng_for(self.h.seed, 7)
        order = list(rng.permutation(len(returned))) if returned else []
        if returned:
            longest = max(range(len(returned)),
                          key=lambda i: len(returned[i]["tokens"]))
            order.remove(longest)
            order.insert(0, longest)
        pick, n_tok = [], 0
        for i in order:
            if n_tok >= mix["check_tokens"]:
                break
            pick.append(returned[i])
            n_tok += len(returned[i]["tokens"])
        ref.exact()
        window = int(cfg["deployment"]["window_seconds"] * gen.SAMPLE_RATE)
        audio = np.zeros((len(pick), window), np.float32)
        for j, r in enumerate(pick):
            c = gen.clip(self.bank, r["request"])
            audio[j, : len(c)] = c
        t = time.perf_counter()
        nums = compare.served_gaps(
            self.params, cfg, torch.from_numpy(audio).to(self.h.device),
            [r["tokens"] for r in pick], cfg["deployment"]["prompt"],
            low=ref.Lower(*ref.CONTROL[cfg["deployment"]["dtype"]]),
            control=self.h.control) if pick else []
        self.h.note(f"reference over {len(pick)} requests, {n_tok} tokens: "
                    f"{time.perf_counter() - t:.2f} s")
        limit = cfg["limits"]["served_gap"]
        key = "control_gap" if self.h.control else "gap"
        if self.h.control:
            self.h.program_checks = {
                "served_gap": (max((n["gap"] for n in nums), default=None),
                               limit), "budget_miss": (miss, 0)}
        return {"served_gap": (max((n[key] for n in nums), default=None),
                               limit),
                "budget_miss": (miss, 0)}
