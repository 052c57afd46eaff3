"""Continuous batching: slot-refill serving over a ragged decode batch (port
of ``audax/infer/continuous.py``: ``Result``, ``_SlotEngine``,
``ContinuousBatcher``, ``_advance``).

Fixed-batch decoding convoys every request behind the slowest one. Here the
decode loop runs in chunks of up to ``steps_per_sync`` ragged steps over
PER-SLOT positions (``models/whisper.py:decode_step_ragged``), and between
chunks the host refills finished slots with queued requests while their
neighbours keep decoding:

  * the device state is fixed-shape: [slots] caches, a [slots] position
    vector, token rows of ``max_len``;
  * an admit featurizes and encodes every waiting request that has a free
    slot in one batch and installs each into its slot by indexed
    assignment (cross-attention K/V rows, prompt row, counters). The JAX
    package's one-hot gather+select and power-of-two admit buckets existed
    to avoid a TPU scatter and recompiles; PyTorch runs eagerly and writes
    in place. The self-attention cache is NOT cleared on refill: entries
    of the previous occupant sit at positions the new request has not
    reached, unreachable under its per-slot causal mask, and are
    overwritten as it advances;
  * a chunk is a Python loop of ragged steps that stops early once every
    slot is done (one host read of the ``done`` flags per step); the host
    then reads one small [slots, 4] array, and token rows only when a
    request finished.

Weights may be float, int8 or int4 trees (``models/quantize.py``); with
``kv_quant`` both caches are int8 (``QuantKV``). On the card the path runs
kernels K1 (log-mel), K2 (encoder attention), K3 (its int8 arm with
``kv_quant``) and, for int4 trees, K9.

The engine lives on one device: ``device=None`` is the CUDA card (raising
without one); ``device="cpu"`` runs the plain PyTorch versions. Tensor
parallelism (``mesh``) waits for the parallelism slice, and the two-tower
``ContinuousGenerator`` for the music slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.models.whisper import (decode_step_ragged, encode,
                                        init_kv_cache, precompute_cross_kv,
                                        tree_map)
from audax_torch.ops import native
from audax_torch.symbolic.tokenizer import WhisperTokenizer

__all__ = ["ContinuousBatcher", "Result"]


@dataclass
class Result:
    request_id: str
    text: str
    tokens: List[int]
    avg_logprob: float
    audio_seconds: float


def _advance(st: dict, nxt: torch.Tensor, logits: torch.Tensor, *,
             p_len: int, eos_id: int, bidx: torch.Tensor) -> None:
    """Post-logits bookkeeping of one ragged step, in place on the state
    dict ``st`` (tokens/pos/done/lengths/sum_logprob/gen_count/budget):
    write the chosen token, add its log-probability, set ``done`` on
    EOS/budget/overflow, freeze finished slots."""
    max_len = st["tokens"].shape[1]
    pos, done = st["pos"], st["done"]
    in_prompt = pos + 1 < p_len
    nxt = torch.where(done, eos_id, nxt)
    # done slots keep their last real token (no EOS written over it)
    cur = st["tokens"][bidx, pos + 1]
    st["tokens"][bidx, pos + 1] = torch.where(done, cur, nxt)

    chosen = torch.log_softmax(logits, -1).gather(1, nxt[:, None])[:, 0]
    score = ~in_prompt & ~done
    st["sum_logprob"] = st["sum_logprob"] + torch.where(score, chosen, 0.0)
    gen_count = st["gen_count"] + score.long()
    st["gen_count"] = gen_count

    newly = ~done & ((~in_prompt & (nxt == eos_id))
                     | (pos + 2 >= max_len) | (gen_count >= st["budget"]))
    done = done | newly
    st["done"] = done
    st["lengths"] = torch.where(newly, pos + 2, st["lengths"])
    # done slots freeze: pos never runs past max_len, and a later refill
    # resets the slot wholesale
    st["pos"] = torch.where(done, pos, pos + 1)


class _SlotEngine:
    """Host-side slot-refill shell: request queue, admits, chunked decode,
    harvest.

    Subclass contract: set ``window``, ``sample_rate``, ``slots``,
    ``steps_per_sync``, ``_p_len``, ``_max_len``, ``_stop_id`` and
    ``_state`` (a dict of device tensors holding at least ``tokens``,
    ``done``, ``lengths``, ``sum_logprob`` and ``gen_count``); implement
    ``_install(batch, slot_ids, budgets, extras)``, ``_chunk()`` and
    ``_text(ids)``."""

    window: int
    sample_rate: int
    slots: int
    steps_per_sync: int
    _p_len: int
    _max_len: int
    _stop_id: int

    def _init_shell(self) -> None:
        # queue entries: (request_id, samples, n_samples, budget, extra)
        self._queue: List[tuple] = []
        self._slot_req: List[Optional[str]] = [None] * self.slots
        self._slot_secs: List[float] = [0.0] * self.slots
        #: decode steps enqueued and chunks run (serving telemetry)
        self.steps_run = 0
        self.chunks_run = 0

    # ---------------------------------------------------------- intake ----
    def submit(self, request_id: str, samples: np.ndarray,
               max_new_tokens: Optional[int] = None,
               extra: tuple = ()) -> None:
        """Queue one utterance (padded/trimmed to the window).
        ``max_new_tokens`` caps THIS request's generation; the engine-level
        cap still applies. ``extra`` is handed back to ``_install``."""
        x = np.zeros(self.window, np.float32)
        s = np.asarray(samples, np.float32).reshape(-1)[: self.window]
        x[: len(s)] = s
        budget = self._max_len - self._p_len
        if max_new_tokens is not None:
            budget = min(budget, max(int(max_new_tokens), 1))
        self._queue.append((request_id, x, len(s), budget, extra))

    def cancel(self, request_id: str) -> bool:
        """Drop a not-yet-admitted request from the queue (one already in a
        slot drains normally). True if something was removed."""
        for i, entry in enumerate(self._queue):
            if entry[0] == request_id:
                del self._queue[i]
                return True
        return False

    def pending(self) -> int:
        return len(self._queue)

    def live(self) -> int:
        return sum(r is not None for r in self._slot_req)

    # ----------------------------------------------------------- serve ----
    def _admit_waiting(self) -> None:
        free = [i for i in range(self.slots) if self._slot_req[i] is None]
        n = min(len(free), len(self._queue))
        if not n:
            return
        entries = [self._queue.pop(0) for _ in range(n)]
        self._install(np.stack([e[1] for e in entries]),
                      np.asarray(free[:n], np.int64),
                      np.asarray([e[3] for e in entries], np.int64),
                      [e[4] for e in entries])
        for slot, (rid, _, n_samples, _, _) in zip(free, entries):
            self._slot_req[slot] = rid
            self._slot_secs[slot] = n_samples / self.sample_rate

    def _harvest(self) -> List[Result]:
        st = self._state
        meta = torch.stack([st["done"].float(), st["lengths"].float(),
                            st["sum_logprob"].float(),
                            st["gen_count"].float()], 1).cpu().numpy()
        finished = [i for i in range(self.slots)
                    if self._slot_req[i] is not None and meta[i, 0] > 0.5]
        if not finished:
            return []
        tokens = st["tokens"].cpu().numpy()
        out: List[Result] = []
        for i in finished:
            ids = [int(t) for t in tokens[i, self._p_len: int(meta[i, 1])]
                   if t != self._stop_id]
            out.append(Result(self._slot_req[i], self._text(ids), ids,
                              float(meta[i, 2] / max(int(meta[i, 3]), 1)),
                              self._slot_secs[i]))
            self._slot_req[i] = None
        return out

    def step(self) -> List[Result]:
        """One serving iteration: refill free slots from the queue, run one
        chunk of ragged decode steps, harvest finished requests."""
        self._admit_waiting()
        if self.live() == 0:
            return []
        self._chunk()
        self.steps_run += self.steps_per_sync
        self.chunks_run += 1
        return self._harvest()

    def run(self) -> List[Result]:
        """Serve until the queue is empty and every slot has drained."""
        out: List[Result] = []
        while self._queue or self.live():
            out.extend(self.step())
        return out

    def warmup(self) -> None:
        """Serve one full admit of ``slots`` dummy requests before the first
        real one, so the first real admit and chunk meet warm kernels and
        library heuristics. The counters are reset after."""
        for i in range(self.slots):
            self.submit(f"__warmup{i}__", np.zeros(16000, np.float32),
                        max_new_tokens=1)
        self.run()
        self.steps_run = self.chunks_run = 0

    # -- subclass hooks ---------------------------------------------------
    def _install(self, batch: np.ndarray, slot_ids: np.ndarray,
                 budgets: np.ndarray, extras: List[tuple]) -> None:
        raise NotImplementedError

    def _chunk(self) -> None:
        raise NotImplementedError

    def _text(self, ids: List[int]) -> str:
        raise NotImplementedError


class ContinuousBatcher(_SlotEngine):
    """Slot-refill batched Whisper transcription (greedy).

    Usage::

        cb = ContinuousBatcher(params, cfg, tokenizer, slots=8)
        cb.submit("req-1", samples)          # any number, any time
        for r in cb.step():                  # admit + decode chunk + harvest
            print(r.request_id, r.text)
        results = cb.run()                   # drain everything
    """

    def __init__(self, params, cfg: WhisperConfig,
                 tokenizer: WhisperTokenizer, *,
                 slots: int = 8, window_seconds: float = 30.0,
                 lang: str = "en", max_new_tokens: int = 224,
                 steps_per_sync: int = 64, dtype=torch.float32,
                 kv_quant: bool = False, mesh=None,
                 suppress_blank: bool = False, suppress_tokens="-1",
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError("ContinuousBatcher(mesh=...) arrives "
                                      "with the parallelism slice of the port")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.slots = slots
        self.dtype = dtype
        self.kv_quant = kv_quant
        self.steps_per_sync = steps_per_sync
        # the engine's own device copy (a no-op for params already there),
        # detached: serving records no graph
        self.params = tree_map(lambda t: t.detach().to(self.device), params)
        self.frontend = LogMelFrontend.whisper(cfg.n_mels, device=self.device)
        self.sample_rate = self.frontend.cfg.sample_rate
        self.window = int(window_seconds * self.sample_rate)
        # fail fast: cross-KV slots are sized from cfg.n_audio_ctx, admits
        # from the window's mel frames
        enc_len = self.frontend.num_frames(self.window) // 2
        if enc_len != cfg.n_audio_ctx:
            raise ValueError(
                f"window_seconds={window_seconds} gives {enc_len} encoder "
                f"positions but cfg.n_audio_ctx={cfg.n_audio_ctx}; pass the "
                f"window matching the model's audio context "
                f"({cfg.n_audio_ctx * 2 * self.frontend.cfg.hop_length / self.sample_rate:.1f}s)")
        prompt = tokenizer.sot_sequence(lang=lang)
        self._p_len = len(prompt)
        self._max_len = min(self._p_len + max_new_tokens, cfg.n_text_ctx)
        self._stop_id = tokenizer.eot
        self._default_row = self._prompt_for(lang)
        # the Transcriber's SuppressTokens default ("-1" = control specials
        # + the non-speech symbol set); "" / [] = specials only, a list =
        # specials + those ids
        if suppress_tokens == "-1":
            extra = tokenizer.non_speech_tokens()
        elif suppress_tokens:
            extra = [int(i) for i in suppress_tokens]
        else:
            extra = []
        self._suppress = torch.tensor(sorted(
            set([i for i in tokenizer.special_ids() if i != tokenizer.eot]
                + list(extra))), dtype=torch.long, device=self.device)
        # whisper's SuppressBlank (' ' + EOT at the first generated
        # position); opt-in here, as in the JAX engine
        self._first_suppress = (torch.tensor(
            sorted(set(tokenizer.encode(" ") + [tokenizer.eot])),
            dtype=torch.long, device=self.device) if suppress_blank else None)
        self._state = self._init_state()
        self._init_shell()

    def _init_state(self) -> dict:
        cfg, b, dev = self.cfg, self.slots, self.device
        long = dict(dtype=torch.long, device=dev)
        return {
            "cache": init_kv_cache(cfg, b, self._max_len, self.dtype,
                                   device=dev, quant=self.kv_quant),
            # cross-attention K/V slots: the same layout over the encoder
            "cross_kv": init_kv_cache(cfg, b, cfg.n_audio_ctx, self.dtype,
                                      device=dev, quant=self.kv_quant),
            "tokens": torch.zeros(b, self._max_len, **long),
            "pos": torch.zeros(b, **long),              # per-slot depth
            "done": torch.ones(b, dtype=torch.bool, device=dev),  # all free
            "lengths": torch.full((b,), self._max_len, **long),
            "sum_logprob": torch.zeros(b, device=dev),
            "gen_count": torch.zeros(b, **long),
            "budget": torch.full((b,), self._max_len, **long),
        }

    def _prompt_for(self, lang: str) -> np.ndarray:
        """[max_len] token row opening with the sot sequence for ``lang``
        (every language shares the sot-sequence length)."""
        prompt = self.tokenizer.sot_sequence(lang=lang)
        if len(prompt) != self._p_len:
            raise ValueError(f"sot sequence for {lang!r} has {len(prompt)} "
                             f"tokens, the engine's {self._p_len}")
        row = np.zeros(self._max_len, np.int64)
        row[: self._p_len] = prompt
        return row

    def submit(self, request_id: str, samples: np.ndarray,
               max_new_tokens: Optional[int] = None,
               lang: Optional[str] = None, extra: tuple = ()) -> None:
        """``lang`` overrides the engine default for THIS request: its slot
        decodes under that language's sot prompt."""
        row = self._default_row if lang is None else self._prompt_for(lang)
        super().submit(request_id, samples, max_new_tokens, extra=(row,))

    @torch.inference_mode()
    def _install(self, batch, slot_ids, budgets, extras) -> None:
        """Encode the admitted requests in one batch and install each into
        its slot (indexed writes into the device state)."""
        st = self._state
        mels = self.frontend(batch)
        enc = encode(self.params, self.cfg, mels, self.dtype)
        new = precompute_cross_kv(self.params, self.cfg, enc,
                                  quant=self.kv_quant)
        slots = torch.from_numpy(slot_ids).to(self.device)
        for full, rows in zip(st["cross_kv"], new):
            full[:, slots] = rows.to(full.dtype)
        rows = np.stack([e[0] if e else self._default_row for e in extras])
        st["tokens"][slots] = torch.from_numpy(rows).to(self.device)
        st["pos"][slots] = 0
        st["done"][slots] = False
        st["lengths"][slots] = self._max_len
        st["sum_logprob"][slots] = 0.0
        st["gen_count"][slots] = 0
        st["budget"][slots] = torch.from_numpy(budgets).to(self.device)

    @torch.inference_mode()
    def _chunk(self) -> None:
        """Up to ``steps_per_sync`` ragged decode steps, stopping once every
        slot is done (the JAX ``_decode_chunk``)."""
        st = self._state
        bidx = torch.arange(self.slots, device=self.device)
        neg_inf = torch.finfo(torch.float32).min
        for _ in range(self.steps_per_sync):
            if bool(st["done"].all()):
                break
            pos = st["pos"]
            tok = st["tokens"][bidx, pos]
            logits, _ = decode_step_ragged(self.params, self.cfg, tok, pos,
                                           st["cache"], st["cross_kv"],
                                           self.dtype)
            logits = logits.float()
            if self._suppress.numel():
                logits[:, self._suppress] = neg_inf
            if self._first_suppress is not None:
                # SuppressBlank per slot: each request hits its own first
                # generated position
                banned = logits.clone()
                banned[:, self._first_suppress] = neg_inf
                logits = torch.where((pos + 1 == self._p_len)[:, None],
                                     banned, logits)
            in_prompt = pos + 1 < self._p_len
            nxt = torch.where(in_prompt, st["tokens"][bidx, pos + 1],
                              logits.argmax(-1))
            _advance(st, nxt, logits, p_len=self._p_len,
                     eos_id=self._stop_id, bidx=bidx)

    def _text(self, ids) -> str:
        return self.tokenizer.decode(ids)

    def warmup(self) -> None:
        """Build the CUDA kernels (on the card), then serve the dummy
        requests of ``_SlotEngine.warmup``."""
        if self.device.type == "cuda":
            native.build()
        super().warmup()
