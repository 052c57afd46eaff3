"""Continuous batching: slot-refill serving over a ragged decode batch (port
of ``audax/infer/continuous.py``: ``Result``, ``_SlotEngine``,
``ContinuousBatcher``, ``_advance``, and the two-tower
``ContinuousGenerator`` with its ``_gen_admit``/``_gen_chunk``).

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

``ContinuousGenerator`` serves the music two-tower (``models/
two_tower.py``) on the same shell: an admit encodes the clips and projects
the adapter's cross-attention K/V once into the slot; a chunk step embeds
each slot's last token, fuses it through the adapter, runs one LM step
with per-slot positions (K3 over the layer-stacked cache) and samples:
greedy at temperature 0, else from the slot's own ``torch.Generator``,
reseeded from the request's ``submit(seed=)`` at admit and drawn only
while the request is live, so a request's samples depend on its seed and
depth alone (the JAX engine folds (seed, pos) into a key). An
``allowed_ids`` mask constrains every step.

The engines live on one device: ``device=None`` is the CUDA card (raising
without one); ``device="cpu"`` runs the plain PyTorch versions.

``mesh`` (a (data, model) mesh): every rank runs the same host scheduler
on the same submissions. The slots are cut over the batch axes when they
divide (``parallel/sharding.py:kv_rows``) -- each rank holds, admits into
and decodes its own block of slots -- and heads over 'model': the
``ContinuousBatcher`` takes weights already cut by ``shard_params`` (as the
JAX engine), the ``ContinuousGenerator`` cuts its LM by
``CAUSAL_LM_TP_RULES`` itself. At harvest the per-slot rows are
all-gathered over the batch axes, so every rank retires and refills the
same slots. A slot's samples come from its own generator, so cutting
slots over ranks changes no draw.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from audax_torch.core.config import WhisperConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.models.causal_lm import init_lm_cache, lm_cache_heads
from audax_torch.models.two_tower import (_allowed_mask, adapter_cross_kv,
                                          two_tower_step)
from audax_torch.models.whisper import (decode_step_ragged, encode,
                                        init_kv_cache, local_heads,
                                        precompute_cross_kv, tree_map)
from audax_torch.ops import native
from audax_torch.parallel.comm import all_gather_cat
from audax_torch.parallel.mesh import batch_group, use_mesh
from audax_torch.parallel.sharding import (CAUSAL_LM_TP_RULES, kv_rows,
                                           shard_params)
from audax_torch.symbolic.tokenizer import WhisperTokenizer

__all__ = ["ContinuousBatcher", "ContinuousGenerator", "Result",
           "Lockstep"]


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

    def _init_rows(self, mesh) -> None:
        """The slots this rank holds: a block of them when ``mesh``'s
        batch axes divide the slot count, else all (``self._rows`` None);
        ``self.local_slots`` is their count."""
        self.mesh = mesh
        self._rows = kv_rows(mesh, self.slots)
        self.local_slots = (self.slots if self._rows is None
                            else self._rows.stop - self._rows.start)

    def _mine(self, slot_ids: np.ndarray) -> np.ndarray:
        """Which of ``slot_ids`` (global) this rank holds."""
        if self._rows is None:
            return np.ones(len(slot_ids), bool)
        return (slot_ids >= self._rows.start) & (slot_ids < self._rows.stop)

    def _local_ids(self, slot_ids: np.ndarray) -> np.ndarray:
        return slot_ids - (0 if self._rows is None else self._rows.start)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """Per-slot rows of every rank (all-gathered over the batch axes
        when the slots are cut)."""
        if self._rows is None:
            return t
        return all_gather_cat(t, batch_group(self.mesh), 0)

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
        meta = self._whole(torch.stack([
            st["done"].float(), st["lengths"].float(),
            st["sum_logprob"].float(), st["gen_count"].float()], 1)
        ).cpu().numpy()
        finished = [i for i in range(self.slots)
                    if self._slot_req[i] is not None and meta[i, 0] > 0.5]
        if not finished:
            return []
        tokens = self._whole(st["tokens"]).cpu().numpy()
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

    def warmup(self, all_buckets: bool = True) -> None:
        """Serve one full admit of ``slots`` dummy requests before the first
        real one, so the first real admit and chunk meet warm kernels and
        library heuristics; ``all_buckets=False`` serves one dummy request
        (the JAX package's single-request bucket). The counters are reset
        after, and a sampling engine's default seed stream is left where
        it was, so reproducible replay does not depend on the warmup."""
        seed0 = getattr(self, "_seed_counter", None)
        for i in range(self.slots if all_buckets else 1):
            self.submit(f"__warmup{i}__", np.zeros(16000, np.float32),
                        max_new_tokens=1)
        self.run()
        self.steps_run = self.chunks_run = 0
        if seed0 is not None:
            self._seed_counter = seed0

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
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.slots = slots
        self._init_rows(mesh)
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
        cfg, b, dev = self.cfg, self.local_slots, self.device
        long = dict(dtype=torch.long, device=dev)
        heads = local_heads(self.params, cfg)
        return {
            "cache": init_kv_cache(cfg, b, self._max_len, self.dtype,
                                   device=dev, quant=self.kv_quant,
                                   heads=heads),
            # cross-attention K/V slots: the same layout over the encoder
            "cross_kv": init_kv_cache(cfg, b, cfg.n_audio_ctx, self.dtype,
                                      device=dev, quant=self.kv_quant,
                                      heads=heads),
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
        its slot (indexed writes into the device state). Under a mesh a
        rank encodes only the requests admitted into its own slots."""
        st = self._state
        mine = self._mine(slot_ids)
        if not mine.any():
            return
        batch, budgets = batch[mine], budgets[mine]
        extras = [e for e, m in zip(extras, mine) if m]
        slot_ids = self._local_ids(slot_ids[mine])
        mels = self.frontend(batch)
        with use_mesh(self.mesh):
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
        slot is done (the JAX ``_decode_chunk``). Under a mesh, over this
        rank's slots."""
        st = self._state
        bidx = torch.arange(self.local_slots, device=self.device)
        neg_inf = torch.finfo(torch.float32).min
        for _ in range(self.steps_per_sync):
            if bool(st["done"].all()):
                break
            pos = st["pos"]
            tok = st["tokens"][bidx, pos]
            with use_mesh(self.mesh):
                logits, _ = decode_step_ragged(self.params, self.cfg, tok,
                                               pos, st["cache"],
                                               st["cross_kv"], self.dtype)
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

    def warmup(self, all_buckets: bool = True) -> None:
        """Build the CUDA kernels (on the card), then serve the dummy
        requests of ``_SlotEngine.warmup``."""
        if self.device.type == "cuda":
            native.build()
        super().warmup(all_buckets)


# ---------------------------------------------------- two-tower engine ----
class ContinuousGenerator(_SlotEngine):
    """Slot-refill two-tower audio -> ABC generation with per-request
    reproducible temperature sampling. Usage::

        g = ContinuousGenerator(model, bpe=bpe, start_id=s, end_id=e)
        g.submit("req-1", samples, seed=7)
        results = g.run()
    """

    def __init__(self, model, *, bpe=None, start_id: int, end_id: int,
                 params=None, slots: int = 4, window_seconds: float = 10.0,
                 max_new_tokens: int = 256, temperature: float = 0.7,
                 steps_per_sync: int = 32, dtype=torch.float32, mesh=None,
                 allowed_ids=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.bpe = bpe
        # the engine's own device copies, detached: serving records no graph
        self.params = tree_map(lambda t: t.detach().to(self.device),
                               params if params is not None else model.params)
        if mesh is not None:
            self.params = {**self.params, "lm": shard_params(
                self.params["lm"], mesh, CAUSAL_LM_TP_RULES,
                heads=model.lm_cfg.heads)}
        self.audio_params = tree_map(lambda t: t.detach().to(self.device),
                                     model.audio_params)
        #: constrained decoding: permit only these ids (+ end_id)
        self.allowed_mask = _allowed_mask(allowed_ids, end_id,
                                          model.lm_cfg.vocab_size,
                                          self.device)
        self.slots = slots
        self._init_rows(mesh)
        self.dtype = dtype
        self.temperature = float(temperature)
        self.steps_per_sync = steps_per_sync
        self.frontend = LogMelFrontend.whisper(model.audio_cfg.n_mels,
                                               device=self.device)
        self.sample_rate = self.frontend.cfg.sample_rate
        self.window = int(window_seconds * self.sample_rate)
        self._p_len = 1
        self._max_len = 1 + max_new_tokens
        self._stop_id = end_id
        self._prompt_row = torch.zeros(self._max_len, dtype=torch.long,
                                       device=self.device)
        self._prompt_row[0] = start_id
        self._seed_counter = 0
        #: one sampling stream per slot, reseeded at each admit
        self._gens = [torch.Generator(device=self.device).manual_seed(0)
                      for _ in range(slots)]
        #: ragged decode steps actually run (a chunk stops early once every
        #: slot is done)
        self.decode_steps = 0
        # encoder positions of this window (the conv stem halves frames)
        self._state = self._init_state(self.frontend.num_frames(self.window)
                                       // 2)
        self._init_shell()

    def _init_state(self, s: int) -> dict:
        b, dev = self.local_slots, self.device
        heads = self.model.cfg.adapter_heads
        hd = self.model.lm_cfg.d_model // heads
        long = dict(dtype=torch.long, device=dev)
        with use_mesh(self.mesh):
            kv = lm_cache_heads(self.params["lm"], self.model.lm_cfg)
        return {
            "cache": init_lm_cache(self.model.lm_cfg, b, self._max_len,
                                   self.dtype, device=dev, heads=kv),
            "cross_k": torch.zeros(b, heads, s, hd, dtype=self.dtype,
                                   device=dev),
            "cross_v": torch.zeros(b, heads, s, hd, dtype=self.dtype,
                                   device=dev),
            "tokens": torch.zeros(b, self._max_len, **long),
            "pos": torch.zeros(b, **long),
            "done": torch.ones(b, dtype=torch.bool, device=dev),  # all free
            "lengths": torch.full((b,), self._max_len, **long),
            "sum_logprob": torch.zeros(b, device=dev),
            "gen_count": torch.zeros(b, **long),
            "budget": torch.full((b,), self._max_len, **long),
        }

    def submit(self, request_id: str, samples: np.ndarray,
               max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None, extra: tuple = ()) -> None:
        """``seed`` pins this request's sampling stream (reproducible
        replay); default is a fresh per-engine counter value."""
        if seed is None:
            seed = self._seed_counter
            self._seed_counter += 1
        super().submit(request_id, samples, max_new_tokens,
                       extra=(int(seed),))

    @torch.inference_mode()
    def _install(self, batch, slot_ids, budgets, extras) -> None:
        """Encode the admitted clips in one frozen-encoder pass, project the
        adapter's cross-K/V once, and install each into its slot (the JAX
        ``_gen_admit``). The LM cache needs no clearing: the per-slot
        causal mask hides the previous occupant's rows. Under a mesh a rank
        encodes only the clips admitted into its own slots."""
        st = self._state
        mine = self._mine(slot_ids)
        if not mine.any():
            return
        for slot, e in zip(slot_ids, extras):     # every rank: every stream
            self._gens[int(slot)].manual_seed(e[0] if e else 0)
        batch, budgets = batch[mine], budgets[mine]
        slot_ids = self._local_ids(slot_ids[mine])
        mels = self.frontend(batch)
        enc = encode(self.audio_params, self.model.audio_cfg, mels,
                     self.dtype)
        ck, cv = adapter_cross_kv(self.params["adapter"], enc.to(self.dtype),
                                  self.model.cfg.adapter_heads)
        slots = torch.from_numpy(slot_ids).to(self.device)
        st["cross_k"][slots] = ck
        st["cross_v"][slots] = cv
        st["tokens"][slots] = self._prompt_row
        st["pos"][slots] = 0
        st["done"][slots] = False
        st["lengths"][slots] = self._max_len
        st["sum_logprob"][slots] = 0.0
        st["gen_count"][slots] = 0
        st["budget"][slots] = torch.from_numpy(budgets).to(self.device)

    @torch.inference_mode()
    def _chunk(self) -> None:
        """Up to ``steps_per_sync`` ragged two-tower steps: embed, fuse
        through the adapter (precomputed cross-K/V), one LM step at every
        slot's own position, sample (the JAX ``_gen_chunk``). One host read
        of the ``done`` flags a step."""
        st = self._state
        lm_cfg = self.model.lm_cfg
        bidx = torch.arange(self.local_slots, device=self.device)
        first = 0 if self._rows is None else self._rows.start
        floor = torch.finfo(torch.float32).min
        for _ in range(self.steps_per_sync):
            done = st["done"].cpu().numpy()
            if done.all():
                break
            pos = st["pos"]
            with use_mesh(self.mesh):
                logits, _ = two_tower_step(self.params, lm_cfg,
                                           st["tokens"][bidx, pos],
                                           st["cross_k"], st["cross_v"], pos,
                                           st["cache"], self.dtype)
            if self.allowed_mask is not None:
                # constrained decoding (the reference's abandoned "mask out
                # non-ABC tokens" variant, model.py:346-417, made to work)
                logits = logits.masked_fill(~self.allowed_mask[None], floor)
            if self.temperature == 0.0:
                nxt = logits.argmax(-1)
            else:
                probs = torch.softmax(logits / self.temperature, -1)
                nxt = torch.zeros(self.local_slots, dtype=torch.long,
                                  device=self.device)
                for i in np.flatnonzero(~done):
                    nxt[i] = torch.multinomial(
                        probs[i], 1, generator=self._gens[first + i])[0]
            _advance(st, nxt, logits, p_len=self._p_len,
                     eos_id=self._stop_id, bidx=bidx)
            self.decode_steps += 1

    def _text(self, ids) -> str:
        if self.bpe is None:
            return ""
        return self.bpe.decode(ids, skip_specials=True)

    def warmup(self, all_buckets: bool = True) -> None:
        """Build the CUDA kernels (on the card), then serve the dummy
        requests of ``_SlotEngine.warmup``."""
        if self.device.type == "cuda":
            native.build()
        super().warmup(all_buckets)
        self.decode_steps = 0


class Lockstep:
    """An engine on a mesh driven from rank 0: a front end (the HTTP
    server, or the streaming server for a ``StreamingTranscriber``) calls
    the ``recorded`` methods and ``run`` on rank 0 only; every ``run``
    broadcasts the calls recorded since the last one, and every other rank,
    in ``follow``, makes them and runs too, so all ranks run the same
    device work on the same requests. ``stop`` (rank 0) ends the
    followers; a ``run`` after it does nothing. Other attributes read the
    engine's. The followers wait in a broadcast between runs: an idle
    spell longer than the process group's timeout (torch's default, 30
    minutes for gloo) ends them, so a long-lived server sets a longer
    one."""

    def __init__(self, engine, recorded=("submit", "cancel"), run="step"):
        import torch.distributed as dist

        self.engine = engine
        self._recorded = tuple(recorded)
        self._run = run
        self._dist = dist
        self._ops: List[tuple] = []
        self._stopped = False

    def __getattr__(self, name):
        attr = getattr(self.engine, name)
        if name in self._recorded:
            def record(*args, **kw):
                self._ops.append((name, args, kw))
                return attr(*args, **kw)
            return record
        if name == self._run:
            def run():
                if self._stopped:        # the followers have left
                    return []
                ops, self._ops = self._ops, []
                self._broadcast(ops)
                return attr()
            return run
        return attr

    def _broadcast(self, ops):
        box = [ops]
        self._dist.broadcast_object_list(box, src=0)
        return box[0]

    def stop(self) -> None:
        self._stopped = True
        self._broadcast(None)

    def follow(self) -> None:
        """A rank but 0: make rank 0's recorded calls and run, until
        ``stop``."""
        while True:
            ops = self._broadcast(None)
            if ops is None:
                return
            for name, args, kw in ops:
                getattr(self.engine, name)(*args, **kw)
            getattr(self.engine, self._run)()
