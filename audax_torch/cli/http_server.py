"""REST batch-ASR server over the continuous-batching engine (own copy of
``audax/cli/http_server.py``; stdlib plus numpy).

A plain-HTTP transcription endpoint where every in-flight request becomes a
slot of one ``ContinuousBatcher`` (``infer/continuous.py``): finished slots
are refilled mid-decode, so concurrent requests share one decode batch.

Endpoints:
  * ``POST /v1/audio/transcriptions[?max_tokens=64&lang=en&``
    ``response_format=json&truncate=1]`` -- the body is a WAV file.
    ``response_format`` mirrors the OpenAI audio API: ``json`` (default:
    ``{"text", "avg_logprob", "tokens", "audio_seconds"}``), ``text``,
    ``verbose_json``, ``srt``, ``vtt`` (one cue spanning the decoded
    window). ``format=`` names the container (default ``wav``): m4a, mp3,
    ogg, flac, ... are decoded by the native audio decoder over the system
    libav (``native/bindings.py``); a body that does not decode gets 400.
  * ``GET /healthz`` -- ``{"ok", "error", "live", "pending"}``;
    ``GET /metrics`` -- latency percentiles and engine counters.

Threading model: HTTP handler threads only enqueue audio and wait on an
event; one scheduler thread owns the engine (submit/step/harvest), so the
device state is touched from exactly one thread. A full in-flight cap
answers 429 with Retry-After; a dead scheduler answers 503.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from struct import error as struct_error
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from audax_torch.core.logging import get_logger
from audax_torch.data.audio_io import decode_audio, resample, to_mono

log = get_logger("audax_torch.http_server")

__all__ = ["serve_http", "Scheduler", "SchedulerDown", "ServerBusy",
           "render_window"]

_MAX_BODY = 512 << 20


class SchedulerDown(RuntimeError):
    """The scheduler thread has died; submissions are refused."""


class ServerBusy(RuntimeError):
    """In-flight request cap reached; the client should retry (429)."""


def _ts(seconds: float, *, sep: str) -> str:
    """Seconds as HH:MM:SS<sep>mmm (srt uses ',', vtt '.')."""
    ms = max(0, int(round(seconds * 1000.0)))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def render_window(text: str, seconds: float, fmt: str) -> str:
    """One decoded window as ``txt``, ``srt`` or ``vtt``: the JAX package's
    writers (``audax/infer/writers.py``) for a result of one segment
    spanning [0, seconds] without word timings."""
    text = text.strip()
    if fmt == "txt":
        return text + "\n" if text else ""
    if fmt not in ("srt", "vtt"):
        raise ValueError(f"unknown output format {fmt!r}")
    sep = "," if fmt == "srt" else "."
    cue = f"{_ts(0.0, sep=sep)} --> {_ts(seconds, sep=sep)}\n{text}\n\n"
    if fmt == "srt":
        return f"1\n{cue}" if text else ""
    return "WEBVTT\n\n" + (cue if text else "")


class Scheduler(threading.Thread):
    """Single thread that owns the continuous-batching engine."""

    def __init__(self, engine, *, max_inflight: Optional[int] = None):
        super().__init__(daemon=True, name="audax-serve-scheduler")
        self.engine = engine
        # admission cap: bounds queued-audio memory and handler threads
        self.max_inflight = max_inflight or 8 * getattr(engine, "slots", 8)
        self._cv = threading.Condition()
        self._inbox: List[tuple] = []
        self._events = {}
        self._results = {}
        self._stopping = False
        self._cancelled = set()
        #: not None => the scheduler thread died with this error; serving
        #: is down (healthz reports it, new requests 503 at once)
        self.dead: Optional[str] = None
        # -- serving telemetry (guarded by _cv) --
        self._t_start = time.monotonic()
        self._submitted_at = {}
        self._latencies = deque(maxlen=512)     # recent end-to-end seconds
        self._served = 0
        self._tokens_out = 0
        self._audio_seconds = 0.0

    # -- handler-thread API -----------------------------------------------
    def submit(self, samples: np.ndarray,
               max_tokens: Optional[int] = None,
               lang: Optional[str] = None) -> Tuple[str, threading.Event]:
        rid = uuid.uuid4().hex
        ev = threading.Event()
        with self._cv:
            # both checks hold the lock: a dead-check outside it would race
            # run()'s event sweep and the request would hang to timeout
            if self.dead is not None:
                raise SchedulerDown(self.dead)
            if len(self._submitted_at) >= self.max_inflight:
                raise ServerBusy(
                    f"{len(self._submitted_at)} requests in flight "
                    f"(cap {self.max_inflight})")
            self._events[rid] = ev
            self._submitted_at[rid] = time.monotonic()
            self._inbox.append((rid, samples, max_tokens, lang))
            self._cv.notify()
        return rid, ev

    def result(self, rid: str):
        with self._cv:
            return self._results.pop(rid)

    def cancel(self, rid: str) -> None:
        """Forget a timed-out request. If it is still queued, the scheduler
        thread also drops it from its inbox and the engine queue; an
        admitted request drains its slot."""
        with self._cv:
            self._events.pop(rid, None)
            self._results.pop(rid, None)
            self._submitted_at.pop(rid, None)
            self._cancelled.add(rid)

    def metrics(self) -> dict:
        with self._cv:
            lat = sorted(self._latencies)
            pct = (lambda p: round(lat[int(p * (len(lat) - 1))], 4)) \
                if lat else (lambda p: None)
            return {
                "uptime_s": round(time.monotonic() - self._t_start, 1),
                "requests_served": self._served,
                "tokens_generated": self._tokens_out,
                "audio_seconds": round(self._audio_seconds, 1),
                "live": self.engine.live(),
                "pending": self.engine.pending(),
                "latency_s": {"p50": pct(0.50), "p95": pct(0.95),
                              "max": pct(1.0), "window": len(lat)},
                # enqueued = chunks x steps_per_sync; a chunk may stop
                # early once every slot is done
                "engine": {"decode_steps_enqueued": self.engine.steps_run,
                           "chunks": self.engine.chunks_run},
            }

    def shutdown(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()

    # -- engine thread ----------------------------------------------------
    def run(self) -> None:
        try:
            self._serve_loop()
        except Exception as exc:  # noqa: BLE001 - fail loud, not hung
            log.exception("scheduler thread died: %s", exc)
            with self._cv:
                self.dead = f"{type(exc).__name__}: {exc}"
                # fail only still-waiting requests; delivered results stay
                undelivered = {rid: ev for rid, ev in self._events.items()
                               if rid not in self._results}
                for rid in undelivered:
                    self._events.pop(rid, None)
            for ev in undelivered.values():
                ev.set()          # waiters find no result -> 503, not 504

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                while (not self._stopping and not self._inbox
                       and self.engine.live() == 0
                       and self.engine.pending() == 0):
                    self._cv.wait()
                if self._stopping:
                    return
                inbox, self._inbox = self._inbox, []
                cancelled, self._cancelled = self._cancelled, set()
            for rid in cancelled:  # timed out before admission: drop
                inbox = [e for e in inbox if e[0] != rid]
                self.engine.cancel(rid)
            for rid, samples, max_tokens, lang in inbox:
                kw = {"lang": lang} if lang else {}
                self.engine.submit(rid, samples, max_new_tokens=max_tokens,
                                   **kw)
            for r in self.engine.step():
                now = time.monotonic()
                with self._cv:
                    t0 = self._submitted_at.pop(r.request_id, None)
                    if t0 is not None:
                        self._latencies.append(now - t0)
                    self._served += 1
                    self._tokens_out += len(r.tokens)
                    self._audio_seconds += r.audio_seconds
                    ev = self._events.pop(r.request_id, None)
                    if ev is not None:      # waiter still there (no timeout)
                        self._results[r.request_id] = r
                if ev is not None:
                    ev.set()


class _Handler(BaseHTTPRequestHandler):
    server_version = "audax-torch-serve/1"

    def log_message(self, fmt, *args):            # route through our logger
        log.debug("%s " + fmt, self.client_address[0], *args)

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj, **kw) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json", **kw)

    def do_GET(self):
        path = urlparse(self.path).path
        if path in ("/", "/healthz"):
            s = self.server.scheduler
            e = s.engine
            self._json(200 if s.dead is None else 503,
                       {"ok": s.dead is None, "error": s.dead,
                        "live": e.live(), "pending": e.pending()})
        elif path == "/metrics":
            self._json(200, self.server.scheduler.metrics())
        else:
            self._json(404, {"error": "not found"})

    def _audio(self, q, body: bytes):
        """The upload as mono float32 at the engine's rate, or None after
        answering the client."""
        fmt = q.get("format", ["wav"])[0].lower()
        if not fmt.isalnum():
            self._json(400, {"error": "bad format"})
            return None
        try:
            x, rate = decode_audio(body, fmt)
            x = to_mono(x)
            sr = self.server.scheduler.engine.sample_rate
            if rate != sr:
                x = resample(x, rate, sr)
        except (ValueError, struct_error) as exc:
            self._json(400, {"error": f"undecodable audio: {exc}"})
            return None
        return x

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/v1/audio/transcriptions":
            self._json(404, {"error": "not found"})
            return
        q = parse_qs(url.query)
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self._json(400, {"error": "bad Content-Length"})
            return
        if n <= 0 or n > _MAX_BODY:
            self._json(400, {"error": "missing or oversized body"})
            return
        body = self.rfile.read(n)
        rfmt = q.get("response_format", ["json"])[0].lower()
        if rfmt not in ("json", "text", "verbose_json", "srt", "vtt"):
            self._json(400, {"error": f"bad response_format: {rfmt}"})
            return
        x = self._audio(q, body)
        if x is None:
            return
        max_tokens = None
        if "max_tokens" in q:
            try:
                max_tokens = int(q["max_tokens"][0])
            except ValueError:
                self._json(400, {"error": "bad max_tokens"})
                return
        sched = self.server.scheduler
        if sched.dead is not None:
            self._json(503, {"error": f"serving is down: {sched.dead}"})
            return
        window = getattr(sched.engine, "window", None)
        if window is not None and len(x) > window \
                and q.get("truncate", ["0"])[0] != "1":
            self._json(413, {"error": (
                f"audio is {len(x) / sched.engine.sample_rate:.1f}s but the "
                f"serving window is {window / sched.engine.sample_rate:.1f}s"
                "; split the file (the Transcriber API chunks long audio) "
                "or pass truncate=1 to transcribe the first window only")})
            return
        lang = q.get("lang", [None])[0]
        if lang is not None:
            # validate here: a bad language must 400 the request, not kill
            # the shared scheduler thread at engine.submit time
            tok = getattr(sched.engine, "tokenizer", None)
            try:
                if tok is not None:
                    tok.sot_sequence(lang=lang)
            except (KeyError, ValueError):
                self._json(400, {"error": f"unknown language: {lang}"})
                return
        try:
            rid, ev = sched.submit(np.asarray(x, np.float32), max_tokens,
                                   lang=lang)
        except ServerBusy as exc:
            self._json(429, {"error": f"server busy: {exc}"},
                       headers=(("Retry-After", "1"),))
            return
        except SchedulerDown as exc:
            self._json(503, {"error": f"serving is down: {exc}"})
            return
        if not ev.wait(timeout=self.server.request_timeout_s):
            sched.cancel(rid)
            self._json(504, {"error": "decode timed out"})
            return
        try:
            r = sched.result(rid)
        except KeyError:         # scheduler died while we waited
            self._json(503, {"error": f"serving is down: {sched.dead}"})
            return
        if rfmt == "json":
            self._json(200, {"text": r.text, "avg_logprob": r.avg_logprob,
                             "tokens": r.tokens,
                             "audio_seconds": r.audio_seconds})
        elif rfmt == "verbose_json":
            self._json(200, {
                "task": "transcribe", "duration": r.audio_seconds,
                "text": r.text,
                "segments": [{"id": 0, "start": 0.0,
                              "end": r.audio_seconds, "text": r.text,
                              "avg_logprob": r.avg_logprob,
                              "tokens": r.tokens}]})
        else:
            out = render_window(r.text, r.audio_seconds,
                                "txt" if rfmt == "text" else rfmt)
            self._send(200, out.encode("utf-8"), "text/plain; charset=utf-8")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def serve_http(engine, *, host: str = "127.0.0.1", port: int = 8080,
               request_timeout_s: float = 600.0,
               max_inflight: Optional[int] = None) -> _Server:
    """Create (not start) the REST server over a ``ContinuousBatcher``;
    call ``serve_forever()`` on the result, or drive it from a thread. The
    scheduler thread starts at once. ``max_inflight`` caps admitted but
    unfinished requests (default 8x the engine's slots); beyond it a
    submission gets 429 + Retry-After."""
    server = _Server((host, port), _Handler)
    server.scheduler = Scheduler(engine,                    # type: ignore
                                 max_inflight=max_inflight)
    server.request_timeout_s = request_timeout_s            # type: ignore
    server.scheduler.start()
    return server
