"""Browser demo: record or upload audio, compare the original and the
fine-tuned Whisper (port of ``audax/cli/demo_ui.py``).

The reference's Streamlit app (AB/UI/Asmo.py: recorder, "Evaluate Whisper /
Finetune" buttons, add-to-dataset, the fine-tune trigger, model swap) as a
stdlib HTTP server. Uploads are WAV or any container the port's native
decoder reads (browser recordings are webm/ogg): ``data/audio_io.py:
decode_audio``, with no ``ffmpeg`` subprocess behind it. The background
fine-tune runs ``finetune_whisper`` on the transcriber's device (the CUDA
card unless it was built on the CPU); a failed job shows as ``failed`` on
``/status`` with its error.

    python -m audax_torch.cli.main demo --size tiny [--ckpt ...] \
        [--ft-ckpt ...] [--device cpu]

Then open http://localhost:8501.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from struct import error as struct_error
from typing import Optional

import numpy as np

from audax_torch.core.logging import get_logger

__all__ = ["DemoState", "make_handler", "serve"]

log = get_logger("audax_torch.demo")

_PAGE = """<!DOCTYPE html>
<html><head><title>audax demo</title><style>
body { font-family: system-ui, sans-serif; max-width: 760px; margin: 2rem auto;
       background: #12121a; color: #eee; }
h1 { background: linear-gradient(90deg,#7dd,#d7a); -webkit-background-clip: text;
     color: transparent; }
button { background:#2a2a3a; color:#eee; border:1px solid #557; padding:.6rem 1.2rem;
         border-radius:8px; margin:.3rem; cursor:pointer; font-size:1rem; }
button:hover { background:#3a3a52; }
.card { background:#1a1a26; border-radius:12px; padding:1rem; margin:1rem 0; }
.result { white-space:pre-wrap; font-family:monospace; color:#9fd; }
</style></head><body>
<h1>audax &mdash; whisper demo</h1>
<div class="card">
  <button id="rec">&#9679; Record</button>
  <button id="stop" disabled>&#9632; Stop</button>
  <input type="file" id="file" accept=".wav">
  <span id="status"></span>
</div>
<div class="card">
  <button onclick="transcribe('original')">Evaluate Whisper</button>
  <button onclick="transcribe('finetuned')">Evaluate Finetune</button>
  <button onclick="addToDataset()">Add to dataset</button>
  <input type="text" id="label" placeholder="transcript for dataset"
         style="background:#2a2a3a;color:#eee;border:1px solid #557;
                border-radius:8px;padding:.5rem">
</div>
<div class="card">
  <button onclick="finetune()">Finetune</button>
  <button onclick="swapModel()">Swap model</button>
  <span id="ftstatus"></span>
  <div id="out" class="result"></div>
</div>
<script>
let audioBlob = null, mediaRecorder = null, chunks = [];
const status = (m) => document.getElementById('status').textContent = m;
document.getElementById('rec').onclick = async () => {
  const stream = await navigator.mediaDevices.getUserMedia({audio: true});
  mediaRecorder = new MediaRecorder(stream);
  chunks = [];
  mediaRecorder.ondataavailable = (e) => chunks.push(e.data);
  mediaRecorder.onstop = () => { audioBlob = new Blob(chunks); status('recorded'); };
  mediaRecorder.start();
  document.getElementById('stop').disabled = false;
  status('recording...');
};
document.getElementById('stop').onclick = () => mediaRecorder && mediaRecorder.stop();
document.getElementById('file').onchange = (e) => {
  audioBlob = e.target.files[0]; status('file loaded');
};
async function post(path) {
  if (!audioBlob) { status('no audio'); return null; }
  const res = await fetch(path, {method: 'POST', body: audioBlob});
  return await res.json();
}
async function transcribe(model) {
  document.getElementById('out').textContent = '...';
  const r = await post('/transcribe?model=' + model);
  if (r) document.getElementById('out').textContent =
    (model === 'original' ? 'whisper: ' : 'finetune: ') + r.text +
    '\\n(rtf ' + r.rtf + ')';
}
async function addToDataset() {
  const label = encodeURIComponent(document.getElementById('label').value);
  const r = await post('/add?text=' + label);
  if (r) status('saved as ' + r.file);
}
const ftstatus = (m) => document.getElementById('ftstatus').textContent = m;
async function finetune() {
  ftstatus('starting...');
  const res = await fetch('/finetune', {method: 'POST'});
  const r = await res.json();
  if (r.error) { ftstatus(r.error); return; }
  const poll = setInterval(async () => {
    const s = await (await fetch('/status')).json();
    ftstatus('finetune: ' + s.state +
             (s.loss != null ? ' (loss ' + s.loss + ')' : ''));
    if (s.state === 'done' || s.state === 'failed') clearInterval(poll);
  }, 1000);
}
async function swapModel() {
  const res = await fetch('/swap', {method: 'POST'});
  const r = await res.json();
  ftstatus(r.error || ('serving: ' + r.serving));
}
</script></body></html>
"""


class DemoState:
    """What the demo's handlers share: the two transcribers, the dataset
    directory, and the background fine-tune's job."""

    def __init__(self, transcriber, ft_transcriber=None,
                 dataset_dir: str = "artifacts/demo_dataset",
                 ft_steps: int = 50, ft_lora_rank: int = 4):
        self.transcriber = transcriber
        self.ft_transcriber = ft_transcriber or transcriber
        self.dataset_dir = dataset_dir
        # resume numbering past existing samples: a fresh counter would
        # overwrite sample_0000.wav collected in earlier sessions
        existing = (glob.glob(os.path.join(dataset_dir, "sample_*.wav"))
                    if os.path.isdir(dataset_dir) else [])
        nums = [int(m.group(1)) for m in
                (re.search(r"sample_(\d+)\.wav$", p) for p in existing) if m]
        self.counter = max(nums) + 1 if nums else 0
        self.lock = threading.Lock()
        # the reference UI's "Finetune" button (AB/UI/Asmo.py:152-166), its
        # training defaults from AB/fineTune.py:162-183
        self.ft_steps = ft_steps
        self.ft_lora_rank = ft_lora_rank
        self.job_state = "idle"          # idle | running | done | failed
        self.job_loss: Optional[float] = None
        self.job_error = ""
        self.pending_params = None       # finished weights awaiting /swap
        self.serving = "base"            # the weights of /transcribe?finetuned
        self._job_thread: Optional[threading.Thread] = None

    def start_finetune(self) -> Optional[str]:
        """Start a background LoRA fine-tune over ``dataset_dir``; returns
        an error message or None. Labels are the ``.txt`` sidecars written
        by ``/add?text=...`` (the reference records one invented word and
        fine-tunes on it, AB/fineTune.py:66-95)."""
        with self.lock:
            if self.job_state == "running":
                return "finetune already running"
            self.job_state = "running"
            self.job_loss = None
            self.job_error = ""
        self._job_thread = threading.Thread(target=self._run_finetune,
                                            daemon=True)
        self._job_thread.start()
        return None

    def _run_finetune(self) -> None:
        from audax_torch.core.config import FineTuneConfig, MelConfig
        from audax_torch.train.finetune_loop import (build_speech_dataset,
                                                     finetune_whisper)
        try:
            tr = self.transcriber
            mel_cfg = MelConfig.whisper(tr.cfg.n_mels)
            examples = build_speech_dataset(self.dataset_dir, tr.tokenizer,
                                            mel_cfg,
                                            chunk_seconds=tr.chunk_seconds)
            if not examples:
                raise RuntimeError(
                    "dataset empty: record audio, type a transcript, and "
                    "'Add to dataset' first")
            ft = FineTuneConfig(
                learning_rate=1e-3 if self.ft_lora_rank else 1e-5,
                warmup_steps=5, max_steps=self.ft_steps,
                eval_every=10 ** 9,          # WER eval = /swap + evaluate
                batch_size=8, lora_rank=self.ft_lora_rank)
            state, history = finetune_whisper(
                tr.params, tr.cfg, tr.tokenizer, examples, ft,
                mel_cfg=mel_cfg, device=tr.device)
            with self.lock:
                self.pending_params = state.model_params()
                self.job_loss = round(history["loss"][-1], 4)
                self.job_state = "done"
        except Exception as e:  # noqa: BLE001 - reported on /status
            log.exception("demo finetune failed")
            with self.lock:
                self.job_error = str(e)
                self.job_state = "failed"

    def swap(self) -> Optional[str]:
        """Serve the latest fine-tuned weights on the 'finetuned' slot (the
        reference UI's "Swap model" button); returns an error or None."""
        from audax_torch.infer.transcribe import Transcriber
        with self.lock:
            if self.pending_params is None:
                return "no finished finetune to swap in"
            params = self.pending_params
            tr = self.transcriber
        # the base slot's decode policy: another fallback or beam setting
        # here would credit decode-policy differences to the fine-tune
        new_tr = Transcriber(params, tr.cfg, tr.tokenizer,
                             lang=tr.lang, task=tr.task,
                             max_new_tokens=tr.max_new_tokens,
                             chunk_seconds=tr.chunk_seconds,
                             temperature_fallback=tr.temperature_fallback,
                             temperatures=tr.temperatures,
                             beam_width=tr.beam_width,
                             dtype=tr.dtype, device=tr.device)
        with self.lock:
            self.ft_transcriber = new_tr
            self.serving = "finetuned"
        return None


def _decode_audio(body: bytes) -> Optional[np.ndarray]:
    """An upload as mono float32 at 16 kHz, or None where it does not
    decode (the handler answers 400): WAV in memory, a browser recording
    (webm/ogg/m4a) through the native decoder."""
    from audax_torch.data.audio_io import decode_audio, resample, to_mono
    try:
        x, rate = decode_audio(body, "wav" if body[:4] == b"RIFF" else "webm")
    except (ValueError, struct_error):
        return None
    x = to_mono(x)
    if rate != 16000:
        x = resample(x, rate, 16000)
    return x


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/status"):
                with state.lock:
                    self._json({"state": state.job_state,
                                "loss": state.job_loss,
                                "error": state.job_error,
                                "serving": state.serving})
                return
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            # control endpoints take no audio body
            if self.path.startswith("/finetune"):
                err = state.start_finetune()
                self._json({"error": err} if err else {"state": "running"},
                           409 if err else 200)
                return
            if self.path.startswith("/swap"):
                err = state.swap()
                self._json({"error": err} if err else
                           {"serving": state.serving}, 409 if err else 200)
                return
            audio = _decode_audio(body)
            if audio is None:
                self._json({"error": "could not decode audio (upload WAV "
                            "or a container the system libav reads)"}, 400)
                return
            if self.path.startswith("/transcribe"):
                model = "finetuned" if "finetuned" in self.path else "original"
                tr = (state.ft_transcriber if model == "finetuned"
                      else state.transcriber)
                with state.lock:
                    result = tr.transcribe(audio)
                self._json({"text": result.text, "rtf": round(result.rtf, 3)})
            elif self.path.startswith("/add"):
                from urllib.parse import parse_qs, urlparse

                from audax_torch.data.audio_io import write_wav
                os.makedirs(state.dataset_dir, exist_ok=True)
                with state.lock:
                    name = f"sample_{state.counter:04d}.wav"
                    state.counter += 1
                write_wav(os.path.join(state.dataset_dir, name), audio, 16000)
                # the transcript sidecar: the label /finetune trains on
                # (build_speech_dataset's per-file .txt contract)
                q = parse_qs(urlparse(self.path).query)   # percent-decodes
                text = q.get("text", [""])[0].strip()
                if text:
                    side = os.path.splitext(name)[0] + ".txt"
                    with open(os.path.join(state.dataset_dir, side),
                              "w", encoding="utf-8") as fh:
                        fh.write(text + "\n")
                self._json({"file": name})
            else:
                self._json({"error": "unknown endpoint"}, 404)

        def log_message(self, *args):  # quiet
            pass

    return Handler


def serve(transcriber, ft_transcriber=None, *, port: int = 8501,
          host: str = "127.0.0.1",
          dataset_dir: str = "artifacts/demo_dataset",
          ft_steps: int = 50,
          ft_lora_rank: int = 4) -> ThreadingHTTPServer:
    """The demo's server (not yet serving: call ``serve_forever``), its
    ``DemoState`` as ``server.demo_state``. Loopback by default: the demo
    takes arbitrary uploads and writes them to disk."""
    state = DemoState(transcriber, ft_transcriber, dataset_dir,
                      ft_steps=ft_steps, ft_lora_rank=ft_lora_rank)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.demo_state = state
    log.success("demo UI at http://%s:%d", host, server.server_address[1])
    return server
