"""The port's browser demo (``cli/demo_ui.py``) against the JAX package's,
both servers live side by side on the same JAX-initialised Whisper (d 64,
1 s windows, bridged into the port) with the published tokenizer layout,
each Transcriber at temperature 0.

The page and ``/status`` are the same; a WAV and a FLAC (written by JAX's
encoder) posted to ``/transcribe`` give the same text; an undecodable
body gets 400 from both. Three labelled WAVs go to ``/add``, a 2-step
full fine-tune runs behind ``/finetune`` (its last loss within rel 1e-4),
``/status`` reaches ``done``, ``/swap`` serves the result and
``/transcribe?model=finetuned`` answers alike. A fine-tune over an empty
dataset shows ``failed`` with its error on both.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from audax.cli import demo_ui as jax_demo
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.native.bindings import encode_audio_file
from audax_torch.cli import demo_ui
from audax_torch.data.audio_io import write_wav
from audax_torch.infer.transcribe import Transcriber

from .whisper_pair import model as make_model
from .whisper_pair import tokenizers

TIMEOUT = 300
FT_STEPS = 2


def _serve(module, tr, root, name):
    server = module.serve(tr, port=0, dataset_dir=str(root / name),
                          ft_steps=FT_STEPS, ft_lora_rank=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = make_model(seed=9)
    jtr = JaxTranscriber(jparams, jcfg, jtok, temperature_fallback=False,
                         max_new_tokens=6)
    tr = Transcriber(params, cfg, tok, temperature_fallback=False,
                     max_new_tokens=6, device="cpu")
    started = {"jax": _serve(jax_demo, jtr, root, "jax_ds"),
               "torch": _serve(demo_ui, tr, root, "torch_ds")}
    yield {k: s.server_address[1] for k, (s, _) in started.items()} | {
        "root": root, "servers": started}
    for server, thread in started.values():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _request(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _both(demos, path, body=None):
    out = {}
    for k in ("jax", "torch"):
        code, raw = _request(demos[k], path, body)
        try:
            out[k] = (code, json.loads(raw))
        except ValueError:
            out[k] = (code, raw)
    return out["jax"], out["torch"]


def _clip(seed, seconds=0.75):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _wav(tmp_path, seed):
    path = tmp_path / f"c{seed}.wav"
    write_wav(str(path), _clip(seed), 16000)
    return path.read_bytes()


def test_page_and_idle_status(demos):
    (jc, jpage), (c, page) = _both(demos, "/")
    assert c == jc == 200 and page == jpage
    (jc, js), (c, s) = _both(demos, "/status")
    assert c == jc == 200 and s == js == {
        "state": "idle", "loss": None, "error": "", "serving": "base"}


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_transcribe_matches_jax(demos, tmp_path, fmt):
    if fmt == "wav":
        body = _wav(tmp_path, 1)
    else:
        path = str(tmp_path / "c.flac")
        encode_audio_file(path, _clip(2), 16000)
        with open(path, "rb") as fh:
            body = fh.read()
    (jc, jr), (c, r) = _both(demos, "/transcribe?model=original", body)
    assert c == jc == 200
    assert r.keys() == jr.keys() == {"text", "rtf"}
    assert r["text"] == jr["text"]


def test_undecodable_upload_is_400(demos):
    (jc, _), (c, r) = _both(demos, "/transcribe",
                            b"ID3\x03\x00\x00\x00" + bytes(64))
    assert c == jc == 400 and "could not decode" in r["error"]


def test_add_finetune_status_swap(demos, tmp_path):
    (jc, _), (c, r) = _both(demos, "/swap", b"")
    assert c == jc == 409 and "no finished finetune" in r["error"]
    for i, text in enumerate(["hello world", "the cat sat", "how are you"]):
        (jc, jr), (c, r) = _both(
            demos, f"/add?text={urllib.request.quote(text)}",
            _wav(tmp_path, 10 + i))
        assert c == jc == 200 and r == jr == {"file": f"sample_{i:04d}.wav"}
        for key in ("jax", "torch"):
            side = demos["root"] / f"{key}_ds" / f"sample_{i:04d}.txt"
            assert side.read_text() == text + "\n"
    (jc, jr), (c, r) = _both(demos, "/finetune", b"")
    assert c == jc == 200 and r == jr == {"state": "running"}
    status = {}
    deadline = time.time() + TIMEOUT
    for key in ("jax", "torch"):
        while True:
            s = json.loads(_request(demos[key], "/status")[1])
            if s["state"] != "running" or time.time() > deadline:
                break
            time.sleep(0.2)
        status[key] = s
    assert status["torch"]["state"] == status["jax"]["state"] == "done", \
        status
    assert status["torch"]["loss"] == pytest.approx(status["jax"]["loss"],
                                                    rel=1e-4)
    (jc, jr), (c, r) = _both(demos, "/swap", b"")
    assert c == jc == 200 and r == jr == {"serving": "finetuned"}
    tr = demos["servers"]["torch"][0].demo_state.ft_transcriber
    assert tr.device.type == "cpu" and tr.temperature_fallback is False
    body = _wav(tmp_path, 20)
    (jc, jr), (c, r) = _both(demos, "/transcribe?model=finetuned", body)
    assert c == jc == 200 and r["text"] == jr["text"]


def test_failed_finetune_is_reported(tmp_path):
    """An empty dataset: the job fails and ``/status`` says so with the
    error, as the JAX demo's does."""
    jtok, tok = tokenizers()
    _, _, _, cfg, params = make_model(seed=9)
    tr = Transcriber(params, cfg, tok, device="cpu")
    state = demo_ui.DemoState(tr, dataset_dir=str(tmp_path / "empty"),
                              ft_steps=1)
    assert state.start_finetune() is None
    state._job_thread.join(timeout=TIMEOUT)
    assert not state._job_thread.is_alive()
    assert state.job_state == "failed" and "dataset empty" in state.job_error
    assert state.pending_params is None
