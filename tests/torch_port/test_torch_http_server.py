"""Port REST server (``cli/http_server.py``) vs the JAX package's, on live
sockets.

Both servers run over a continuous-batching engine on the same
JAX-initialised Whisper (int4 weights, int8 KV, 1 s window, two slots):
the JAX package's over its ``ContinuousBatcher``, the port's over its own
on the CPU. The same 16-bit WAV posted to both gives the same ``json``
body (tokens and text exact, avg_logprob to 1e-4), and the same ``text``,
``srt`` and ``vtt`` bodies; three concurrent clients through two slots all
get the same answer. ``/healthz`` answers, and a compressed-container
upload gets 415 naming the native audio decoder.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from audax.cli.http_server import serve_http as jax_serve_http
from audax.infer.continuous import ContinuousBatcher as JaxBatcher
from audax.models.quantize import quantize_tree as jax_quantize_tree
from audax_torch.cli.http_server import render_window, serve_http
from audax_torch.data.audio_io import write_wav
from audax_torch.infer.continuous import ContinuousBatcher
from audax_torch.models.quantize import quantize_tree

from .whisper_pair import model as make_model
from .whisper_pair import tokenizers

TIMEOUT = 300


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


@pytest.fixture(scope="module")
def servers():
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = make_model(
        d_model=64, heads=2, encoder_layers=1, decoder_layers=2,
        n_audio_ctx=50, n_text_ctx=32, seed=5)
    kw = dict(slots=2, window_seconds=1.0, max_new_tokens=6,
              steps_per_sync=4, kv_quant=True)
    jcb = JaxBatcher(jax_quantize_tree(jparams, bits=4), jcfg, jtok, **kw)
    cb = ContinuousBatcher(quantize_tree(params, bits=4), cfg, tok,
                           device="cpu", **kw)
    started = [_start(jax_serve_http(jcb, port=0)),
               _start(serve_http(cb, port=0))]
    yield {"jax": started[0][1], "torch": started[1][1]}
    for srv, _ in started:
        srv.scheduler.shutdown()
        srv.shutdown()
        srv.server_close()


def _wav_bytes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(12000) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.size)
    path = tmp_path / f"clip{seed}.wav"
    write_wav(str(path), x.astype(np.float32), 16000)
    return path.read_bytes()


def _post(port, body, query=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions{query}",
        data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_healthz(servers):
    for port in servers.values():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=TIMEOUT) as r:
            h = json.load(r)
        assert h["ok"] and h["live"] == 0 and h["pending"] == 0


@pytest.mark.parametrize("rfmt", ["json", "text", "srt", "vtt"])
def test_responses_match_jax(servers, tmp_path, rfmt):
    body = _wav_bytes(tmp_path, 1)
    q = f"?response_format={rfmt}"
    (jcode, jbody), (code, ours) = (_post(servers[k], body, q)
                                    for k in ("jax", "torch"))
    assert code == jcode == 200
    if rfmt != "json":
        assert ours.decode() == jbody.decode()
        return
    ref, got = json.loads(jbody), json.loads(ours)
    assert got.keys() == ref.keys()
    assert got["tokens"] == ref["tokens"] and got["text"] == ref["text"]
    assert got["audio_seconds"] == ref["audio_seconds"] == 0.75
    assert got["avg_logprob"] == pytest.approx(ref["avg_logprob"], abs=1e-4)
    assert got["tokens"]


def test_concurrent_clients_share_the_engine(servers, tmp_path):
    """Three clients through two slots: the third request is admitted by a
    mid-decode refill; every answer equals the JAX server's for its WAV."""
    bodies = [_wav_bytes(tmp_path, 10 + i) for i in range(3)]
    out, errors = {}, []

    def post(key, i):
        try:
            out[(key, i)] = _post(servers[key], bodies[i], "?max_tokens=4")
        except OSError as exc:                   # surfaced by the assert
            errors.append(exc)

    threads = [threading.Thread(target=post, args=(k, i))
               for k in servers for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(3):
        (jcode, jbody), (code, body) = out[("jax", i)], out[("torch", i)]
        assert code == jcode == 200
        ref, got = json.loads(jbody), json.loads(body)
        assert got["tokens"] == ref["tokens"] and len(got["tokens"]) <= 4


@pytest.mark.parametrize("query,body", [
    ("?format=m4a", b"\x00\x00\x00\x20ftypM4A " + b"\x00" * 64),
    ("", b"ID3\x03\x00\x00\x00" + b"\x00" * 64),
], ids=["m4a", "mp3-body"])
def test_compressed_uploads_get_415(servers, query, body):
    code, msg = _post(servers["torch"], body, query)
    assert code == 415
    assert "native audio decoder" in json.loads(msg)["error"]


def test_bad_requests(servers, tmp_path):
    port = servers["torch"]
    body = _wav_bytes(tmp_path, 2)
    assert _post(port, body, "?response_format=xml")[0] == 400
    assert _post(port, body, "?max_tokens=many")[0] == 400
    assert _post(port, body, "?lang=xx")[0] == 400
    assert _post(port, b"RIFF\x10\x00\x00\x00WAVEjunk")[0] == 400
    long = np.zeros(20000, np.float32)
    path = tmp_path / "long.wav"
    write_wav(str(path), long, 16000)
    assert _post(port, path.read_bytes())[0] == 413
    assert render_window(" hi ", 1.5, "srt") == \
        "1\n00:00:00,000 --> 00:00:01,500\nhi\n\n"
