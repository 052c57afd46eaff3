"""Port ``StreamingTranscriber`` and the WebSocket server
(``cli/stream_server.py``) vs the JAX package's, on the CPU.

The model is the serving tests' small Whisper (``whisper_pair.py``:
d_model 64, 1+2 layers, the 51,865-token layout, 1 s windows), JAX-
initialised and bridged. The streaming segments must equal the JAX
transcriber's (stream, index, text, seconds); the frame codec must write
the JAX codec's bytes and read its frames; and a live socket must deliver
the segments the direct calls return, with the RFC 6455 handshake vector,
ping/pong between fragments and float32 samples split across messages.
"""

import base64
import json
import os
import socket
import struct
import threading

import numpy as np
import pytest

from audax.cli import stream_server as jserver
from audax.infer.streaming import StreamingTranscriber as JaxStreaming
from audax_torch.cli.stream_server import (OP_BINARY, OP_CLOSE, OP_TEXT,
                                           read_frame, serve_streaming,
                                           write_frame, ws_handshake_accept)
from audax_torch.infer.streaming import StreamingTranscriber

from .mesh_world import run_world
from .whisper_pair import model, tokenizers

SR = 16000


@pytest.fixture(scope="module")
def pair():
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = model()
    kw = dict(window_seconds=1.0, max_new_tokens=6)

    def make(slots, **extra):
        return (JaxStreaming(jparams, jcfg, jtok, batch_slots=slots,
                             backend="xla", **kw, **extra),
                StreamingTranscriber(params, cfg, tok, batch_slots=slots,
                                     device="cpu", **kw, **extra))
    return make


def _segs(segs):
    return [(s.stream_id, s.index, s.text, s.audio_seconds) for s in segs]


def _feed_pieces(st, sid, audio, piece):
    for i in range(0, len(audio), piece):
        st.feed(sid, audio[i: i + piece])


def test_buffering_and_chunking_match_jax(pair, rng):
    jst, st = pair(4)
    audio = (0.05 * rng.standard_normal(int(3.5 * SR))).astype(np.float32)
    pieces = [int(rng.integers(300, 9000)) for _ in range(12)]
    for s in (jst, st):
        pos = 0
        for n in pieces:
            s.feed("a", audio[pos: pos + n])
            pos += n
        s.feed("a", audio[pos:])
    assert st.pending_chunks() == jst.pending_chunks() == 3
    st.flush("a")
    jst.flush("a")
    assert st.pending_chunks() == 4
    ours, ref = st.drain(), jst.drain()
    assert _segs(ours) == _segs(ref)
    assert [s.index for s in ours] == [0, 1, 2, 3]
    assert ours[-1].audio_seconds == pytest.approx(0.5)
    assert any(s.text for s in ours)
    st.flush("a")                            # an empty stream: a no-op
    assert st.pending_chunks() == 0
    st.remove("a")
    assert "a" not in st.streams


def test_multi_stream_slots_match_jax(pair, rng):
    """Four streams through three slots: one full pass, then one of a
    single stream and zero-filled slots, as in the JAX package."""
    jst, st = pair(3)
    for sid in ("s1", "s2", "s3", "s4"):
        audio = (0.05 * rng.standard_normal(int(1.2 * SR))).astype(np.float32)
        st.feed(sid, audio)
        jst.feed(sid, audio)
    assert st.pending_chunks() == 4
    first, jfirst = st.step(), jst.step()
    assert len(first) == 3 and _segs(first) == _segs(jfirst)
    second, jsecond = st.step(), jst.step()
    assert len(second) == 1 and _segs(second) == _segs(jsecond)
    assert st.step() == [] == jst.step()


def test_vad_answers_silent_windows_without_a_pass(pair, rng):
    jst, st = pair(2, vad_threshold_db=-45.0)
    loud = (0.1 * rng.standard_normal(SR)).astype(np.float32)
    for s in (jst, st):
        s.feed("mic", loud)
        s.feed("mic", np.zeros(SR, np.float32))
        s.feed("mic", loud)
    calls = []
    orig = st._run_batch

    def counting(audio):
        calls.append(audio.shape[0])
        return orig(audio)

    st._run_batch = counting
    ours, ref = st.drain(), jst.drain()
    assert _segs(ours) == _segs(ref)
    assert {s.index: s.text for s in ours}[1] == "" and calls == [2]
    calls.clear()
    st.feed("mic", np.zeros(SR, np.float32))
    assert [s.text for s in st.step()] == [""] and calls == []


def test_mesh_is_a_later_slice(pair, rng, mesh_of_one):
    """``StreamingTranscriber(mesh=)`` over a mesh of this one process:
    the same segments as the transcriber without one, and JAX's."""
    jst, st = pair(2)
    meshed = StreamingTranscriber(st.params, st.cfg, st.tokenizer,
                                  batch_slots=2, window_seconds=1.0,
                                  max_new_tokens=6, mesh=mesh_of_one,
                                  device="cpu")
    audio = (0.05 * rng.standard_normal(int(1.5 * SR))).astype(np.float32)
    for s in (jst, st, meshed):
        s.feed("x", audio)
        s.flush("x")
    ref = _segs(jst.drain())
    assert _segs(st.drain()) == ref and _segs(meshed.drain()) == ref


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """Four ranks as (data 2, model 2): the transcriber at 2 slots (the
    window rows over 'data') and at 3 (every rank encodes them all), each
    run on every rank and driven from rank 0 through ``Lockstep``."""
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = model(heads=4, seed=5)
    rng = np.random.default_rng(11)
    audio = {f"s{i}": (0.05 * rng.standard_normal(int(n * SR))).astype(
        np.float32) for i, n in enumerate((2.5, 1.0, 1.7))}
    outs = run_world(4, "tests.torch_port.mesh_cases:stream_mesh", dict(
        params=params, cfg=cfg, tok=tok, audio=audio, slots=(2, 3)),
        tmp_path_factory.mktemp("stream_mesh"))
    refs = {}
    for slots in (2, 3):
        jst = JaxStreaming(jparams, jcfg, jtok, batch_slots=slots,
                           window_seconds=1.0, max_new_tokens=6,
                           backend="xla")
        for sid, x in audio.items():
            jst.feed(sid, x)
            jst.flush(sid)
        refs[slots] = _segs(jst.drain())
    return outs, refs


@pytest.mark.parametrize("slots", [2, 3])
def test_streaming_over_mesh_matches_jax(mesh_world, slots):
    """TP 2 x DP 2: the segments (text, order, seconds) equal JAX's, on
    every rank, and through ``Lockstep`` from rank 0."""
    outs, refs = mesh_world
    for r, out in enumerate(outs):
        assert out[slots]["direct"] == refs[slots], r
    assert outs[0][slots]["lockstep"] == refs[slots]
    assert all(o[slots]["lockstep"] is None for o in outs[1:])


# --------------------------------------------------------- WebSocket ----

def test_handshake_accept_rfc_vector():
    # the worked example of RFC 6455 section 1.3
    assert ws_handshake_accept("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    key = base64.b64encode(os.urandom(16)).decode()
    assert ws_handshake_accept(key) == jserver.ws_handshake_accept(key)


@pytest.mark.parametrize("n", [0, 5, 125, 126, 4000, 65535, 65536, 70000])
def test_frame_codec_matches_jax(n):
    """``write_frame`` writes the JAX codec's bytes at every length class,
    and ``read_frame`` reads them back."""
    payload = os.urandom(n)
    a, b = socket.socketpair()
    c, d = socket.socketpair()
    try:
        writer = threading.Thread(target=lambda: (
            write_frame(a, OP_BINARY, payload),
            jserver.write_frame(c, OP_BINARY, payload)))
        writer.start()
        got_ours = _recv_all(b, len(payload) + 14)
        got_ref = _recv_all(d, len(payload) + 14)
        writer.join(10)
        assert got_ours == got_ref
        threading.Thread(target=lambda: a.sendall(got_ours)).start()
        assert read_frame(b) == (OP_BINARY, payload)
    finally:
        for s in (a, b, c, d):
            s.close()


def _recv_all(sock, at_most):
    """Everything one frame sent: its header then exactly its payload."""
    head = sock.recv(2)
    n = head[1] & 0x7F
    ext = b""
    if n == 126:
        ext = sock.recv(2)
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = sock.recv(8)
        n = struct.unpack(">Q", ext)[0]
    body = b""
    while len(body) < n:
        body += sock.recv(n - len(body))
    assert len(head + ext + body) <= at_most
    return head + ext + body


def _client_send(sock, opcode, payload, fin=True):
    """Client frame (masked, as RFC 6455 requires of clients)."""
    mask = os.urandom(4)
    arr = np.frombuffer(payload, np.uint8)
    mk = np.frombuffer((mask * (len(payload) // 4 + 1))[: len(payload)],
                       np.uint8)
    masked = (arr ^ mk).tobytes()
    n = len(payload)
    header = bytes([(0x80 if fin else 0) | opcode])
    if n < 126:
        header += bytes([0x80 | n])
    elif n < (1 << 16):
        header += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        header += bytes([0x80 | 127]) + struct.pack(">Q", n)
    sock.sendall(header + mask + masked)


def _connect(port, stream_id):
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /ws?stream={stream_id} HTTP/1.1\r\n"
                  f"Host: 127.0.0.1:{port}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    head = resp.decode("latin-1")
    assert "101" in head.split("\r\n")[0]
    assert ws_handshake_accept(key) in head
    return sock


@pytest.fixture
def server(pair):
    started = []

    def start(slots):
        _, st = pair(slots)
        srv = serve_streaming(st, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        started.append((srv, thread))
        return srv.server_address[1], st
    yield start
    for srv, thread in started:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
        assert not thread.is_alive()


def test_two_clients_receive_the_direct_segments(pair, server, rng):
    """Two clients stream 1.5 windows each in 0.25 s pieces and flush: each
    receives exactly the segments the direct calls return for its audio."""
    audio = {sid: (0.05 * rng.standard_normal(int(1.5 * SR))).astype("<f4")
             for sid in ("mic0", "mic1")}
    _, direct = pair(2)
    want = {}
    for sid, x in audio.items():
        direct.feed(sid, x)
        direct.flush(sid)
        want[sid] = [(s.index, s.text, s.audio_seconds)
                     for s in direct.drain()]
    port, _ = server(2)
    got = {}

    def client(sid):
        sock = _connect(port, sid)
        x = audio[sid]
        for i in range(0, len(x), SR // 4):
            _client_send(sock, OP_BINARY, x[i: i + SR // 4].tobytes())
        _client_send(sock, OP_TEXT, b"flush")
        segs = []
        while len(segs) < 2:
            op, payload = read_frame(sock)
            assert op == OP_TEXT
            seg = json.loads(payload)
            assert seg["stream"] == sid
            segs.append((seg["index"], seg["text"], seg["audio_seconds"]))
        _client_send(sock, OP_CLOSE, struct.pack(">H", 1000))
        assert read_frame(sock)[0] == OP_CLOSE
        sock.close()
        got[sid] = segs

    threads = [threading.Thread(target=client, args=(sid,)) for sid in audio]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert got == {sid: [(i, t, pytest.approx(s)) for i, t, s in v]
                   for sid, v in want.items()}
    assert got["mic0"][1][2] == pytest.approx(0.5)


def test_split_float32_across_messages(server, rng):
    """A float32 split across two binary MESSAGES is buffered byte by byte
    and still transcribes."""
    port, _ = server(2)
    sock = _connect(port, "ragged")
    audio = (0.05 * rng.standard_normal(SR)).astype("<f4").tobytes()
    _client_send(sock, OP_BINARY, audio[:6])
    _client_send(sock, OP_BINARY, audio[6:])
    op, payload = read_frame(sock)
    assert op == OP_TEXT
    seg = json.loads(payload)
    assert seg["stream"] == "ragged" and seg["index"] == 0
    _client_send(sock, OP_CLOSE, struct.pack(">H", 1000))
    sock.close()


def test_ping_between_fragments(server, rng):
    """A ping between fragments of a binary message (RFC 6455 section 5.4)
    is answered with a pong and does not leak into the samples."""
    port, st = server(1)
    sock = _connect(port, "frag")
    audio = (0.05 * rng.standard_normal(SR)).astype("<f4").tobytes()
    half = len(audio) // 2
    _client_send(sock, OP_BINARY, audio[:half], fin=False)
    _client_send(sock, 0x9, b"keepalive")
    _client_send(sock, 0x0, audio[half:])
    op, payload = read_frame(sock)
    assert op == 0xA and payload == b"keepalive"
    op, payload = read_frame(sock)
    assert op == OP_TEXT and json.loads(payload)["index"] == 0
    _client_send(sock, OP_CLOSE, struct.pack(">H", 1000))
    assert read_frame(sock)[0] == OP_CLOSE
    sock.close()


def test_bad_upgrade_is_refused(server):
    port, _ = server(1)
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(b"GET /ws HTTP/1.1\r\nHost: x\r\n\r\n")
    assert sock.recv(4096).startswith(b"HTTP/1.1 400")
    sock.close()
