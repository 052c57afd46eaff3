"""Host audio I/O: WAV codec and resampling in numpy (own copy of
``audax/data/audio_io.py``: ``read_wav``, ``write_wav``, ``to_mono``,
``resample``).

Supports PCM 8/16/24/32, float32/64 and WAVE_FORMAT_EXTENSIBLE
(``decode_wav`` parses the bytes of a file already in memory, as an HTTP
upload is). Resampling is windowed-sinc polyphase (kaiser), the same filter
design as the JAX package's. Compressed containers (m4a/AAC, mp3, ogg,
flac) need the native C++ decoder of ``audax/native``, which a later slice
of the port brings with ``read_audio`` and ``memo_to_wav``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

__all__ = ["read_wav", "decode_wav", "is_wav", "write_wav", "resample",
           "to_mono"]

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def is_wav(data: bytes) -> bool:
    """True when ``data`` opens with a RIFF/WAVE header."""
    return data[:4] == b"RIFF" and data[8:12] == b"WAVE"


def read_wav(path: str, *, with_bits: bool = False):
    """Read a WAV file -> (float32 samples [n, channels] in [-1, 1], rate).

    ``with_bits=True`` additionally returns the source PCM bit depth (0 for
    IEEE-float sources)."""
    with open(path, "rb") as fh:
        return decode_wav(fh.read(), path, with_bits=with_bits)


def decode_wav(data: bytes, name: str = "<bytes>", *,
               with_bits: bool = False):
    """``read_wav`` of the file's bytes; ``name`` labels errors."""
    path = name
    if not is_wav(data):
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, end = 12, min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    fmt = None
    samples = None
    while pos + 8 <= end:
        cid, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                sub = struct.unpack_from("<H", body, 24)[0]
                fmt = (sub,) + fmt[1:]
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, channels, rate, _, _, bits = fmt
    if tag == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8)
            n = len(raw) // 3
            ints = (raw[: n * 3].reshape(n, 3) @ np.array([1, 256, 65536],
                                                          dtype=np.int64))
            ints = np.where(ints >= 2 ** 23, ints - 2 ** 24, ints)
            x = ints.astype(np.float32) / float(2 ** 23)
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            dt = "<f4"
        elif bits == 64:
            dt = "<f8"
        else:
            raise ValueError(
                f"{path}: IEEE-float WAV must be 32 or 64 bit, got {bits}")
        x = np.frombuffer(samples, dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format tag 0x{tag:04x}")
    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    if with_bits:
        return x, rate, (0 if tag == _WAVE_FORMAT_IEEE_FLOAT else bits)
    return x, rate


def write_wav(path: str, x: np.ndarray, rate: int, *, bits: int = 16) -> None:
    """Write float samples [n] or [n, ch] as PCM16 (default) or float32 WAV."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]
    if bits == 16:
        body = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        tag, bytes_per = _WAVE_FORMAT_PCM, 2
    elif bits == 32:
        body = x.astype("<f4").tobytes()
        tag, bytes_per = _WAVE_FORMAT_IEEE_FLOAT, 4
    else:
        raise ValueError(f"bits must be 16 or 32, got {bits}")
    block = channels * bytes_per
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(body), b"WAVE", b"fmt ", 16,
        tag, channels, rate, rate * block, block, bytes_per * 8,
        b"data", len(body))
    with open(path, "wb") as fh:
        fh.write(hdr + body)


def to_mono(x: np.ndarray) -> np.ndarray:
    """[n, ch] -> [n] mean downmix."""
    if x.ndim == 2:
        return x.mean(axis=1)
    return x


def resample(x: np.ndarray, orig_rate: int, new_rate: int,
             *, zeros: int = 24, beta: float = 9.0) -> np.ndarray:
    """Polyphase windowed-sinc resampling of a 1-D signal (kaiser window),
    exact for ``orig_rate == new_rate``. Backed by scipy's polyphase engine
    with an explicit kaiser-windowed sinc so the filter design is pinned
    here."""
    if orig_rate == new_rate:
        return np.asarray(x, dtype=np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(orig_rate, new_rate)
    up, down = new_rate // g, orig_rate // g
    # sinc lowpass at min(orig,new)/2 on the up-sampled grid, `zeros`
    # zero-crossings per side, kaiser(beta) windowed, DC gain `up`
    cutoff = 0.5 * min(1.0, up / down)
    half = int(math.ceil(zeros * up / (2.0 * cutoff)))
    taps = np.arange(-half, half + 1, dtype=np.float64)
    h = 2.0 * cutoff / up * np.sinc(2.0 * cutoff * taps / up)
    h *= np.kaiser(len(h), beta)
    h /= h.sum()  # unity DC gain; resample_poly applies the x`up` itself
    y = resample_poly(np.asarray(x, dtype=np.float64), up, down, window=h)
    expected = int(math.ceil(len(x) * up / down))
    return y[:expected].astype(np.float32)
