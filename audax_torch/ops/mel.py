"""Mel filterbanks, windows, and real-DFT matrices (host-side numpy).

Port of ``audax/ops/mel.py``: an own copy of the log-mel frontend's
constants, so the PyTorch package imports nothing of the JAX one. The
constants are computed in float64 and rounded once to float32, exactly as
the JAX package does, so both frontends multiply by the same numbers.

Numerics match two reference parameterizations:
  * torchaudio ``MelSpectrogram`` defaults -- HTK mel scale, no filter norm.
  * Whisper/librosa -- Slaney scale, Slaney area norm.
"""

from __future__ import annotations

import math

import numpy as np

from audax_torch.core.config import MelConfig

__all__ = [
    "hz_to_mel", "mel_to_hz", "mel_filterbank", "hann_window",
    "dft_matrices", "frontend_constants", "overlap_frontend_constants",
    "overlap_block_size",
]


def hz_to_mel(freq: np.ndarray, htk: bool) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    above = freq >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(mel: np.ndarray, htk: bool) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = f_sp * mel
    above = mel >= min_log_mel
    hz = np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)
    return hz


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    *,
    htk: bool = True,
    norm_slaney: bool = False,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``[n_freqs, n_mels]``.

    ``htk=True, norm_slaney=False`` reproduces torchaudio's defaults;
    ``htk=False, norm_slaney=True`` reproduces librosa's (Whisper's) defaults.
    """
    fmax = float(fmax) if fmax else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    f_pts = mel_to_hz(m_pts, htk)

    # Triangles: rising edge from f_pts[i] to f_pts[i+1], falling to f_pts[i+2].
    slopes = f_pts[None, :] - all_freqs[:, None]              # [F, n_mels+2]
    denom_down = np.maximum(f_pts[1:-1] - f_pts[:-2], 1e-10)
    denom_up = np.maximum(f_pts[2:] - f_pts[1:-1], 1e-10)
    down = -slopes[:, :-2] / denom_down
    up = slopes[:, 2:] / denom_up
    fb = np.maximum(0.0, np.minimum(down, up))                # [F, n_mels]

    if norm_slaney:
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window / scipy periodic convention)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(dtype)


def dft_matrices(n_fft: int, window: np.ndarray | None = None, dtype=np.float32):
    """Real-DFT basis with the window folded in.

    Returns ``(cos_w, sin_w)`` of shape ``[n_fft, n_fft//2+1]`` such that for a
    frame ``x`` of length n_fft::

        real = x @ cos_w ; imag = x @ sin_w ; power = real**2 + imag**2

    equals ``|rfft(x * window)|**2``. Folding the window into the basis saves
    an elementwise pass and keeps the kernel two-matmuls-plus-epilogue.
    """
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = np.cos(ang)
    sin_m = -np.sin(ang)  # rfft convention: X_k = sum x_n exp(-i 2pi nk/N)
    if window is not None:
        cos_m = cos_m * window.astype(np.float64)[:, None]
        sin_m = sin_m * window.astype(np.float64)[:, None]
    return cos_m.astype(dtype), sin_m.astype(dtype)


def overlap_block_size(cfg: MelConfig) -> int:
    """Block size of the overlap decomposition: ``g = gcd(n_fft, hop)``.
    A frame spans ``nb = n_fft/g`` blocks and advances ``a = hop/g`` blocks
    (UrbanSound v2: g=128, nb=8, a=1; Whisper: g=80, nb=5, a=2)."""
    return math.gcd(cfg.n_fft, cfg.hop_length)


def overlap_frontend_constants(cfg: MelConfig, dtype=np.float32):
    """Constants for the overlap-reuse kernel: ``(dftc, dfts, tw, fb)``.

    The overlap-reuse STFT exploits shared samples between frames: with
    ``g = gcd(n_fft, hop)`` each g-sample signal block is zoom-DFT'd ONCE
    (``Z_b[k] = sum_n x[bg+n] e^{-2pi i kn/N}``), and frame ``t``'s
    unwindowed spectrum is recombined from its ``NB = n_fft/g`` blocks
    (advancing ``a = hop/g`` blocks per frame) with twiddles that depend
    only on ``jk mod NB``::

        X_t[k] = sum_{j<NB} e^{-2pi i jk/NB} Z_{t*a+j}[k]

    The periodic Hann window then becomes an EXACT 3-tap spectral
    convolution (its DFT has support {-1, 0, 1}):
    ``W_t[k] = 0.5 X_t[k] - 0.25 (X_t[k-1] + X_t[k+1])`` with conjugate-
    symmetric edges. Per frame, the DFT work drops NB/a-fold and the raw
    signal is read once instead of NB/a times.

    Returns dftc/dfts ``[g, F]`` (zoom-DFT bases), tw ``[2*NB, F]`` (cos
    rows then -sin rows) and fb ``[F, n_mels]`` (mel filterbank), with
    ``F = n_fft//2 + 1``. The JAX package pads F and n_mels to the TPU's
    128 lanes; the CUDA kernel reads them unpadded.
    """
    if cfg.win != cfg.n_fft:
        raise ValueError("the overlap decomposition needs win_length == n_fft")
    g, f = overlap_block_size(cfg), cfg.n_freqs
    nb = cfg.n_fft // g

    n = np.arange(g, dtype=np.float64)[:, None]
    k = np.arange(f, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    dftc = np.cos(ang)
    dfts = -np.sin(ang)

    j = np.arange(nb, dtype=np.float64)[:, None]
    angj = 2.0 * np.pi * j * k / nb
    tw = np.concatenate([np.cos(angj), -np.sin(angj)], axis=0)

    fb = mel_filterbank(f, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax,
                        htk=cfg.htk, norm_slaney=cfg.norm_slaney,
                        dtype=np.float64)
    return (dftc.astype(dtype), dfts.astype(dtype), tw.astype(dtype),
            fb.astype(dtype))


def frontend_constants(cfg: MelConfig, dtype=np.float32):
    """All host-side constants for a mel config: (cos_w, sin_w, mel_fb).

    When win_length < n_fft the window is centre-padded to n_fft with zeros,
    matching torch.stft semantics.
    """
    win = hann_window(cfg.win, dtype=np.float64)
    if cfg.win < cfg.n_fft:
        pad_l = (cfg.n_fft - cfg.win) // 2
        pad_r = cfg.n_fft - cfg.win - pad_l
        win = np.pad(win, (pad_l, pad_r))
    cos_w, sin_w = dft_matrices(cfg.n_fft, window=win, dtype=dtype)
    fb = mel_filterbank(
        cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax,
        htk=cfg.htk, norm_slaney=cfg.norm_slaney, dtype=dtype,
    )
    return cos_w, sin_w, fb
