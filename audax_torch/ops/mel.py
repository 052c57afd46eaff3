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
    "dft_matrices", "frontend_constants", "packed_frontend_constants",
    "overlap_frontend_constants", "overlap_block_size", "mel_bin_ranges",
    "fft_twiddles", "fft_twiddles_400", "fft_frontend_constants",
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


def packed_frontend_constants(cfg: MelConfig, dtype=np.float32):
    """Constants of the packed direct kernel (K4): ``(dft, fb2)``.

    Of the F = n_fft//2 + 1 bins, imag(k=0) and imag(k=Nyquist) are always
    zero, so exactly F-1 real and F-1 imaginary columns are computed, the
    Nyquist *real* basis taking the dead imag(k=0) slot::

        dft [n_fft, 2*(F-1)]:  cols [0, F-1)   = windowed cos(k=0..F-2)
                               col  [F-1]      = windowed cos(k=Nyquist)
                               cols (F, 2F-2]  = windowed -sin(k=1..F-2)
        ri  = frames @ dft ;  r2 = ri * ri      (elementwise)
        mel = r2 @ fb2                          (fb2 [2*(F-1), n_mels])

    fb2 routes each squared column to the mel rows of its bin, so
    real^2 + imag^2 is absorbed into the second product. A window shorter
    than n_fft is centre-padded with zeros, as torch.stft does.
    """
    win = hann_window(cfg.win, dtype=np.float64)
    if cfg.win < cfg.n_fft:
        pad_l = (cfg.n_fft - cfg.win) // 2
        win = np.pad(win, (pad_l, cfg.n_fft - cfg.win - pad_l))
    cos_m, sin_m = dft_matrices(cfg.n_fft, window=win, dtype=np.float64)
    f = cfg.n_freqs                       # n_fft//2 + 1
    half = f - 1                          # columns per part
    dft = np.empty((cfg.n_fft, 2 * half), dtype=np.float64)
    dft[:, :half] = cos_m[:, :half]       # k = 0..F-2 real
    dft[:, half] = cos_m[:, half]         # k = Nyquist real (imag k=0 slot)
    dft[:, half + 1:] = sin_m[:, 1:half]  # k = 1..F-2 imag

    fb = mel_filterbank(f, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax,
                        htk=cfg.htk, norm_slaney=cfg.norm_slaney,
                        dtype=np.float64)
    fb2 = np.zeros((2 * half, cfg.n_mels), dtype=np.float64)
    fb2[:half] = fb[:half]                # real^2 of k=0..F-2
    fb2[half] = fb[half]                  # Nyquist power
    fb2[half + 1:] = fb[1:half]           # imag^2 of k=1..F-2
    return dft.astype(dtype), fb2.astype(dtype)


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


def mel_bin_ranges(fb: np.ndarray) -> np.ndarray:
    """``[n_mels, 2]`` int32: for each band (column of ``fb [F, n_mels]``)
    the bins ``[lo, hi)`` from its first to its last non-zero weight, so
    that summing the band over its range is exact for any filterbank (a
    dense one gives ``[0, F)``; an all-zero band ``[0, 0)``)."""
    nz = np.asarray(fb) != 0
    f = nz.shape[0]
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, f - nz[::-1].argmax(axis=0), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def _fft_twiddle_table(n_fft: int, lanes: int, dtype) -> np.ndarray:
    """``[n_fft + 1, 2]`` (cos, -sin) in float64, rounded once: ``W_L^(j
    k2)`` at row ``k2 * lanes + j`` (``L = n_fft / 2``, ``k2 < L /
    lanes``, lane ``j < lanes``), then ``W_N^k`` for ``k = 0 .. L``."""
    half = n_fft // 2
    j = np.arange(lanes, dtype=np.float64)[None, :]
    k2 = np.arange(half // lanes, dtype=np.float64)[:, None]
    ang = np.concatenate([(2.0 * np.pi * j * k2 / half).reshape(-1),
                          2.0 * np.pi * np.arange(half + 1) / n_fft])
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)


def fft_twiddles(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Twiddle table of the FFT log-mel kernel (``csrc/log_mel_fft.cu``),
    ``[n_fft + 1, 2]`` (cos, -sin), computed in float64 and rounded once:
    first ``W_L^(j k2)`` at row ``k2 * 32 + j`` (``L = n_fft / 2`` complex
    points, ``k2 < L / 32``, lane ``j < 32``), then ``W_N^k`` for
    ``k = 0 .. L`` (``N = n_fft``)."""
    if n_fft % 64 or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft {n_fft}: the FFT kernel takes a power of "
                         "two, at least 64")
    return _fft_twiddle_table(n_fft, 32, dtype)


def fft_twiddles_400(n_fft: int = 400, dtype=np.float32) -> np.ndarray:
    """Twiddle table of the FFT log-mel kernel's mixed-radix instantiation
    for Whisper's n_fft 400 (``L = 200 = 8 x 25`` complex points: lane
    ``j < 25`` holds ``z[j + 25 p]`` for ``p < 8``), ``[401, 2]`` (cos,
    -sin), computed in float64 and rounded once: first ``W_L^(j k2)`` at
    row ``k2 * 25 + j`` (``k2 < 8``), then ``W_N^k`` for ``k = 0 .. L``,
    the table the radix-5 lane stages also take their roots from
    (``W_5 = W_N^80``, ``W_25 = W_N^16``, by conjugate symmetry past
    ``L``)."""
    if n_fft != 400:
        raise ValueError(f"n_fft {n_fft}: the mixed-radix FFT kernel takes "
                         "400 only")
    return _fft_twiddle_table(n_fft, 25, dtype)


def fft_frontend_constants(cfg: MelConfig, dtype=np.float32):
    """Constants of the FFT log-mel kernel: ``(window, fb, ranges,
    twiddles)``. ``window [n_fft]`` is the centre-padded periodic Hann that
    ``frontend_constants`` folds into its bases (``window == cos_w[:, 0]``
    exactly), ``fb [F, n_mels]`` the same filterbank, ``ranges
    [n_mels, 2]`` int32 its bands' bin ranges (``mel_bin_ranges``) and
    ``twiddles`` the table of ``fft_twiddles`` (``fft_twiddles_400`` at
    n_fft 400)."""
    win = hann_window(cfg.win, dtype=np.float64)
    if cfg.win < cfg.n_fft:
        pad_l = (cfg.n_fft - cfg.win) // 2
        win = np.pad(win, (pad_l, cfg.n_fft - cfg.win - pad_l))
    fb = mel_filterbank(
        cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax,
        htk=cfg.htk, norm_slaney=cfg.norm_slaney, dtype=dtype,
    )
    twiddles = (fft_twiddles_400(cfg.n_fft, dtype) if cfg.n_fft == 400
                else fft_twiddles(cfg.n_fft, dtype))
    return win.astype(dtype), fb, mel_bin_ranges(fb), twiddles
