"""The three-tier log-mel dispatcher and the overlap-reuse CUDA kernel K1
with its plain PyTorch version.

Port of ``audax/ops/pallas_mel.py``: ``log_mel_fused`` is the counterpart
of ``log_mel_pallas`` and picks, per config, the tier it picks
(``mel_tier``):

  1. "overlap", K1 (``log_mel_overlap``, this module) when
     ``overlap_applicable``: every in-tree preset;
  2. "packed", K4, for any other power-2 config;
  3. "generic", K5, for any power != 2
     (K4 and K5 live in ``ops/direct_mel.py``).

On the card each tier runs one of two bodies, by n_fft (``BODIES``,
``mel_body``): the FFT body (``csrc/log_mel_fft.cu``: ``rfft`` of the
windowed frame, ``|X|^power``, the banded mel, the log) where its n_fft
is listed -- in every tier the powers of two from 256 to 2048 and
Whisper's 400 (``direct_mel.FFT_SIZES``), so Whisper 80/128, UrbanSound
v1/v2, PANNs and a magnitude mel at Whisper's geometry -- and the tier's
own kernel elsewhere. Each (tier, body) pair counts its own launches
under its name in ``ops.KERNELS``. On a CPU tensor K1 and K4 keep their
own plain versions; K5 takes its bodies' plain versions by the same route
as on the card.

K1 zoom-DFTs each g-sample block of the reflect-padded signal once,
recombines frames from NB twiddle-shifted block spectra, applies the
periodic Hann window as an exact 3-tap spectral convolution, then |X|^2,
the mel projection and the log (math in
``ops/mel.py:overlap_frontend_constants``).

Each kernel's wrapper dispatches on the tensor it is given: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises. The
reflect padding, the framing view and the Whisper epilogue stay plain
PyTorch around the kernels, as the JAX package kept them in XLA around the
Pallas calls.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from audax_torch.core.config import MelConfig
from audax_torch.ops import native
from audax_torch.ops.direct_mel import (FFT_SIZES, fused_logmel_fft,
                                        fused_logmel_frames,
                                        fused_logmel_packed,
                                        fused_logmel_packed_fft_cuda,
                                        launch_fft_body)
from audax_torch.ops.mel import (fft_frontend_constants, frontend_constants,
                                 overlap_block_size,
                                 overlap_frontend_constants,
                                 packed_frontend_constants)
from audax_torch.ops.stft import apply_log

__all__ = ["BODIES", "direct_constants", "direct_frames", "fft_constants",
           "log_mel_fused",
           "log_mel_overlap", "log_mel_overlap_cuda",
           "log_mel_overlap_fft_cuda", "log_mel_overlap_plain", "mel_body",
           "mel_tier", "overlap_applicable", "whisper_post_clamp"]

#: largest shared-memory tile the wrapper plans for one block (two blocks
#: per SM fit in the H100's 228 KB)
_SMEM_TARGET = 110 * 1024


#: each tier's bodies on the card: tier -> (the n_fft its FFT body takes,
#: the kernel there, the tier's own kernel at every other n_fft), by their
#: names in ``ops.KERNELS``
BODIES = {
    "overlap": (FFT_SIZES, "log_mel_overlap_fft", "log_mel_overlap"),
    "packed": (FFT_SIZES, "log_mel_packed_fft", "log_mel_packed"),
    "generic": (FFT_SIZES, "log_mel_fft", "log_mel_generic"),
}


def whisper_post_clamp(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's per-item log-mel epilogue: clamp to (max - 8) over the last
    two axes, then (x + 4) / 4. Runs over exactly the frames the model sees,
    i.e. after the final STFT frame is dropped."""
    gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, gmax - 8.0) + 4.0) / 4.0


def overlap_applicable(cfg: MelConfig) -> bool:
    """Power spectrogram, full-width periodic Hann, g = gcd(n_fft, hop) a
    multiple of 8 with real reuse (nb > a), and a = hop / g in {1, 2}: every
    in-tree preset (UrbanSound g=128/512 a=1; Whisper g=80 a=2)."""
    if not (cfg.power == 2.0 and cfg.win == cfg.n_fft):
        return False
    g = overlap_block_size(cfg)
    nb, adv = cfg.n_fft // g, cfg.hop_length // g
    return g % 8 == 0 and adv in (1, 2) and nb > adv


def mel_tier(cfg: MelConfig) -> str:
    """The tier of ``cfg``, as ``log_mel_pallas`` picks it: "overlap"
    (K1), "packed" (K4, power 2) or "generic" (K5, power != 2)."""
    if overlap_applicable(cfg):
        return "overlap"
    return "packed" if cfg.power == 2.0 else "generic"


def mel_body(cfg: MelConfig) -> str:
    """The kernel (its name in ``ops.KERNELS``) that serves ``cfg`` on the
    card: its tier's FFT body where ``BODIES`` lists the n_fft, its own
    kernel otherwise."""
    sizes, fft, own = BODIES[mel_tier(cfg)]
    return fft if cfg.n_fft in sizes else own


@functools.lru_cache(maxsize=16)
def _constants(cfg: MelConfig, device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in overlap_frontend_constants(cfg))


def _pad(x: torch.Tensor, cfg: MelConfig):
    """[..., n] -> ([B, n_pad] float32 padded signal, lead shape, frames)."""
    lead, n = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, n).float()
    if cfg.center:
        pad = cfg.n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
        t = n // cfg.hop_length + 1
    else:
        t = max(0, (n - cfg.n_fft) // cfg.hop_length + 1)
    return x.contiguous(), lead, t


def _kernel_log(cfg: MelConfig) -> str:
    """The kernels' log: ``log1e6``, else log10 (Whisper's clamp after)."""
    return "log1e6" if cfg.log_mode == "log1e6" else "log10"


def log_mel_overlap_plain(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [..., n] -> [..., T, n_mels] raw
    log-mel (``log1e6`` mode: log(x + 1e-6); otherwise log10 floored at
    1e-10, the Whisper clamp left to ``whisper_post_clamp``)."""
    log_mel_overlap_plain.launches += 1
    sig, lead, t = _pad(x, cfg)
    g = overlap_block_size(cfg)
    nb, adv = cfg.n_fft // g, cfg.hop_length // g
    if t == 0:
        return sig.new_zeros(lead + (0, cfg.n_mels))
    dftc, dfts, tw, fb = _constants(cfg, sig.device)
    nblk = (t - 1) * adv + nb
    sig = F.pad(sig, (0, max(0, nblk * g - sig.shape[1])))[:, :nblk * g]
    blocks = sig.reshape(sig.shape[0], nblk, g)
    zr, zi = blocks @ dftc, blocks @ dfts                   # [B, nblk, F]
    xr = torch.zeros(sig.shape[0], t, cfg.n_freqs, device=sig.device)
    xi = torch.zeros_like(xr)
    for j in range(nb):
        c, s = tw[j], tw[nb + j]
        zrj = zr[:, j: j + (t - 1) * adv + 1: adv]
        zij = zi[:, j: j + (t - 1) * adv + 1: adv]
        xr = xr + c * zrj - s * zij
        xi = xi + c * zij + s * zrj
    # periodic Hann == 3-tap spectral conv with conjugate-symmetric edges
    left_r = torch.cat([xr[..., 1:2], xr[..., :-1]], -1)
    left_i = torch.cat([-xi[..., 1:2], xi[..., :-1]], -1)
    right_r = torch.cat([xr[..., 1:], xr[..., -2:-1]], -1)
    right_i = torch.cat([xi[..., 1:], -xi[..., -2:-1]], -1)
    wr = 0.5 * xr - 0.25 * (left_r + right_r)
    wi = 0.5 * xi - 0.25 * (left_i + right_i)
    mel = (wr * wr + wi * wi) @ fb
    return apply_log(mel, _kernel_log(cfg)).reshape(lead + (t, cfg.n_mels))


log_mel_overlap_plain.launches = 0


def _tile_frames(cfg: MelConfig, lib) -> int:
    g = overlap_block_size(cfg)
    nb, adv = cfg.n_fft // g, cfg.hop_length // g
    for tile in (16, 8, 4):
        if lib.log_mel_overlap_smem_bytes(tile, g, nb, adv,
                                          cfg.n_freqs) <= _SMEM_TARGET:
            return tile
    return 1


def log_mel_overlap_cuda(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """The CUDA kernel: same contract as ``log_mel_overlap_plain``."""
    if not x.is_cuda:
        raise ValueError("log_mel_overlap_cuda takes a CUDA tensor")
    if not overlap_applicable(cfg):
        raise ValueError(f"overlap kernel does not cover {cfg}")
    sig, lead, t = _pad(x, cfg)
    if t == 0:
        return sig.new_zeros(lead + (0, cfg.n_mels))
    g = overlap_block_size(cfg)
    nb, adv = cfg.n_fft // g, cfg.hop_length // g
    dftc, dfts, tw, fb = _constants(cfg, sig.device)
    lib = native.library("log_mel_overlap")
    out = torch.empty(sig.shape[0], t, cfg.n_mels, device=sig.device)
    status = lib.log_mel_overlap_f32(
        sig.data_ptr(), sig.shape[0], sig.shape[1], t, _tile_frames(cfg, lib),
        dftc.data_ptr(), dfts.data_ptr(), tw.data_ptr(), fb.data_ptr(),
        out.data_ptr(), g, nb, adv, cfg.n_freqs, cfg.n_mels,
        0 if cfg.log_mode == "log1e6" else 1,
        torch.cuda.current_stream(sig.device).cuda_stream)
    native.check(status, "log_mel_overlap")
    log_mel_overlap_cuda.launches += 1
    return out.reshape(lead + (t, cfg.n_mels))


log_mel_overlap_cuda.launches = 0


def log_mel_overlap_fft_cuda(x: torch.Tensor, cfg: MelConfig
                             ) -> torch.Tensor:
    """K1's tier on the FFT body (``csrc/log_mel_fft.cu`` at power 2, on the
    frame view of the reflect-padded signal, read in place) for an n_fft in
    ``direct_mel.FFT_SIZES``: same contract as
    ``log_mel_overlap_plain``."""
    if mel_body(cfg) != "log_mel_overlap_fft":
        raise ValueError(f"the FFT body does not serve K1's tier at n_fft "
                         f"{cfg.n_fft}: {cfg}")
    if not x.is_cuda:
        raise ValueError("log_mel_overlap_fft_cuda takes a CUDA tensor")
    frames, lead = direct_frames(x, cfg)
    mel, launched = launch_fft_body(
        frames, *fft_constants(cfg, frames.device), _kernel_log(cfg), 2.0,
        FFT_SIZES)
    log_mel_overlap_fft_cuda.launches += launched
    return mel.reshape(lead + mel.shape[1:])


log_mel_overlap_fft_cuda.launches = 0


def log_mel_overlap(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., n] -> [..., T, n_mels] raw log-mel: for a CUDA tensor the body
    ``mel_body`` names (the FFT body or the overlap kernel), the plain
    version for a CPU tensor."""
    if not x.is_cuda:
        return log_mel_overlap_plain(x, cfg)
    if mel_body(cfg) == "log_mel_overlap_fft":
        return log_mel_overlap_fft_cuda(x, cfg)
    return log_mel_overlap_cuda(x, cfg)


@functools.lru_cache(maxsize=16)
def direct_constants(cfg: MelConfig, device: torch.device):
    """K4's ``(dft, fb2)`` for power 2, else K5's ``(cos, sin, fb)``."""
    tables = (packed_frontend_constants(cfg) if cfg.power == 2.0
              else frontend_constants(cfg))
    return tuple(torch.from_numpy(a).to(device) for a in tables)


@functools.lru_cache(maxsize=16)
def fft_constants(cfg: MelConfig, device: torch.device):
    """The FFT body's ``(window, fb, ranges, twiddles)``
    (``ops/mel.py:fft_frontend_constants``)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in fft_frontend_constants(cfg))


def direct_frames(x: torch.Tensor, cfg: MelConfig):
    """``[..., n]`` -> (``[B, T, n_fft]`` frames, a view of the padded
    signal with strides ``(clip, hop, 1)``; the lead shape)."""
    sig, lead, _ = _pad(x, cfg)
    if sig.shape[-1] < cfg.n_fft:           # sub-window clip, center=False
        return sig.new_zeros(sig.shape[0], 0, cfg.n_fft), lead
    return sig.unfold(-1, cfg.n_fft, cfg.hop_length), lead


def log_mel_fused(x: torch.Tensor, cfg: MelConfig, *,
                  whisper_post: bool = True) -> torch.Tensor:
    """Log-mel of ``[..., n_samples]`` audio -> ``[..., T, n_mels]`` through
    the tier ``cfg`` calls for (overlap K1, packed K4, generic K5), on the
    card in the body ``mel_body`` names. With ``whisper_post=False`` the
    Whisper mode returns the raw log10, for the caller to trim frames and
    then apply ``whisper_post_clamp``."""
    tier, body = mel_tier(cfg), mel_body(cfg)
    if tier == "overlap":
        mel = log_mel_overlap(x, cfg)
    else:
        frames, lead = direct_frames(x, cfg)
        mode = _kernel_log(cfg)
        if body == "log_mel_fft":
            mel = fused_logmel_fft(frames, *fft_constants(cfg, frames.device),
                                   log_mode=mode, power=cfg.power)
        elif body == "log_mel_packed_fft" and frames.is_cuda:
            mel = fused_logmel_packed_fft_cuda(
                frames, *fft_constants(cfg, frames.device), log_mode=mode)
        elif tier == "packed":
            mel = fused_logmel_packed(frames,
                                      *direct_constants(cfg, frames.device),
                                      log_mode=mode)
        else:
            mel = fused_logmel_frames(frames,
                                      *direct_constants(cfg, frames.device),
                                      log_mode=mode, power=cfg.power)
        mel = mel.reshape(lead + mel.shape[1:])
    if cfg.log_mode == "whisper" and whisper_post:
        mel = whisper_post_clamp(mel)
    return mel
