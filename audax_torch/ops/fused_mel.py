"""Overlap-reuse log-mel: the CUDA kernel K1 and its plain PyTorch version.

Port of ``audax/ops/pallas_mel.py``'s overlap tier (``log_mel_overlap``,
``overlap_applicable``) and of ``whisper_post_clamp``. Each g-sample block
of the reflect-padded signal is zoom-DFT'd once, frames are recombined from
NB twiddle-shifted block spectra, the periodic Hann window is applied as an
exact 3-tap spectral convolution, then |X|^2, the mel projection and the log
(math in ``ops/mel.py:overlap_frontend_constants``).

``log_mel_overlap`` dispatches on the tensor it is given: a CPU tensor takes
``log_mel_overlap_plain``; a CUDA tensor launches the kernel of
``csrc/log_mel_overlap.cu`` or raises. The reflect padding and the Whisper
epilogue stay plain PyTorch around the kernel, as the JAX package kept
them in XLA around the Pallas call.

The packed (K4) and generic (K5) tiers for configs the overlap kernel does
not cover are not ported yet; ``frontend/features.py`` runs those configs
through ``ops/stft.py:log_mel_plain`` on the CPU and raises on CUDA.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from audax_torch.core.config import MelConfig
from audax_torch.ops import native
from audax_torch.ops.mel import overlap_block_size, overlap_frontend_constants

__all__ = ["log_mel_overlap", "log_mel_overlap_cuda", "log_mel_overlap_plain",
           "overlap_applicable", "whisper_post_clamp"]

#: largest shared-memory tile the wrapper plans for one block (two blocks
#: per SM fit in the H100's 228 KB)
_SMEM_TARGET = 110 * 1024


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


def _log(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    if cfg.log_mode == "log1e6":
        return torch.log(mel + 1e-6)
    return torch.log10(torch.clamp_min(mel, 1e-10))


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
    return _log(mel, cfg).reshape(lead + (t, cfg.n_mels))


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


def log_mel_overlap(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., n] -> [..., T, n_mels] raw log-mel: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return log_mel_overlap_cuda(x, cfg)
    return log_mel_overlap_plain(x, cfg)
