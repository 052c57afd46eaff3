"""Framing and the plain direct-DFT log-mel (port of ``audax/ops/stft.py``).

``log_mel_plain`` is the twin of the JAX package's ``log_mel_xla``: frame the
centre-padded signal, multiply by the windowed DFT bases, square, project on
the mel filterbank, take the log. It is correct for every ``MelConfig``
(any power, window or hop) and is the oracle the overlap kernel's plain
version is held against in the tests. It runs on whatever device its input
lives on, in float32 (TF32 is off on CUDA, ``core/runtime.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from audax_torch.core.config import MelConfig
from audax_torch.ops.mel import frontend_constants

__all__ = ["frame_signal", "log_mel_plain", "apply_log", "num_frames"]


def num_frames(cfg: MelConfig, n_samples: int) -> int:
    return cfg.frames_for(n_samples)


def frame_signal(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[..., n_samples] -> [..., T, n_fft] overlapping frames (a view of the
    padded signal). With center=True, reflect-pads n_fft//2 on both sides so
    frame ``t`` is centred on sample ``t*hop`` (torch.stft convention)."""
    if cfg.center:
        lead, n = x.shape[:-1], x.shape[-1]
        pad = cfg.n_fft // 2
        x = F.pad(x.reshape(-1, 1, n), (pad, pad), mode="reflect")
        x = x.reshape(lead + (n + 2 * pad,))
    return x.unfold(-1, cfg.n_fft, cfg.hop_length)


def apply_log(mel: torch.Tensor, mode: str) -> torch.Tensor:
    """Log compression variants; the Whisper max-clamp is per item (over the
    last two axes)."""
    if mode == "log1e6":
        return torch.log(mel + 1e-6)
    if mode == "log10":
        return torch.log10(torch.clamp_min(mel, 1e-10))
    if mode == "whisper":
        log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
        gmax = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, gmax - 8.0)
        return (log_spec + 4.0) / 4.0
    raise ValueError(f"unknown log mode: {mode}")


@functools.lru_cache(maxsize=16)
def _constants(cfg: MelConfig, device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in frontend_constants(cfg))


def log_mel_plain(x: torch.Tensor, cfg: MelConfig, *,
                  whisper_post: bool = True) -> torch.Tensor:
    """Direct-DFT log-mel: [..., n_samples] -> [..., T, n_mels] float32.

    ``whisper_post=False`` returns the raw log10 for the Whisper mode; the
    caller trims frames and then applies ``fused_mel.whisper_post_clamp``."""
    cos_w, sin_w, fb = _constants(cfg, x.device)
    frames = frame_signal(x.float(), cfg)                    # [..., T, n_fft]
    real = frames @ cos_w
    imag = frames @ sin_w
    power = real * real + imag * imag
    if cfg.power != 2.0:
        power = torch.pow(torch.sqrt(torch.clamp_min(power, 0.0)), cfg.power)
    mel = power @ fb
    mode = cfg.log_mode
    if mode == "whisper" and not whisper_post:
        mode = "log10"
    return apply_log(mel, mode)
