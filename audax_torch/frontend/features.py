"""Public audio feature-extraction API (port of ``audax/frontend/features.py``).

``LogMelFrontend`` turns ``[..., n_samples]`` float audio into
``[..., T, n_mels]`` log-mel features:

  * UrbanSound contract -- log-mel of a 4.0 s clip ([T, n_mels] = [501, 128]
    for v2);
  * Whisper contract -- a 30 s chunk, the final STFT frame dropped so
    exactly 3000 frames remain, then Whisper's log10 / max-8 clamp / scale.
    The frame is dropped BEFORE the clamp: a loud trimmed frame must not set
    the clamp floor of the frames the model sees.

The frontend lives on one device (``None`` = the CUDA card). On CUDA the
overlap-reuse kernel (``ops/fused_mel.py``) computes the raw log-mel; on the
CPU its plain PyTorch version does. Configs the overlap kernel does not
cover (power != 2, a short window) run ``ops/stft.py:log_mel_plain`` on the
CPU; on CUDA they raise until the packed and generic kernels are ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audax_torch.core.config import MelConfig
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.ops.fused_mel import (log_mel_overlap, overlap_applicable,
                                       whisper_post_clamp)
from audax_torch.ops.stft import log_mel_plain

__all__ = ["LogMelFrontend", "pad_or_trim"]


def pad_or_trim(x: torch.Tensor, n_samples: int, axis: int = -1) -> torch.Tensor:
    """Zero-pad or cut to exactly ``n_samples`` along ``axis``."""
    n = x.shape[axis]
    if n > n_samples:
        return x.narrow(axis, 0, n_samples)
    if n < n_samples:
        axis = axis % x.ndim
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, n_samples - n]
        return F.pad(x, pad)
    return x


class LogMelFrontend:
    """Batched waveform -> log-mel features on one device.

    Call with ``[..., n_samples]`` float audio (a tensor or a numpy array)
    at ``cfg.sample_rate``; returns ``[..., T, n_mels]`` on the frontend's
    device (``mel_first=True`` gives the reference's ``[n_mels, T]``).
    """

    def __init__(self, cfg: Optional[MelConfig] = None, *,
                 device: DeviceLike = None, whisper_frames: bool = False):
        self.cfg = cfg or MelConfig()
        self.device = resolve_device(device)
        #: Whisper drops the final centre-padded STFT frame so 30 s -> 3000.
        self.whisper_frames = whisper_frames

    @classmethod
    def whisper(cls, n_mels: int = 80, **kw) -> "LogMelFrontend":
        return cls(MelConfig.whisper(n_mels), whisper_frames=True, **kw)

    @classmethod
    def urbansound(cls, version: int = 2, **kw) -> "LogMelFrontend":
        cfg = MelConfig.urbansound_v2() if version == 2 else MelConfig.urbansound_v1()
        return cls(cfg, **kw)

    def _raw(self, audio: torch.Tensor, whisper_post: bool) -> torch.Tensor:
        if overlap_applicable(self.cfg):
            mel = log_mel_overlap(audio, self.cfg)
            if self.cfg.log_mode == "whisper" and whisper_post:
                mel = whisper_post_clamp(mel)
            return mel
        if audio.is_cuda:
            raise NotImplementedError(
                f"{self.cfg} needs the packed or generic log-mel kernel "
                "(pallas_mel.py K4/K5), which a later slice of the port "
                "brings; pass device='cpu' for the plain path")
        return log_mel_plain(audio, self.cfg, whisper_post=whisper_post)

    def __call__(self, audio, *, mel_first: bool = False) -> torch.Tensor:
        if isinstance(audio, np.ndarray):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        audio = audio.to(self.device, torch.float32)
        mel = self._raw(audio, whisper_post=not self.whisper_frames)
        if self.whisper_frames:
            mel = mel[..., :-1, :]
            if self.cfg.log_mode == "whisper":
                mel = whisper_post_clamp(mel)
        if mel_first:
            mel = mel.transpose(-1, -2)
        return mel

    def num_frames(self, n_samples: int) -> int:
        t = self.cfg.frames_for(n_samples)
        return t - 1 if self.whisper_frames else t
