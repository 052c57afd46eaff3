"""SpecAugment time/frequency masking on a log-mel batch (port of
``audax/ops/augment.py``).

Masks are drawn from a ``torch.Generator`` on the batch's device, so a run
is deterministic for its seed; the JAX package's ``jax.random`` streams
cannot be matched, so the masks themselves differ from its masks.
"""

from __future__ import annotations

import torch

__all__ = ["spec_augment", "SHORT_CLIP_TIME_WIDTH", "SHORT_CLIP_FREQ_WIDTH"]

#: mask widths for short (few-second) clips: the 30 s-window defaults below
#: (40/16) would blank a third of a 3-6 s clip's frames
SHORT_CLIP_TIME_WIDTH = 24
SHORT_CLIP_FREQ_WIDTH = 12


def _mask_axis(generator: torch.Generator, x: torch.Tensor, axis_len: int,
               max_width: int, n_masks: int, axis: int,
               fill: torch.Tensor) -> torch.Tensor:
    """Apply ``n_masks`` random-width contiguous masks along ``axis``, each
    drawn per example."""
    b = x.shape[0]
    idx = torch.arange(axis_len, device=x.device)
    out = x
    for _ in range(n_masks):
        width = torch.randint(0, max_width + 1, (b,), generator=generator,
                              device=x.device)
        # start uniform in [0, max(axis_len - width, 1))
        hi = torch.clamp_min(axis_len - width, 1)
        u = torch.rand(b, generator=generator, device=x.device)
        start = torch.minimum((u * hi).long(), hi - 1)
        mask = (idx[None, :] >= start[:, None]) & \
            (idx[None, :] < (start + width)[:, None])
        shape = [b] + [1] * (x.dim() - 1)
        shape[axis] = axis_len
        out = torch.where(mask.reshape(shape), fill, out)
    return out


def spec_augment(generator: torch.Generator, mel: torch.Tensor, *,
                 time_masks: int = 2, freq_masks: int = 2,
                 max_time_width: int = 40,
                 max_freq_width: int = 16) -> torch.Tensor:
    """mel [B, T, n_mels] -> the batch with random time spans and mel bands
    set to the per-example mean value (the mean rather than zero keeps the
    log-domain statistics). ``generator`` must live on mel's device."""
    b, t, m = mel.shape
    fill = mel.mean(dim=(1, 2), keepdim=True)
    out = _mask_axis(generator, mel, t, max_time_width, time_masks, axis=1,
                     fill=fill)
    return _mask_axis(generator, out, m, max_freq_width, freq_masks, axis=2,
                      fill=fill)
