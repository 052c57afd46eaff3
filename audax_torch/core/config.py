"""Typed configuration with environment overlay (port of ``audax/core/config.py``).

Own copy of the parts the Whisper transcription and fine-tuning paths need:
``EnvConfig`` (the ``from_env`` overlay and the artifact ``stamp``),
``MelConfig`` with the UrbanSound and Whisper presets, ``WhisperConfig``
with the published tiny .. large-v3-turbo family, and ``FineTuneConfig``.
Field names and defaults match the JAX package so a config can be rebuilt
from the other's ``asdict()``.

The JAX ``MelConfig.matmul_precision`` field is not carried: every matmul of
the port's log-mel runs in full float32 (the port's kernels do not use TF32,
and ``core/runtime.py`` turns TF32 off for the library calls around them).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, fields, replace
from typing import Any, Dict, Optional, Tuple, Type, TypeVar

T = TypeVar("T", bound="EnvConfig")

__all__ = ["EnvConfig", "MelConfig", "WhisperConfig", "FineTuneConfig",
           "replace"]


def _coerce(raw: str, typ: Any) -> Any:
    if typ is bool or typ == "bool":
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if typ is int or typ == "int":
        return int(raw)
    if typ is float or typ == "float":
        return float(raw)
    if typ in (Tuple[int, ...], "Tuple[int, ...]"):
        return tuple(int(v) for v in raw.replace(",", " ").split())
    # Optional[str] and str fall through
    return raw


@dataclass(frozen=True)
class EnvConfig:
    """Base class: ``from_env`` overlays ``{PREFIX}{FIELD}`` env vars on defaults."""

    ENV_PREFIX = ""

    @classmethod
    def from_env(cls: Type[T], env: Optional[Dict[str, str]] = None,
                 **overrides: Any) -> T:
        source = dict(os.environ)
        if env:
            source.update(env)
        kwargs: Dict[str, Any] = {}
        for f in fields(cls):
            for key in (cls.ENV_PREFIX + f.name.upper(), f.name.upper()):
                if key in source:
                    kwargs[f.name] = _coerce(source[key], f.type)
                    break
        kwargs.update(overrides)
        return cls(**kwargs)

    def stamp(self, keys: Optional[Tuple[str, ...]] = None) -> str:
        """Config-stamped artifact-name fragment."""
        items = []
        for f in fields(self):
            if keys is not None and f.name not in keys:
                continue
            v = getattr(self, f.name)
            if isinstance(v, (int, float, str, bool)):
                items.append(f"{f.name.replace('_', '')}{v}")
        return "_".join(items)

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class MelConfig(EnvConfig):
    """Log-mel frontend parameterization.

      * UrbanSound v2: sr 16000, n_fft 1024, hop 128, n_mels 128, HTK mel
        scale, no filter norm, log(x + 1e-6).
      * Whisper: sr 16000, n_fft 400, hop 160, n_mels 80/128, Slaney scale +
        norm, log10 with max-8 clamp then (x+4)/4.
    """

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 128
    win_length: int = 0          # 0 -> n_fft
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float = 8000.0
    power: float = 2.0
    htk: bool = True             # torchaudio default mel scale
    norm_slaney: bool = False    # Slaney area-normalization of filters
    log_mode: str = "log1e6"     # "log1e6" | "whisper" | "log10"
    center: bool = True          # reflect-pad so frame t is centered at t*hop

    @property
    def win(self) -> int:
        return self.win_length or self.n_fft

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def frames_for(self, n_samples: int) -> int:
        if self.center:
            return n_samples // self.hop_length + 1
        return max(0, (n_samples - self.n_fft) // self.hop_length + 1)

    @classmethod
    def urbansound_v2(cls) -> "MelConfig":
        return cls()

    @classmethod
    def urbansound_v1(cls) -> "MelConfig":
        return cls(n_mels=64, hop_length=512)

    @classmethod
    def whisper(cls, n_mels: int = 80) -> "MelConfig":
        return cls(
            n_fft=400, hop_length=160, n_mels=n_mels, fmax=8000.0,
            htk=False, norm_slaney=True, log_mode="whisper",
        )


@dataclass(frozen=True)
class WhisperConfig(EnvConfig):
    """Whisper-family encoder-decoder dims (published tiny .. large-v3)."""

    n_mels: int = 80
    n_audio_ctx: int = 1500      # 3000 mel frames / conv stride 2
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 6
    vocab_size: int = 51865
    n_text_ctx: int = 448
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls(d_model=384, encoder_layers=4, decoder_layers=4, heads=6)

    @classmethod
    def base(cls) -> "WhisperConfig":
        return cls(d_model=512, encoder_layers=6, decoder_layers=6, heads=8)

    @classmethod
    def small(cls) -> "WhisperConfig":
        return cls(d_model=768, encoder_layers=12, decoder_layers=12, heads=12)

    @classmethod
    def medium(cls) -> "WhisperConfig":
        return cls(d_model=1024, encoder_layers=24, decoder_layers=24,
                   heads=16)

    @classmethod
    def large_v3(cls) -> "WhisperConfig":
        return cls(n_mels=128, d_model=1280, encoder_layers=32,
                   decoder_layers=32, heads=20, vocab_size=51866)

    @classmethod
    def large_v3_turbo(cls) -> "WhisperConfig":
        # the distilled 4-decoder-layer large-v3 ("turbo")
        return cls(n_mels=128, d_model=1280, encoder_layers=32,
                   decoder_layers=4, heads=20, vocab_size=51866)


@dataclass(frozen=True)
class FineTuneConfig(EnvConfig):
    """Seq2seq fine-tune knobs (reference: AB/fineTune.py:162-183)."""

    batch_size: int = 16
    learning_rate: float = 1e-5
    warmup_steps: int = 10
    max_steps: int = 50
    eval_every: int = 10
    gradient_checkpointing: bool = True
    # microbatches per optimizer step (gradient_accumulation_steps,
    # AB/fineTune.py:165); batch_size must be divisible by it
    accum_steps: int = 1
    lora_rank: int = 0           # 0 = full fine-tune; >0 = LoRA adapters
    # train-loop losses are fetched from the device in chunks of this many
    # steps (a per-step host read waits for the device every step); 1
    # restores per-step fetching
    loss_fetch_every: int = 8
    lora_alpha: float = 16.0
    label_pad_id: int = -100
    seed: int = 0
    # compute dtype for the train step ("float32" | "bfloat16"): master
    # weights stay float32 either way
    dtype: str = "float32"
    # Adam moment STORAGE dtype ("float32" | "bfloat16" | "int8"): update
    # math and master weights stay float32. The port carries float32 and
    # bfloat16; int8 arrives with a later slice
    moment_dtype: str = "bfloat16"
    # >0 keeps an EMA average of the trainable params (train/ema.py) with
    # this decay; WER eval + best-checkpoint then use the averaged weights
    ema_decay: float = 0.0
    # SpecAugment time/frequency masking on the train-batch mels
    # (ops/augment.py); eval always runs unaugmented
    spec_augment: bool = False
    sa_time_masks: int = 2
    sa_freq_masks: int = 2
    sa_max_time_width: int = 40
    sa_max_freq_width: int = 16
