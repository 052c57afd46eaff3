"""Analytic FLOPs of Whisper seq2seq training steps (port of
``audax/utils/flops.py``, over the port's own ``WhisperConfig``).

Why not count them: ``utils/profiling.py:step_flops`` (PyTorch's
``FlopCounterMode``) sees PyTorch's matmuls and convolutions but not the
port's own CUDA kernels, called through ``ctypes`` -- the flash attention of
every layer is missing from its count. (The JAX package had the mirror
problem: XLA's cost model counts a scanned layer body once.) These formulas
give the standard "model FLOPs" convention instead:

  * forward: dense matmul + attention FLOPs (2mnk per matmul);
  * backward: 2x forward (dL/dW and dL/dx per matmul);
  * remat="full": +1x forward recompute (3x -> 4x total);
    remat="dots" saves matmul outputs, recomputing only elementwise ops --
    counted as no extra matmul FLOPs (the standard convention).

MFU computed from these is the community definition (achieved model FLOPs
/ peak), comparable across frameworks.
"""

from __future__ import annotations

from audax_torch.core.config import WhisperConfig

__all__ = ["whisper_encoder_fwd_flops", "whisper_decoder_fwd_flops",
           "whisper_train_step_flops"]


def whisper_encoder_fwd_flops(cfg: WhisperConfig, batch: int) -> float:
    """Conv stem + L encoder layers, per forward pass."""
    s, d, m = cfg.n_audio_ctx, cfg.d_model, cfg.n_mels
    stem = 2 * (2 * s) * d * (m * 3) + 2 * s * d * (d * 3)   # conv1 + conv2
    per_layer = (8 * s * d * d        # q,k,v,out projections (2*S*d*d each)
                 + 16 * s * d * d     # mlp in/out (d -> 4d -> d)
                 + 4 * s * s * d)     # scores + PV (2*S*S*d each)
    return float(batch) * (stem + cfg.encoder_layers * per_layer)


def whisper_decoder_fwd_flops(cfg: WhisperConfig, batch: int,
                              label_len: int) -> float:
    """Teacher-forced decoder over T label tokens + LM head."""
    s, d, t = cfg.n_audio_ctx, cfg.d_model, label_len
    per_layer = (8 * t * d * d        # self q,k,v,out
                 + 4 * t * t * d      # self scores + PV
                 + 4 * t * d * d      # cross q + out
                 + 4 * s * d * d      # cross k,v over encoder states
                 + 4 * t * s * d      # cross scores + PV
                 + 16 * t * d * d)    # mlp
    head = 2 * t * d * cfg.vocab_size
    return float(batch) * (cfg.decoder_layers * per_layer + head)


def whisper_train_step_flops(cfg: WhisperConfig, batch: int, label_len: int,
                             remat="none", lora: bool = False) -> float:
    """One optimizer step's model FLOPs: (1 fwd + 2 bwd [+1 remat fwd]).

    ``remat``: "none"/False -> 3x fwd, "full"/True -> 4x fwd, "dots" ->
    3x fwd (matmul outputs saved; recompute is elementwise only).
    ``lora=True``: frozen base weights need no dL/dW, so the backward is
    ~1x fwd (activation grads only; adapter dW is rank-r, negligible) --
    2x fwd total, +1x under full remat.
    Optimizer elementwise update FLOPs are negligible next to the matmuls
    and excluded (standard convention)."""
    fwd = (whisper_encoder_fwd_flops(cfg, batch)
           + whisper_decoder_fwd_flops(cfg, batch, label_len))
    mult = 2.0 if lora else 3.0
    if remat in (True, "full"):
        mult += 1.0
    return mult * fwd
