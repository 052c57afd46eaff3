"""Model FLOPs, frozen here so that no change to the program moves them.

The training formulas are a copy of ``audax_torch/utils/flops.py``'s
forward counts (2mnk a product; attention's scores and PV over the full
square, as that file counts them), with a step counted as 3 forwards
whatever the remat policy: recomputation is the program's cost, not model
work. Serving counts each clip's encoder pass and cross K/V once at admit,
and each decoder position over the keys it attends (itself and those
before it) and the 1500 encoder states.
"""

from __future__ import annotations


def encoder_fwd(cfg: dict, batch: int = 1) -> float:
    """Conv stem + the encoder layers, one forward of ``batch`` clips."""
    s, d, m = cfg["max_source_positions"], cfg["d_model"], cfg["num_mel_bins"]
    ff = cfg["encoder_ffn_dim"]
    stem = 2 * (2 * s) * d * (m * 3) + 2 * s * d * (d * 3)
    per_layer = 8 * s * d * d + 4 * s * d * ff + 4 * s * s * d
    return float(batch) * (stem + cfg["encoder_layers"] * per_layer)


def decoder_fwd(cfg: dict, batch: int, label_len: int) -> float:
    """Teacher-forced decoder over ``label_len`` tokens and the tied head."""
    s, d, t = cfg["max_source_positions"], cfg["d_model"], label_len
    ff = cfg["decoder_ffn_dim"]
    per_layer = (8 * t * d * d + 4 * t * t * d + 4 * t * d * d
                 + 4 * s * d * d + 4 * t * s * d + 4 * t * d * ff)
    head = 2 * t * d * cfg["vocab_size"]
    return float(batch) * (cfg["decoder_layers"] * per_layer + head)


def train_step(cfg: dict, batch: int, label_len: int) -> float:
    """One optimizer step: forward + backward = 3 forwards."""
    return 3.0 * (encoder_fwd(cfg, batch) + decoder_fwd(cfg, batch, label_len))


def cross_kv(cfg: dict) -> float:
    """A clip's cross-attention K and V over every decoder layer."""
    s, d = cfg["max_source_positions"], cfg["d_model"]
    return float(cfg["decoder_layers"] * 4 * s * d * d)


def decode_positions(cfg: dict, n: int) -> float:
    """Decoder positions 0 .. n-1 of one request, each over itself and the
    positions before it, the encoder states and the tied head."""
    s, d = cfg["max_source_positions"], cfg["d_model"]
    ff = cfg["decoder_ffn_dim"]
    dense = 8 * d * d + 4 * d * d + 4 * d * ff
    keys = n * (n + 1) // 2                      # sum over positions of p+1
    per_layer = n * dense + 4 * d * keys + n * 4 * s * d
    return float(cfg["decoder_layers"] * per_layer
                 + n * 2 * d * cfg["vocab_size"])
