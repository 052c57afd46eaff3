"""Random Whisper weights made from a seed, on the device, in a few draws.

The tree has the layout ``audax_torch.models.whisper`` reads (stacked
layers, dense kernels ``[d_in, d_out]``, conv kernels ``[C_out, C_in, 3]``)
and the reference in ``benchmark/reference`` reads by the same keys. Every
leaf of one scale is a view into one buffer that a single ``normal_`` call
fills from a ``torch.Generator`` on the leaves' device, so making the 809M
parameters of large-v3-turbo takes a handful of launches. Biases and norm
gains are drawn too, so a path that drops one shows in the comparison.

The end-of-text row of the tied token embedding is zero: its logit is
exactly 0 against ~51k random ones, so greedy decoding never ends a
request before its drawn budget.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch


def whisper_dims(cfg: dict) -> dict:
    """The model sizes of a configuration file (Hugging Face keys)."""
    return {
        "d": cfg["d_model"], "ff": cfg["encoder_ffn_dim"],
        "n_mels": cfg["num_mel_bins"], "heads": cfg["encoder_attention_heads"],
        "enc_layers": cfg["encoder_layers"],
        "dec_layers": cfg["decoder_layers"], "vocab": cfg["vocab_size"],
        "n_audio": cfg["max_source_positions"],
        "n_text": cfg["max_target_positions"], "eot": cfg["eos_token_id"],
    }


def sinusoid(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder positions (log-spaced timescales)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _spec(dims: dict) -> dict:
    """Nested dict of leaves: (shape, kind, std). kind "normal" draws
    std * N(0, 1); "gain" draws 1 + std * N(0, 1); "sinusoid" is fixed."""
    d, f, m = dims["d"], dims["ff"], dims["n_mels"]

    def dense(n, d_in, d_out, bias=True):
        p = {"kernel": ((n, d_in, d_out), "normal", 1.0 / math.sqrt(d_in))}
        if bias:
            p["bias"] = ((n, d_out), "normal", 0.02)
        return p

    def ln(*lead):
        return {"scale": ((*lead, d), "gain", 0.05),
                "bias": ((*lead, d), "normal", 0.02)}

    def attn(n):
        return {"q": dense(n, d, d), "k": dense(n, d, d, bias=False),
                "v": dense(n, d, d), "out": dense(n, d, d)}

    def blocks(n, cross):
        p = {"attn_ln": ln(n), "attn": attn(n), "mlp_ln": ln(n),
             "mlp_in": dense(n, d, f), "mlp_out": dense(n, f, d)}
        if cross:
            p["cross_ln"] = ln(n)
            p["cross_attn"] = attn(n)
        return p

    return {
        "encoder": {
            "conv1": {"kernel": ((d, m, 3), "normal", 1.0 / math.sqrt(3 * m)),
                      "bias": ((d,), "normal", 0.02)},
            "conv2": {"kernel": ((d, d, 3), "normal", 1.0 / math.sqrt(3 * d)),
                      "bias": ((d,), "normal", 0.02)},
            "pos": ((dims["n_audio"], d), "sinusoid", 0.0),
            "layers": blocks(dims["enc_layers"], cross=False),
            "ln": ln(),
        },
        "decoder": {
            "embed": ((dims["vocab"], d), "normal", 0.02),
            "pos": ((dims["n_text"], d), "normal", 0.01),
            "layers": blocks(dims["dec_layers"], cross=True),
            "ln": ln(),
        },
    }


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_whisper(cfg: dict, seed: int, *, dtype=torch.bfloat16,
                 device="cuda") -> dict:
    """The weight tree of configuration ``cfg`` drawn from ``seed``: the
    same seed gives the same tensors on the same device."""
    dims = whisper_dims(cfg)
    spec = _spec(dims)
    groups = defaultdict(list)            # (kind, std) -> [(path, shape)]
    for path, (shape, kind, std) in _walk(spec):
        groups[(kind, std)].append((path, shape))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    # a fixed order of draws, so the generator's stream is the seed's alone
    for (kind, std) in sorted(groups, key=lambda k: (k[0], k[1])):
        leaves = groups[(kind, std)]
        sizes = [math.prod(s) for _, s in leaves]
        if kind == "sinusoid":
            for path, shape in leaves:
                _put(tree, path, torch.from_numpy(sinusoid(*shape)).to(
                    device=device, dtype=dtype))
            continue
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        buf.normal_(0.0, std, generator=gen)
        if kind == "gain":
            buf.add_(1.0)
        for (path, shape), piece in zip(leaves, torch.split(buf, sizes)):
            _put(tree, path, piece.view(shape))
    tree["decoder"]["embed"][dims["eot"]].zero_()
    return _order_like(spec, tree)


def _order_like(spec: dict, tree: dict) -> dict:
    """``tree`` with the key order of ``spec`` (the program's tree order)."""
    return {k: (_order_like(v, tree[k]) if isinstance(v, dict) else tree[k])
            for k, v in spec.items()}

