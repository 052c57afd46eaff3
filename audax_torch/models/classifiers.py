"""UrbanSound8K classifier family as ``nn.Module``\\ s (port of
``audax/models/classifiers.py``).

* ``CNNClassifier``: 1D CNN over log-mel frames with mel bins as channels
  (four conv blocks 128/256/512/512 of conv k3 -> BatchNorm -> ReLU ->
  max-pool 2 -> dropout, global average pool over time, 256 -> 128 -> 10
  MLP head).
* ``TransformerClassifier``: post-LN encoder-only classifier with a CLS
  token (``pool="cls"``) or mean pooling (``"mean"``) and a learned
  positional embedding of ``max_len`` rows.
* ``WaveformCNNClassifier``: raw-waveform 1D CNN (front conv k80 s16).

Inputs keep the JAX package's feature-last layout: ``[B, T, n_mels]``
(waveforms ``[B, n]`` or ``[B, n, 1]``); the convolutions run on a
``[B, C, T]`` transpose inside. The input width is a constructor argument
(``n_mels``), where flax infers it at init. Every submodule and parameter
carries the flax name (``_ConvBlock_0.Conv_0.kernel``,
``_EncoderLayer_0.MultiHeadDotProductAttention_0.query.kernel``, ...), so
``models/bridge.py:classifier_from_numpy`` maps a flax variable tree by
name. Layouts: dense kernels ``[in, out]`` (``y = x @ kernel + bias``),
conv kernels ``[C_out, C_in, k]``, the attention projections
``[dim, heads * head_dim]`` and ``[heads * head_dim, dim]``.

Flax semantics kept on purpose:

* GELU is the tanh approximation; LayerNorm's epsilon is 1e-6; both norms
  take the variance as ``E[x^2] - E[x]^2`` (flax's fast variance).
* BatchNorm reduces over batch and time, updates its running statistics
  with momentum 0.99 and the biased batch variance, epsilon 1e-5.
* The k3 convs pad 1 on each side and have no bias; the k80/s16 front conv
  pads as flax's SAME does, asymmetrically (low half ``total // 2``).
* Max-pooling drops an odd tail frame (VALID).
* Attention scales queries by 1/sqrt(head_dim); its dropout is one mask
  broadcast over batch and heads.

Parameters are drawn at construction from torch's global generator with
flax's initializers (truncated-normal LeCun kernels, zero biases, normal
0.02 for the CLS token and the positional embedding). ``forward(x, *,
train=False, generator=None)``: ``train`` switches dropout on and
BatchNorm to batch statistics (updating the running ones in place);
dropout draws from ``generator`` (a ``torch.Generator`` on the input's
device, torch's default when None).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from audax_torch.core.config import CNNClassifierConfig, TransformerClassifierConfig
from audax_torch.parallel.comm import sum_over
from audax_torch.parallel.mesh import batch_group, batch_size, current_mesh

__all__ = ["CNNClassifier", "TransformerClassifier", "WaveformCNNClassifier"]


def _lecun_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal: truncated normal on [-2, 2] std, rescaled so
    the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            shape=None) -> torch.Tensor:
    """flax ``Dropout``: keep each value with probability ``1 - rate`` and
    scale it by ``1 / (1 - rate)``; ``shape`` broadcasts one mask."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_(torch.empty(in_features,
                                                       out_features),
                                           in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """Over the last axis, epsilon 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class BatchNorm(nn.Module):
    """Over the channels of ``[B, C, T]``, statistics over batch and time.
    Under a mesh whose batch axes cut the batch (``parallel/mesh.py:
    use_mesh``), the statistics are the whole batch's: the sums are
    all-reduced over the data ranks, differentiably (synchronised
    BatchNorm, which is what JAX computes over a sharded batch)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool):
        if train:
            mean, sq = _batch_means(x)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            m = self.momentum
            with torch.no_grad():        # biased variance, as flax keeps it
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


def _batch_means(x: torch.Tensor):
    """Means of x and x^2 over batch and time, over the whole batch when a
    current mesh cuts it over its batch axes."""
    mesh = current_mesh()
    if mesh is None or batch_size(mesh) == 1:
        return x.mean((0, 2)), (x * x).mean((0, 2))
    n = torch.tensor([float(x.shape[0] * x.shape[2])], device=x.device,
                     dtype=x.dtype)
    sums = sum_over(torch.cat([x.sum((0, 2)), (x * x).sum((0, 2)), n]),
                    batch_group(mesh))
    c = x.shape[1]
    return sums[:c] / sums[-1], sums[c: 2 * c] / sums[-1]


class Conv(nn.Module):
    """1D convolution on ``[B, C, T]`` without bias, flax SAME padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.k, self.stride = kernel_size, stride
        self.kernel = nn.Parameter(_lecun_(
            torch.empty(out_ch, in_ch, kernel_size), in_ch * kernel_size))

    def forward(self, x):
        n = x.shape[-1]
        total = max((-(-n // self.stride) - 1) * self.stride + self.k - n, 0)
        x = F.pad(x, (total // 2, total - total // 2))
        return F.conv1d(x, self.kernel, stride=self.stride)


class _ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, rate: float):
        super().__init__()
        self.rate = rate
        self.Conv_0 = Conv(in_ch, features, 3)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x, train: bool, generator=None):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool1d(x, 2, 2)
        return dropout(x, self.rate, train, generator)


def _add(module: nn.Module, name: str, child: nn.Module) -> nn.Module:
    module.add_module(name, child)
    return child


class CNNClassifier(nn.Module):
    """Log-mel ``[B, T, n_mels]`` -> logits ``[B, num_classes]``."""

    def __init__(self, cfg: CNNClassifierConfig = CNNClassifierConfig(),
                 n_mels: int = 128):
        super().__init__()
        self.cfg = cfg
        width = n_mels
        self.blocks = []
        for i, feats in enumerate(cfg.channels):
            self.blocks.append(_add(self, f"_ConvBlock_{i}",
                                    _ConvBlock(width, feats, cfg.dropout)))
            width = feats
        self.head = []
        for i, out in enumerate(tuple(cfg.head_dims) + (cfg.num_classes,)):
            self.head.append(_add(self, f"Dense_{i}", Dense(width, out)))
            width = out

    def embeddings(self, x):
        """Pooled pre-head features ``[B, channels[-1]]`` (eval mode)."""
        x = x.transpose(1, 2)
        for block in self.blocks:
            x = block(x, False)
        return x.mean(-1)

    def forward(self, x, *, train: bool = False, generator=None):
        x = x.transpose(1, 2)                       # [B, n_mels, T]
        for block in self.blocks:
            x = block(x, train, generator)
        x = x.mean(-1)                              # global average pool
        for dense in self.head[:-1]:
            x = dropout(F.relu(dense(x)), self.cfg.dropout, train, generator)
        return self.head[-1](x)


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention: q/k/v projections with biases, queries scaled
    by 1/sqrt(head_dim), softmax, dropout broadcast over batch and heads,
    output projection."""

    def __init__(self, dim: int, heads: int, rate: float):
        super().__init__()
        self.heads, self.rate = heads, rate
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(dim, dim))
        self.out = Dense(dim, dim)

    def forward(self, x, train: bool, generator=None):
        b, t, d = x.shape
        h = self.heads

        def split(y):
            return y.reshape(b, t, h, d // h).transpose(1, 2)   # [B, H, T, D]
        q = split(self.query(x)) / math.sqrt(d // h)
        k, v = split(self.key(x)), split(self.value(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        w = dropout(w, self.rate, train, generator, shape=(1, 1, t, t))
        o = (w @ v).transpose(1, 2).reshape(b, t, d)
        return self.out(o)


class _EncoderLayer(nn.Module):
    """Post-LN encoder layer: MHA -> add & norm -> GELU MLP -> add & norm."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, rate: float):
        super().__init__()
        self.rate = rate
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, rate)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)

    def forward(self, x, train: bool, generator=None):
        r = self.rate
        attn = self.MultiHeadDotProductAttention_0(x, train, generator)
        x = self.LayerNorm_0(x + dropout(attn, r, train, generator))
        h = F.gelu(self.Dense_0(x), approximate="tanh")
        h = self.Dense_1(dropout(h, r, train, generator))
        return self.LayerNorm_1(x + dropout(h, r, train, generator))


class TransformerClassifier(nn.Module):
    """Log-mel ``[B, T, n_mels]`` -> logits ``[B, num_classes]``.

    ``cfg.pool``: "cls" prepends a learnable CLS token and classifies its
    final state; "mean" pools over time."""

    def __init__(self, cfg: TransformerClassifierConfig =
                 TransformerClassifierConfig(), max_len: int = 512,
                 n_mels: int = 128):
        super().__init__()
        self.cfg, self.max_len = cfg, max_len
        c = cfg
        self.input_proj = Dense(n_mels, c.dim)
        if c.pool == "cls":
            self.cls_token = nn.Parameter(torch.randn(1, 1, c.dim) * 0.02)
        self.pos_embed = nn.Parameter(torch.randn(1, max_len, c.dim) * 0.02)
        self.layers = [_add(self, f"_EncoderLayer_{i}",
                            _EncoderLayer(c.dim, c.heads, c.mlp_dim,
                                          c.dropout))
                       for i in range(c.layers)]
        self.LayerNorm_0 = LayerNorm(c.dim)
        self.Dense_0 = Dense(c.dim, c.mlp_dim)
        self.Dense_1 = Dense(c.mlp_dim, c.num_classes)

    def forward(self, x, *, train: bool = False, generator=None):
        c = self.cfg
        b, t, _ = x.shape
        use_cls = c.pool == "cls"
        x = self.input_proj(x)
        if use_cls:
            x = torch.cat([self.cls_token.expand(b, 1, c.dim), x], dim=1)
        seq = t + int(use_cls)
        if seq > self.max_len:
            raise ValueError(f"sequence {seq} exceeds max_len {self.max_len}")
        x = dropout(x + self.pos_embed[:, :seq], c.dropout, train, generator)
        for layer in self.layers:
            x = layer(x, train, generator)
        x = self.LayerNorm_0(x)
        pooled = x[:, 0] if use_cls else x.mean(1)
        h = dropout(F.relu(self.Dense_0(pooled)), c.dropout, train, generator)
        return self.Dense_1(h)


class WaveformCNNClassifier(nn.Module):
    """Raw audio ``[B, n]`` or ``[B, n, 1]`` -> logits. The front conv (k80
    s16) is a learnable filterbank."""

    def __init__(self, num_classes: int = 10, dropout: float = 0.3):
        super().__init__()
        self.num_classes, self.rate = num_classes, dropout
        self.Conv_0 = Conv(1, 64, 80, stride=16)
        self.BatchNorm_0 = BatchNorm(64)
        self._ConvBlock_0 = _ConvBlock(64, 128, dropout)
        self._ConvBlock_1 = _ConvBlock(128, 256, dropout)
        self.Dense_0 = Dense(256, 128)
        self.Dense_1 = Dense(128, num_classes)

    def forward(self, x, *, train: bool = False, generator=None):
        x = x.reshape(x.shape[0], 1, -1)             # [B, 1, n]
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.max_pool1d(x, 4, 4)
        x = self._ConvBlock_0(x, train, generator)
        x = self._ConvBlock_1(x, train, generator)
        x = dropout(F.relu(self.Dense_0(x.mean(-1))), self.rate, train,
                    generator)
        return self.Dense_1(x)
