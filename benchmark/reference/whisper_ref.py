"""Plain float32 Whisper: log-mel, encoder, teacher-forced decoder, loss.

Written from the published description (OpenAI's ``whisper/model.py`` and
``whisper/audio.py``): a periodic Hann STFT of 400 points at hop 160 with
reflect padding, the last frame dropped, Slaney mel filters up to 8 kHz,
log10 clamped at 1e-10, floored 8 below its maximum and scaled (x + 4) / 4;
pre-LayerNorm blocks (eps 1e-5), exact GELU, a conv stem of two width-3
convolutions (stride 1, then 2) with GELU after each, sinusoidal encoder
positions, learned decoder positions, causal self-attention,
cross-attention, and logits tied to the token embedding. It reads the
weight tree by the keys ``benchmark/lib/weights.py`` gives it and imports
nothing of the program.

Every product runs in float32 with TF32 off (``exact()``), and attention
is materialised. ``Lower`` puts the matrix products' inputs through a
lower precision for the control: float8 e4m3 with one scale a tensor, and
their gradients through e5m2.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, SR = 400, 160, 16000


def exact() -> None:
    """No TF32 anywhere: a float32 product stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale a tensor (its largest
    magnitude at the format's largest value)."""
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Round(torch.autograd.Function):
    """Rounds the forward value to one format and the gradient to another,
    as a mixed low-precision training recipe does (e4m3 forward, e5m2
    backward, each tensor scaled)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Lower:
    """The program's recipe with its products one precision lower: the
    inputs of every matrix product rounded to ``dtype`` (their gradients
    to ``grad_dtype``), and the activations between operations (the
    residual stream, norm outputs, products' outputs) held in ``act``, as
    the program holds them. None leaves everything float32."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 grad_dtype: Optional[torch.dtype] = None,
                 act: Optional[torch.dtype] = None):
        self.dtype = dtype
        self.grad_dtype = grad_dtype or dtype
        self.act_dtype = act

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        return _Round.apply(x, self.dtype, self.grad_dtype)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_dtype is None:
            return x
        return _Cast.apply(x, self.act_dtype)


class _Cast(torch.autograd.Function):
    """A value held in a lower float type, forward and backward."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


FULL = Lower(None)

#: the control for each stated precision: its products' inputs (forward,
#: gradients) one format lower, its activations in the stated type
CONTROL = {"bfloat16": (torch.float8_e4m3fn, torch.float8_e5m2,
                        torch.bfloat16),
           "float32": (torch.bfloat16, torch.bfloat16, None)}


def mel_filters(n_mels: int, sr: int = SR, n_fft: int = N_FFT,
                fmax: float = 8000.0) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters [n_mels, bins]
    (librosa.filters.mel's defaults, which Whisper's filters come from)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2: n_mels + 2] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, 480000] audio (padded to 30 s) -> [B, 3000, n_mels]."""
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                            device=audio.device)
    spec = torch.stft(audio.double(), N_FFT, HOP, window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2                       # [B, bins, T]
    fb = torch.from_numpy(mel_filters(n_mels)).to(audio.device).double()
    mel = torch.einsum("mf,bft->btm", fb, power)
    logs = torch.log10(mel.clamp_min(1e-10))
    top = logs.amax(dim=(1, 2), keepdim=True)
    return ((torch.maximum(logs, top - 8.0) + 4.0) / 4.0).float()


def _ln(p, x, low: Lower = None):
    y = F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(),
                     1e-5)
    return y if low is None else low.act(y)


def _dense(p, x, low: Lower, li=None):
    w = p["kernel"] if li is None else p["kernel"][li]
    y = low(x) @ low(w.float())
    if "bias" in p:
        y = y + (p["bias"] if li is None else p["bias"][li]).float()
    return low.act(y)


def _layer(tree, li):
    return {k: (_layer(v, li) if isinstance(v, dict) else v[li])
            for k, v in tree.items()}


def _attn(p, x, heads, low: Lower, kv=None, causal=False):
    b, t, d = x.shape
    hd = d // heads
    src = x if kv is None else kv
    q = _dense(p["q"], x, low).view(b, t, heads, hd).transpose(1, 2)
    k = _dense(p["k"], src, low).view(b, -1, heads, hd).transpose(1, 2)
    v = _dense(p["v"], src, low).view(b, -1, heads, hd).transpose(1, 2)
    s = (low(q) @ low(k).transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(t, n, dtype=torch.bool,
                                     device=x.device).triu(1), float("-inf"))
    o = low.act(low(torch.softmax(s, -1)) @ low(v))
    return _dense(p["out"], o.transpose(1, 2).reshape(b, t, d), low)


def _mlp(p, x, low: Lower):
    return _dense(p["mlp_out"], low.act(F.gelu(_dense(p["mlp_in"], x, low))),
                  low)


def encode(params, heads: int, mel: torch.Tensor, low: Lower = FULL
           ) -> torch.Tensor:
    """mel [B, 3000, n_mels] -> encoder states [B, 1500, d]."""
    p = params["encoder"]
    x = mel.float().transpose(1, 2)
    x = low.act(F.gelu(F.conv1d(low(x), low(p["conv1"]["kernel"].float()),
                                p["conv1"]["bias"].float(), padding=1)))
    x = low.act(F.gelu(F.conv1d(low(x), low(p["conv2"]["kernel"].float()),
                                p["conv2"]["bias"].float(), stride=2,
                                padding=1)))
    x = low.act(x.transpose(1, 2) + p["pos"].float()[: x.shape[-1]])
    layers = p["layers"]
    for li in range(layers["attn"]["q"]["kernel"].shape[0]):
        lp = _layer(layers, li)
        x = low.act(x + _attn(lp["attn"], _ln(lp["attn_ln"], x, low),
                              heads, low))
        x = low.act(x + _mlp(lp, _ln(lp["mlp_ln"], x, low), low))
    return _ln(p["ln"], x, low)


def decode(params, heads: int, tokens: torch.Tensor, enc: torch.Tensor,
           low: Lower = FULL) -> torch.Tensor:
    """Teacher-forced logits [B, L, vocab] of tokens [B, L]."""
    p = params["decoder"]
    n = tokens.shape[1]
    x = low.act(p["embed"].float()[tokens] + p["pos"].float()[:n])
    layers = p["layers"]
    for li in range(layers["attn"]["q"]["kernel"].shape[0]):
        lp = _layer(layers, li)
        x = low.act(x + _attn(lp["attn"], _ln(lp["attn_ln"], x, low), heads,
                              low, causal=True))
        x = low.act(x + _attn(lp["cross_attn"], _ln(lp["cross_ln"], x, low),
                              heads, low, kv=enc))
        x = low.act(x + _mlp(lp, _ln(lp["mlp_ln"], x, low), low))
    return low.act(low(_ln(p["ln"], x, low)) @ low(p["embed"].float()).T)


def loss_sum(params, heads: int, mel, dec_in, labels, low: Lower = FULL):
    """(summed cross-entropy over labels that are not -100, their count)."""
    logits = decode(params, heads, dec_in, encode(params, heads, mel, low),
                    low)
    lab = labels.long()
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            lab.reshape(-1), ignore_index=-100,
                            reduction="sum")
    return total, (lab != -100).sum()
