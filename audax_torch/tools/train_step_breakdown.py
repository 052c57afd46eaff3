"""Where does the fine-tune train step's time go? Port of
``tools/train_step_breakdown.py``.

Times the stages of a bf16 Whisper fine-tune step on the card, each with
its analytic FLOPs (``utils/flops.py``) and the rate they give:

  encoder_fwd      ``encode`` (conv stem + encoder stack), no autograd
  encoder_grad     d/d(encoder params) of sum(encode)
  decoder_fwd      teacher-forced ``decode_train`` over precomputed states
  forward          ``whisper_forward`` (encoder + decoder)
  loss_grad        the gradient of the CE loss (no optimizer)
  optimizer        one AdamW update from precomputed gradients
                   (``optimizer_<moments>`` for bf16 or int8 moments)
  full_step_dots   ``make_finetune_step(remat="dots", dtype=bfloat16)``

and micro-operations at the model's shapes, chained x <- f(x) so that every
call depends on the one before (``slope_timed_chained``, CUDA graphs): the
projections (``matmul_proj_bs_d_d``, ``matmul_qkv_3sep``,
``matmul_qkv_fused_d_3d``, ``matmul_mlp_pair``), the encoder's attention
(``attention_enc_shape``), exact GELU and LayerNorm. Stage rows hold
``ms`` (host clock around calls that end in a synchronize,
``utils/profiling.py:time_fn``) and ``tflops``; micro rows ``us`` and
``tflops``.

``--attn flash`` (the default) runs every attention through the flash
kernels (K2 forward, K7/K8 backward); ``--attn xla`` runs the whole model on
the materialised twin, inside ``ops/attention.py:attention_backend``, as
JAX's ``AUDAX_ATTN_BACKEND=xla`` does. The full step is the port's in-place
step: there is no donation to ask for (a difference by design). A stage
that runs out of device memory is recorded as ``{"error": "oom"}``.

On the CPU (``--device cpu``) the chosen size is cut to a tiny width (d_model
64, 2 heads, 1 + 1 layers, 32 audio frames, vocab 512) and the plain
versions run; its times say nothing of the card.

    python -m audax_torch.tools.train_step_breakdown [--size small]
        [--batch 8] [--label-len 32] [--attn flash|xla] [--iters 10]
        [--only SUBSTRING] [--moments float32|bfloat16|int8]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audax_torch.core.config import FineTuneConfig, WhisperConfig
from audax_torch.core.runtime import resolve_device
from audax_torch.models.whisper import (decode_train, encode,
                                        init_whisper_params, layer_norm,
                                        tree_leaves, tree_map,
                                        tree_unflatten, whisper_forward)
from audax_torch.ops.attention import attention_backend, dot_product_attention
from audax_torch.tools import report
from audax_torch.train.optim import apply_updates
from audax_torch.train.seq2seq import (collate_seq2seq, init_finetune,
                                       make_finetune_step, seq2seq_loss)
from audax_torch.utils.flops import (whisper_decoder_fwd_flops,
                                     whisper_encoder_fwd_flops)
from audax_torch.utils.profiling import slope_timed_chained, time_fn

__all__ = ["SIZES", "cpu_cut", "synthetic_batch", "main", "cli"]

SIZES = {"tiny": WhisperConfig.tiny, "base": WhisperConfig.base,
         "small": WhisperConfig.small, "medium": WhisperConfig.medium}
#: chained micro-op slopes on the card: the sub-millisecond matmuls, and the
#: millisecond-scale attention; a short rehearsal on the CPU
_MICRO = {"cuda": (((30, 230), 3), ((5, 25), 2)), "cpu": (((1, 3), 1),) * 2}


def cpu_cut(cfg: WhisperConfig) -> WhisperConfig:
    """A tiny width of ``cfg`` for a rehearsal of the tools on the CPU."""
    return dataclasses.replace(cfg, d_model=64, heads=2, encoder_layers=1,
                               decoder_layers=1, n_audio_ctx=32,
                               vocab_size=512, n_text_ctx=64)


def synthetic_batch(cfg: WhisperConfig, b: int, label_len: int, dev):
    """({"mel": random [b, 2*n_audio_ctx, n_mels], "decoder_input_ids",
    "labels": ``label_len`` random tokens collated} on ``dev``, the numpy
    generator that drew them), seed 0: the JAX tools' batch."""
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (b, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)).to(dev)
    lab = collate_seq2seq([list(rng.integers(3, cfg.vocab_size - 1, label_len))
                           for _ in range(b)], decoder_start_id=1)
    return {"mel": mel, **{k: torch.from_numpy(v).to(dev)
                           for k, v in lab.items()}}, rng


def main(device=None, out: Optional[str] = None, size: str = "small",
         batch: int = 8, label_len: int = 32, attn: str = "flash",
         iters: int = 10, only: str = "", moments: str = "float32") -> dict:
    """The stages of one ``size`` fine-tune step at ``batch`` clips of 30 s
    and ``label_len`` label tokens, on the ``attn`` attention path."""
    dev = resolve_device(device)
    with attention_backend(attn):
        rows = _stages(dev, size, batch, label_len, iters, only, moments)
    oom = any(r.get("error") == "oom" for r in rows)
    return report("train_step_breakdown", dev, rows,
                  "oom" if oom else "measured", out, attn=attn, size=size,
                  batch=batch, label_len=label_len, moments=moments,
                  cpu_cut=dev.type == "cpu")


def _stages(dev, size, b, label_len, iters, only, moments) -> list:
    cfg = SIZES[size]()
    if dev.type == "cpu":
        cfg = cpu_cut(cfg)
    ps = tree_map(lambda t: t.requires_grad_(True), init_whisper_params(
        cfg, torch.Generator().manual_seed(0), device=dev))
    data, rng = synthetic_batch(cfg, b, label_len, dev)
    mel, dec_in, labels = data["mel"], data["decoder_input_ids"], data["labels"]
    dt16 = torch.bfloat16
    enc_f = whisper_encoder_fwd_flops(cfg, b)
    dec_f = whisper_decoder_fwd_flops(cfg, b, int(dec_in.shape[1]))
    rows = []

    def want(name: str) -> bool:
        return not only or only in name

    def record(name, row):
        rows.append({"stage": name, **row})

    def bench(name, flops, fn):
        if not want(name):
            return
        try:
            sec = time_fn(fn, iters=iters)["seconds_per_call"]
            record(name, {"ms": 1e3 * sec, "tflops": flops / sec / 1e12})
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            record(name, {"error": "oom"})

    enc_leaves = tree_leaves(ps["encoder"])
    all_leaves = tree_leaves(ps)
    with torch.no_grad():
        enc_out = encode(ps, cfg, mel, dt16) if want("decoder_fwd") else None

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    bench("encoder_fwd", enc_f, no_grad(lambda: encode(ps, cfg, mel, dt16)))
    bench("encoder_grad", 3 * enc_f, lambda: torch.autograd.grad(
        encode(ps, cfg, mel, dt16).float().sum(), enc_leaves))
    if enc_out is not None:
        bench("decoder_fwd", dec_f, no_grad(
            lambda: decode_train(ps, cfg, dec_in, enc_out, dt16)))
    bench("forward", enc_f + dec_f, no_grad(
        lambda: whisper_forward(ps, cfg, mel, dec_in, dt16)))
    bench("loss_grad", 3 * (enc_f + dec_f), lambda: torch.autograd.grad(
        seq2seq_loss(whisper_forward(ps, cfg, mel, dec_in, dt16).float(),
                     labels), all_leaves))
    del enc_out

    # micro-operations at the model's shapes, chained so that each call
    # depends on the last; the QKV chain combines nonlinearly (q*k + v) so
    # that no pass could merge three products into one
    (mm_iters, mm_rep), (at_iters, at_rep) = _MICRO[dev.type]
    s, d = cfg.n_audio_ctx, cfg.d_model
    bs = b * s

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dt16)

    def micro(name, flops, fn, x0, *extra, timing=(mm_iters, mm_rep)):
        if not want(name):
            return
        with torch.no_grad():
            sec = slope_timed_chained(fn, x0, extra, iters=timing[0],
                                      repeats=timing[1])
        record(name, {"us": 1e6 * sec, "tflops": flops / sec / 1e12})

    x2d = randn(bs, d)
    micro("matmul_proj_bs_d_d", 2 * bs * d * d, lambda x, w: x @ w, x2d,
          randn(d, d, scale=d ** -0.5))
    wq, wk, wv = (randn(d, d, scale=d ** -0.5) for _ in range(3))
    micro("matmul_qkv_3sep", 3 * 2 * bs * d * d,
          lambda x, a, b_, c: ((x @ a) * (x @ b_) + (x @ c)) * 0.5,
          x2d, wq, wk, wv)
    micro("matmul_qkv_fused_d_3d", 2 * bs * d * 3 * d,
          lambda x, w: (lambda y: (y[:, :d] * y[:, d:2 * d]
                                   + y[:, 2 * d:]) * 0.5)(x @ w),
          x2d, randn(d, 3 * d, scale=d ** -0.5))
    micro("matmul_mlp_pair", 2 * 2 * bs * d * 4 * d,
          lambda x, w1, w2: (x @ w1) @ w2, x2d,
          randn(d, 4 * d, scale=d ** -0.5), randn(4 * d, d,
                                                  scale=(4 * d) ** -0.5))
    micro("attention_enc_shape", 4 * b * s * s * d,
          lambda q: dot_product_attention(q, q, q),
          randn(b, cfg.heads, s, d // cfg.heads), timing=(at_iters, at_rep))
    micro("gelu_exact_4d", 0, lambda a: F.gelu(a, approximate="none"),
          randn(b, s, 4 * d))
    lnp = {"scale": torch.ones(d, device=dev),
           "bias": torch.zeros(d, device=dev)}
    micro("layer_norm_d", 0, lambda a: layer_norm(lnp, a), randn(b, s, d))
    del x2d

    if not (want("optimizer") or want("full_step_dots")):
        return rows
    ft = FineTuneConfig(learning_rate=1e-4, warmup_steps=1,
                        max_steps=10 ** 6, lora_rank=0,
                        moment_dtype=moments)
    state = init_finetune(ps, ft)
    del ps, all_leaves, enc_leaves
    # the optimizer stage's input: gradients of the loss, per-layer remat
    # keeping the set-up's own peak low
    logits = whisper_forward(state.trainable, cfg, mel, dec_in, dt16,
                             remat=True).float()
    g = tree_unflatten(state.trainable, torch.autograd.grad(
        seq2seq_loss(logits, labels), tree_leaves(state.trainable)))
    del logits

    def opt_only():       # returns the updates: time_fn syncs on them
        updates, _ = state.tx.update(g, state.opt_state, state.trainable)
        apply_updates(state.trainable, updates)
        return updates

    bench("optimizer" if moments == "float32" else f"optimizer_{moments}",
          0.0, opt_only)
    del g
    if not want("full_step_dots"):
        return rows
    step = make_finetune_step(cfg, remat="dots", dtype=dt16)
    try:
        state, m = step(state, data)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, data)
        float(m["loss"])
        sec = (time.perf_counter() - t0) / iters
        record("full_step_dots", {"ms": 1e3 * sec,
                                  "tflops": 3 * (enc_f + dec_f) / sec / 1e12})
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        record("full_step_dots", {"error": "oom"})
    return rows


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="small", choices=sorted(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--label-len", type=int, default=32)
    ap.add_argument("--attn", default="flash", choices=["flash", "xla"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="substring filter: run only matching stage names")
    ap.add_argument("--moments", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="Adam moment storage of the optimizer and "
                         "full-step stages (train/optim.py adamw_lp)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the plain versions at "
                         "a tiny width")
    ap.add_argument("--out", default=None, help="write the report as JSON")
    a = ap.parse_args(argv)
    return main(device=a.device, out=a.out, size=a.size, batch=a.batch,
                label_len=a.label_len, attn=a.attn, iters=a.iters,
                only=a.only, moments=a.moments)


if __name__ == "__main__":
    cli()
