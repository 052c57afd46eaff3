#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``audax_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``audax_torch/csrc`` and drives the
Whisper transcription main path at the full width of Whisper-tiny, in five
phases, one output line each (the kernel and main-path phases print one
line per case):

  1. device  -- nvidia-smi's name and power limit, torch/CUDA/nvcc versions;
  2. build   -- nvcc of every kernel, in parallel, with its wall time;
  3. kernels -- each kernel against its plain PyTorch version on the card at
     the main path's shapes: max |err| against the stated tolerance, kernel
     ms, plain ms, the one-call library yardstick where there is one, and
     the least time the card could take (bytes or operations over the
     H100's published peaks);
  4. main path -- random Whisper-tiny weights from a seeded generator, a
     tokenizer with the published 51,865-token layout, two requests (30 s
     and 47 s of synthetic audio) through ``Transcriber(device="cuda")``;
     every kernel's launch counter must rise and no plain version's may;
     then the card is held against the port's CPU path in float32
     (encoder states, and teacher-forced logits of every decode step);
  5. the kernels' JSON line, then the result line.

Any failed check raises, so the exit code is non-zero. Without a CUDA
device, or without the ``audax_torch`` package beside it, it exits with 2
and prints no result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
#: FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

#: tolerances: float32 log-mel in the log domain (the JAX package's own
#: frontend bound); float32 attention; bf16 attention (bf16 rounds p before PV)
TOL_MEL = 2e-3
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
#: card vs the port's CPU path, float32 with TF32 off: summation order is
#: the only difference, compounded over the layers
TOL_ENC = 1e-3
TOL_LOGITS = 1e-3


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes, flop_rate):
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _report(case, err, tol, ms, plain_ms, lib_ms, bound):
    lib = f"{lib_ms:.4f}" if lib_ms is not None else "null"
    print(f"[kernels] {case}: max_abs_err {err:.3e} (tol {tol:.0e}) "
          f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
          f"bound_ms {bound[0]:.4f} ({bound[1]})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{case}: max |err| {err:.3e} > {tol:.0e}")


def kernel_phase(torch, rng):
    """Each kernel against its plain version at the main path's shapes;
    returns {kernel: summary of its main-path case}."""
    import numpy as np
    import torch.nn.functional as F

    from audax_torch.core.config import MelConfig
    from audax_torch.ops import attention as att
    from audax_torch.ops import fused_mel
    from audax_torch.ops.mel import overlap_block_size

    dev = "cuda"
    out = {}

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # ---- K1: overlap log-mel -------------------------------------------------
    for name, cfg, shape in (("whisper", MelConfig.whisper(), (4, 480000)),
                             ("urbansound_v2", MelConfig.urbansound_v2(),
                              (16, 64000))):
        t = np.arange(shape[1]) / 16000.0
        x = (0.3 * np.sin(2 * np.pi * 440 * t) * (1 + np.sin(t))
             + 0.05 * rng.standard_normal(shape)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        got = fused_mel.log_mel_overlap_cuda(x, cfg)
        ref = fused_mel.log_mel_overlap_plain(x, cfg)
        ms = _time_ms(torch, lambda: fused_mel.log_mel_overlap_cuda(x, cfg))
        plain = _time_ms(torch, lambda: fused_mel.log_mel_overlap_plain(x, cfg))
        b, n = shape
        frames = got.shape[1]
        g, f, m = overlap_block_size(cfg), cfg.n_freqs, cfg.n_mels
        nb, adv = cfg.n_fft // g, cfg.hop_length // g
        nblk = (frames - 1) * adv + nb
        flops = b * (nblk * g * f * 4 + frames * f * (nb * 8 + 10)
                     + frames * f * m * 2 + frames * m)
        nbytes = 4 * (b * n + b * frames * m + 2 * g * f + 2 * nb * f + f * m)
        bound = _bound(flops, nbytes, F32_FLOPS)
        e = err(got, ref)
        _report(f"log_mel_overlap[{name} {list(shape)}]", e, TOL_MEL, ms,
                plain, None, bound)
        if name == "whisper":
            out["log_mel_overlap"] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                                          library_ms=None, bound=bound)

    # ---- K2: flash forward ---------------------------------------------------
    def flash_case(label, b, hq, hkv, tq, tk, dtype, causal, tol, main):
        q = torch.randn(b, hq, tq, 64, device=dev).to(dtype)
        k = torch.randn(b, hkv, tk, 64, device=dev).to(dtype)
        v = torch.randn(b, hkv, tk, 64, device=dev).to(dtype)
        o, lse = att.flash_forward_cuda(q, k, v, causal=causal)
        o_ref, lse_ref = att.flash_forward_plain(q, k, v, causal=causal)
        e = max(err(o, o_ref), err(lse, lse_ref) if dtype == torch.float32
                else 0.0)
        ms = _time_ms(torch, lambda: att.flash_forward_cuda(q, k, v,
                                                            causal=causal))
        plain = _time_ms(torch, lambda: att.flash_forward_plain(
            q, k, v, causal=causal))
        lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        pairs = tq * (tq + 1) // 2 if causal else tq * tk
        flops = 4 * b * hq * pairs * 64
        elt = q.element_size()
        nbytes = elt * 64 * (2 * b * hq * tq + 2 * b * hkv * tk) + 4 * b * hq * tq
        bound = _bound(flops, nbytes,
                       F32_FLOPS if dtype == torch.float32 else BF16_FLOPS)
        _report(f"flash_forward[{label}]", e, tol, ms, plain, lib, bound)
        if main:
            out["flash_forward"] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                                        library_ms=lib, bound=bound)

    flash_case("f32 [4,6,1500,64]", 4, 6, 6, 1500, 1500, torch.float32,
               False, TOL_F32, True)
    flash_case("bf16 [4,6,1500,64]", 4, 6, 6, 1500, 1500, torch.bfloat16,
               False, TOL_BF16, False)
    flash_case("f32 causal GQA 8q/2kv T=200", 2, 8, 2, 200, 200,
               torch.float32, True, TOL_F32, False)

    # ---- K3: stacked decode attention -----------------------------------------
    def decode_case(label, s_len, pos, main, h=6, hkv=6, tq=1):
        L, b, d = 4, 4, 64
        q = torch.randn(b, h, tq, d, device=dev)
        k = torch.randn(L, b, hkv, s_len, d, device=dev)
        v = torch.randn(L, b, hkv, s_len, d, device=dev)
        pos_t = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if pos is not None else None)
        e = 0.0
        for layer in range(L):
            got = att.decode_attention_stacked_cuda(q, (k, v), layer, pos=pos_t)
            ref = att.decode_attention_stacked_plain(q, (k, v), layer,
                                                     pos=pos_t)
            e = max(e, err(got, ref))
        # cycle the layers: 4 layers of K/V exceed the 50 MB L2 as they do
        # on the main path
        it = iter(range(10 ** 9))
        ms = _time_ms(torch, lambda: att.decode_attention_stacked_cuda(
            q, (k, v), next(it) % L, pos=pos_t))
        plain = _time_ms(torch, lambda: att.decode_attention_stacked_plain(
            q, (k, v), next(it) % L, pos=pos_t))
        if pos is None:
            mask, pos = None, [s_len] * b
        else:
            cols = torch.arange(s_len, device=dev)
            rows = torch.arange(tq, device=dev)
            mask = (cols[None, None, :] <= pos_t[:, None, None].long()
                    + rows[None, :, None])[:, None]

        def sdpa():
            layer = next(it) % L
            return F.scaled_dot_product_attention(
                q, k[layer], v[layer], attn_mask=mask, enable_gqa=h != hkv)
        lib = _time_ms(torch, sdpa)
        # keys each row may see, and the K/V rows a block must read
        seen = sum(min(s_len, p + r + 1) for p in pos for r in range(tq))
        rows_read = sum(min(s_len, p + tq) for p in pos)
        flops = 4 * d * h * seen
        nbytes = 4 * d * (2 * b * h * tq + 2 * hkv * rows_read)
        bound = _bound(flops, nbytes, F32_FLOPS)
        _report(f"decode_attention_stacked[{label}]", e, TOL_F32, ms, plain,
                lib, bound)
        if main:
            out["decode_attention_stacked"] = dict(
                max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib,
                bound=bound)

    pos = [int(p) for p in rng.integers(0, 448, size=4)]
    decode_case(f"self [4,4,6,448,64] pos {pos}", 448, pos, False)
    decode_case("cross [4,4,6,1500,64] pos=None", 1500, None, True)
    decode_case("GQA 8q/2kv Tq=3 S=64 pos [0,5,30,63]", 64, [0, 5, 30, 63],
                False, h=8, hkv=2, tq=3)
    return out


def _tokenizer():
    """Whisper tokenizer with the published 51,865-token layout: a BPE
    trained on a tiny corpus, padded with never-produced filler tokens to
    the published 50,257-token base."""
    from audax_torch.symbolic.bpe import BPE, train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer

    corpus = ["the quick brown fox jumps over the lazy dog",
              "hello world how are you today",
              "speech recognition on a graphics card",
              "one two three four five six seven eight nine ten"] * 4
    bpe = train_bpe(corpus, vocab_size=400)
    vocab = dict(bpe.vocab)
    for i in range(len(vocab), 50257):
        vocab[f"<unused{i}>"] = i
    return WhisperTokenizer.for_vocab_size(BPE(vocab, bpe.merges), 51865)


def _speechlike(rng, seconds, sr=16000):
    """Deterministic synthetic audio: gliding harmonic tones under a
    syllable-rate envelope, plus noise."""
    import numpy as np
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t)) ** 2
    x = 0.2 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def main_path_phase(torch, rng):
    import numpy as np

    from audax_torch.core.config import WhisperConfig
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches

    cfg = WhisperConfig.tiny()
    params = W.init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                   device="cuda")
    tok = _tokenizer()
    if tok.vocab_size != cfg.vocab_size:
        raise AssertionError(f"tokenizer {tok.vocab_size} != {cfg.vocab_size}")
    tr = Transcriber(params, cfg, tok, device="cuda", max_new_tokens=96)
    t0 = time.perf_counter()
    tr.warmup()
    print(f"[main] Whisper-tiny (d_model {cfg.d_model}, {cfg.encoder_layers}+"
          f"{cfg.decoder_layers} layers, vocab {cfg.vocab_size}) warmup "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    reset_launches()
    requests = [("30 s", _speechlike(rng, 30.0)), ("47 s", _speechlike(rng, 47.0))]
    for label, audio in requests:
        res = tr.transcribe(audio)
        n_tok = sum(len(s.tokens) for s in res.segments)
        temps = [s.temperature for s in res.segments]
        print(f"[main] request {label}: {len(res.segments)} segments, "
              f"{n_tok} tokens, text length {len(res.text)}, temperatures "
              f"{temps}, wall {res.wall_seconds:.3f} s, RTF {res.rtf:.5f}",
              flush=True)
    counts = launch_counts()
    print(f"[main] launches: {json.dumps(counts)}", flush=True)
    for name, c in counts.items():
        if c["cuda"] <= 0 or c["plain"] != 0:
            raise AssertionError(f"{name}: kernel launches {c['cuda']}, plain "
                                 f"{c['plain']} on the main path")

    # ---- the card against the port's CPU path, float32 ------------------------
    audio = requests[0][1][None, : tr.chunk_samples]
    mel = tr.frontend(audio)
    enc = W.encode(params, cfg, mel)
    cpu_params = W.tree_map(lambda t: t.cpu(), params)
    enc_cpu = W.encode(cpu_params, cfg, mel.cpu())
    e_enc = float((enc.cpu() - enc_cpu).abs().max())
    print(f"[main] encoder states card vs CPU: max_abs_err {e_enc:.3e} "
          f"(tol {TOL_ENC:.0e})", flush=True)
    if not e_enc <= TOL_ENC:
        raise AssertionError(f"encoder states differ by {e_enc:.3e}")

    prompt = torch.from_numpy(tr._prompt(1)).cuda()
    out = tr._decode_once(enc, tr._prompt(1), 0.0)
    n = int(out.lengths[0])
    toks = out.tokens[0, :n]
    cache = W.init_kv_cache(cfg, 1, n, device="cuda")
    cache_cpu = W.init_kv_cache(cfg, 1, n, device="cpu")
    xkv = W.precompute_cross_kv(params, cfg, enc)
    xkv_cpu = W.precompute_cross_kv(cpu_params, cfg, enc_cpu)
    e_log, agree = 0.0, 0
    for pos in range(n - 1):
        lg, cache = W.decode_step(params, cfg, toks[pos: pos + 1], pos, cache,
                                  xkv)
        lc, cache_cpu = W.decode_step(cpu_params, cfg,
                                      toks[pos: pos + 1].cpu(), pos,
                                      cache_cpu, xkv_cpu)
        e_log = max(e_log, float((lg.cpu() - lc).abs().max()))
        agree += int(lg.argmax(-1).item() == lc.argmax(-1).item())
    print(f"[main] teacher-forced decode card vs CPU over {n - 1} steps "
          f"(prompt {prompt.shape[1]}): logits max_abs_err {e_log:.3e} "
          f"(tol {TOL_LOGITS:.0e}), token agreement {agree}/{n - 1}",
          flush=True)
    if not e_log <= TOL_LOGITS:
        raise AssertionError(f"decode logits differ by {e_log:.3e}")
    if not all(np.isfinite(v) for v in (e_enc, e_log)):
        raise AssertionError("non-finite comparison")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "audax_torch" / "csrc").is_dir():
        print(f"chip_smoke: no audax_torch package beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from audax_torch.core.runtime import resolve_device
    from audax_torch.ops import native

    resolve_device("cuda")                 # TF32 off
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    nvcc = _run([native.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"[device] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} nvcc: {nvcc}", flush=True)

    t0 = time.perf_counter()
    reports = native.build()
    regs = sorted({line.split("ptxas info    : ")[-1]
                   for text in reports.values() for line in text.splitlines()
                   if "registers" in line})
    print(f"[build] {len(native.KERNEL_SOURCES)} kernels ({len(reports)} "
          f"compiled now) in {time.perf_counter() - t0:.2f} s; ptxas: "
          f"{' | '.join(regs)}", flush=True)

    rng = np.random.default_rng(0)
    kern = kernel_phase(torch, rng)
    counts = main_path_phase(torch, rng)

    sources = {"log_mel_overlap": ("audax_torch/csrc/log_mel_overlap.cu",
                                   "audax/ops/pallas_mel.py:199"),
               "flash_forward": ("audax_torch/csrc/flash_fwd.cu",
                                 "audax/ops/attention.py:161"),
               "decode_attention_stacked": (
                   "audax_torch/csrc/decode_attention.cu",
                   "audax/ops/attention.py:680")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name]["cuda"],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound"][0],
         "bound_by": kern[name]["bound"][1],
         "library_ms": kern[name]["library_ms"]}
        for name, (src, rep) in sources.items()]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
