#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``audax_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--profile]

``--profile`` adds a ``torch.profiler`` window over each fine-tune step,
one serving decode step and each classifier's train step (device time by
kernel family, the device's busy share). It builds the
port's CUDA kernels from ``audax_torch/csrc`` and drives the port's four
main paths -- Whisper transcription at the full width of Whisper-tiny,
Whisper fine-tuning at the full width of Whisper-base, quantized
continuous-batching serving over HTTP at the full width of
Whisper-large-v3-turbo, and UrbanSound classification at the reference
classifiers' widths -- the four int4 kernel-experiment tools and the four
attention tools, in eleven phases, one output line each (the kernel and
path phases print one line per case):

  1. device  -- nvidia-smi's name and power limit, torch/CUDA/nvcc versions;
  2. build   -- nvcc of every kernel library (eighteen), in parallel, with
     the wall time of each and of all, the registers and any spills; then
     the count of HGMMA (wgmma) instructions in the SASS of the three bf16
     tensor-core libraries, K2's and K7's and K8's (``cuobjdump
     --dump-sass``), none of which may be 0, and a spill in K7's or K8's
     fails; the count of TF32 HMMA (mma.sync) instructions in the SASS of
     the three float32 tensor-core libraries, K2's, K7's and K8's
     (``flash_fwd_tf32x3``, ``flash_bwd_dq_tf32x3``,
     ``flash_bwd_dkv_tf32x3``), none of which may be 0, and their registers
     by instantiation, where a spill fails; the
     registers and spills of each n_fft the FFT log-mel body is built for
     (Whisper's 400-point mixed radix among them), where a spill fails too;
  3. kernels -- each kernel against its plain PyTorch version on the card at
     the main paths' and the tools' shapes: max |err| against the stated
     tolerance, kernel ms, plain ms, the one-call library yardstick where
     there is one (for the log-mel kernels K1/K4/K5 a composite:
     ``torch.stft`` + ``|X|^p`` + the mel product + the log, with Whisper's
     clamp for the Whisper preset), and the least time the card could take
     (bytes or operations over the H100's published peaks; for a log-mel,
     the operations of an FFT per frame and the filterbank's nonzeros,
     whichever tier runs). The int4 kernels (K9 and the tools' P2-P5) and
     their ``torch.matmul`` yardstick are slope-timed in CUDA graphs with
     the weights from HBM (copies cycled past twice the L2), the L2-warm
     time beside. K9 runs on its tensor-core body (``csrc/
     int4_matmul_mma.cu``) at the serving step's four shapes in both
     dtypes, each call made twice (the same bits), timed beside its
     split-half body (``csrc/int4_matmul.cu``) and, in bf16,
     ``_weight_int4pack_mm`` ("not available" where the build lacks it),
     then held at ragged N (odd, 258), M = 1, 16 and 256, groups 64 and 80
     and stacked layer views. It also holds decode attention at 40 query rows (K3 in
     chunks of 16), every caller-set tile of K2, K7 and K8 at
     [4, 8, 1500, 64] float32, and P1 -- K2 folding 2 or 4 heads per block,
     ``tools/attn_headfold_probe.py:fold_fwd`` -- at the tool's bf16
     [96, 1536, 64] and with a ragged key count (1500 of 1536 rows). K2's
     float32 body on the tensor cores (``csrc/flash_fwd_tf32x3.cu``,
     3xTF32) is held, o and lse, within the float32 tolerance at Whisper-
     base's [4, 6, 1500, 64] and [4, 8, 1500, 64], its cross and causal
     decoder sites, causal GQA, a ragged key count, head dims 16/32/128 and
     the serving encoder's [8, 20, 1500, 64], and timed beside the
     CUDA-core body (``body="cuda_core"``) at the first and the last; each
     case names the body it ran and its bound (3xTF32 at a third of the
     TF32 peak). K7/K8's float32 bodies on the tensor cores
     (``csrc/flash_bwd_tf32x3.cu``, 3xTF32) are held within the float32
     tolerance at every float32 backward case -- Whisper-base's encoder
     [4, 8, 1500, 64] and its cross (q 56 x kv 1500) and causal decoder
     sites, causal GQA, a q-head group of four at [4, 8, 1500, 64] (K8's
     longest sums), head dims 16/32/128 and the caller-set tiles of 64
     rows (K7) or keys (K8) -- and timed at the encoder and the cross site
     beside the CUDA-core body (its library called directly at 64 x 64,
     held against the plain versions too) and SDPA's backward: both must
     beat the CUDA-core body there. K2's
     bf16 tensor-core body (``csrc/flash_fwd_sm90.cu``) is held, o and
     lse, within the bf16 tolerance and each element of o within the
     rounding bf16 allows (2^-7 of the attention-weighted |v| plus one
     bf16 step), at Whisper-small's [8, 12, 1500, 64], causal GQA, cross
     attention, a ragged key count, head dims 16/32/128 and each of its
     tiles; K7/K8's bf16 bodies on the tensor cores
     (``csrc/flash_bwd_sm90.cu``) at [8, 12, 1500, 64] (timed beside the
     CUDA-core body in bf16, its library called directly, and SDPA's
     backward; both must beat the former) and [4, 8, 1500, 64], the bf16
     decoder sites of Whisper-small's step (causal [8, 12, 40, 64], cross q
     40 x kv 1500) and of the bf16 Whisper-base fine-tune (causal [4, 8,
     56, 64], cross q 56 x kv 1500), causal GQA, head dims 16/32/128 and
     every tile of ``TILES``, each call launching the body ``BWD_BODIES``
     names once, no other body and no plain version; the FFT log-mel body
     (``csrc/log_mel_fft.cu``) in every tier the body table
     ``ops/fused_mel.py:BODIES`` gives it: K1's at Whisper 80 and 128 mels
     and UrbanSound v2, K4's at PANNs' geometry (each against its tier's
     plain version, timed beside the tier's own kernel, which it must
     beat, and the composite), Whisper's 400 points at 200 bands, a short
     window, log10 and a silent clip, and K5's at UrbanSound's magnitude
     batch, Whisper's n_fft 400 at power 1 (timed beside K5's direct body
     on the same [64, 401, 400] frames) and 1.5, n_fft 512/1024/2048, 256
     bands at power 1.5 and a silent clip, against the direct DFT's plain
     version; the tiers' own kernels off the table (K1 at n_fft 480, K4
     and K5 at 1000); and more than 256 bands on every body (320 or 512:
     the FFT body in K1's, K4's and K5's tiers, the direct bodies of K4 and
     K5 at n_fft 1000, one launch per chunk of 256 bands);
  3b. precision -- a bf16 ``dense`` at [12000, 5120] x [5120, 1280] within
     one bf16 step of the float64 product (float32 accumulation);
  4. transcription -- random Whisper-tiny weights from a seeded generator,
     a tokenizer with the published 51,865-token layout, two requests (30 s
     and 47 s of synthetic audio) through ``Transcriber(device="cuda")``;
     the counters of its kernels (K1's tier on the FFT body, K2 on its
     3xTF32 body, K3) must rise and no plain version's, old K1/K4 body's
     or CUDA-core K2's may; then the card is
     held against the port's CPU path in float32 (the log-mel, FFT body
     against K1's plain version; encoder states, and teacher-forced
     logits of every decode step);
  5. fine-tune -- random Whisper-base weights, eight synthetic 30 s clips
     written as 16-bit wavs with transcript sidecars, ``build_speech_dataset``
     and two ``finetune_whisper(device="cuda")`` runs: LoRA (rank 8 on
     attn/q and attn/v, with one WER eval) and full-parameter (overfitting
     four clips: the last loss must fall below 0.7x the first). K1 (its
     FFT body), K2, K7 and K8 (their 3xTF32 bodies, no CUDA-core launch)
     and K3 must all launch, none on a bf16 tensor-core body, and no plain
     version may. A third run,
     LoRA in bf16 (4 clips x 5 steps), must launch the tensor-core bodies
     of K2, K7 and K8 and no CUDA-core one, with a finite, falling loss.
     Then the step time, steps/s, tokens/s, peak memory and launches of the
     full-parameter and the LoRA step at batch 4, and one step's loss and
     every gradient leaf on the card against the port's CPU path at batch 1
     in float32;
  6. serving -- random Whisper-large-v3-turbo weights quantized to int4 on
     the CPU and moved to the card, ``ContinuousBatcher(slots=8,
     kv_quant=True, max_new_tokens=64)`` behind ``serve_http``, twelve
     client threads posting 16-bit WAVs of 5-30 s: every answer must be 200
     with a well-formed JSON body; K1 (its FFT body), K2 (its 3xTF32 body,
     no CUDA-core launch), K3's int8 arm and K9 must launch and no plain
     version may; K9 33 times a decode step, all on its tensor-core body. Then requests/s, latency
     p50 and max, decode steps, tokens/s, launches per decode step and peak memory; the card
     against the port's CPU path (teacher-forced ``decode_step_ragged``
     with float and with int8 self-KV, two faults planted in the int8
     writes that the limit must reject, and the int8 reading over 16 seeds
     of one decode step: largest and median beside the limit, the written
     codes within +-1 and scales within 1e-3 relative), and
     ``attention(kv_cached=)`` through K6;
  7. classify -- 400 synthetic 4 s clips in the UrbanSound8K layout
     (``make_synthetic_urbansound``, seed 0), featurized on the card by
     ``featurize_clips`` (int16 upload, batches of 64) under four frontend
     configs: UrbanSound v2 (K1's tier) and PANNs' Cnn14_16k geometry
     (K4's), both on the FFT body, UrbanSound v2 as a magnitude mel (K5's
     FFT body) and a magnitude mel at n_fft 400 (K5's FFT body too,
     featurized only); each run must launch its kernel and no other tier,
     body or plain version. Then
     ``fit_classifier`` for 3 epochs on folds 1-8 and ``evaluate_classifier``
     on folds 9 and 10 for ``CNNClassifier`` (v2 features),
     ``TransformerClassifier(pool="cls", max_len=2048)`` (PANNs features)
     and ``TransformerClassifier(pool="mean")`` (magnitude features): the
     last epoch's train loss must be below the first's (accuracy is printed,
     not gated); each model's eval logits, one train step's loss and
     BatchNorm running statistics (f32) and every gradient leaf of that
     step (f64, where both devices take the same ReLU and max-pool
     branches) on the card against the port's CPU path (dropout 0); and
     the train step's time;
  8. probes -- the four int4 tools through their entry points on the card
     (``int4_layout_ab`` check and bench, ``int4_plane_probe``,
     ``w4a8_probe``, ``int4_unpack_probe``): each prints its rows, then one
     JSON line per tool with its rows and verdict; each tool's kernels (and
     K9's tensor-core body, its "current" arm) must launch and no plain
     version may;
  9. attention_tools -- ``attn_headfold_probe`` (the four kernel arms and
     the product A/B), ``attn_block_probe`` (the tile set, forward and
     backward, at [8, 12, 1500, 64] bf16), ``train_step_breakdown`` at
     Whisper-small width (B = 8, label length 32, ``--attn flash`` and
     ``--attn xla``, 3 iterations) and ``mfu_study --only 0,10 --steps 3``,
     each through its entry point on the card: one JSON line each with
     its rows, verdict, seconds and launches; K2/K7/K8 (and P1 in the fold
     probe) must launch where a tool drives them, their tensor-core bodies
     in every run (and they alone in the step and the MFU runs), none in
     the xla arm, and no plain version anywhere;
 10. the kernels' JSON line (``flash_forward``, ``flash_backward_dq`` and
     ``flash_backward_dkv``, the rows of ``csrc/flash_fwd.cu`` and
     ``csrc/flash_bwd.cu``, count the CUDA-core launches, the last two timed
     in the float32 A/B at [4, 8, 1500, 64]; the ``_tf32x3`` rows the
     float32 bodies on the tensor cores (K2, K7, K8); the
     ``_wgmma`` rows the bf16 tensor-core bodies'; ``log_mel_overlap_fft`` and
     ``log_mel_packed_fft`` K1's and K4's tiers on the FFT body, apart from
     ``log_mel_overlap``/``log_mel_packed`` and K5's ``log_mel_fft``: each
     body counts its own), then the result line.

Any failed check raises, so the exit code is non-zero. Without a CUDA
device, or without the ``audax_torch`` package beside it, it exits with 2
and prints no result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
#: FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s, int8
#: tensor-core OP/s; and the float32 rate of 3xTF32 on the tensor cores,
#: three TF32 products (495 TFLOP/s) for each float32 one
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32X3_FLOPS = 495e12 / 3

#: tolerances: float32 log-mel in the log domain (the JAX package's own
#: frontend bound); float32 attention; bf16 attention (bf16 rounds p before PV)
TOL_MEL = 2e-3
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
#: int4 matmul (K9, the word kernel, unpack v1/v2), relative to max
#: |plain|: float32 (summation order only); bf16 x takes TOL_BF16, one bf16
#: step of the output (v2's weights round identically in kernel and plain)
TOL_INT4_F32 = 1e-4
#: W4A8 in float32, relative to max |plain|: each group's int8 sum is an
#: exact integer in both, so only the float32 scaling and the order of the
#: group sums differ
TOL_W4A8_F32 = 1e-5
#: card vs the port's CPU path, float32 with TF32 off: summation order is
#: the only difference, compounded over the layers
TOL_ENC = 1e-3
TOL_LOGITS = 1e-3
#: the same with an int8 self-attention cache: a K/V vector computed on the
#: card and on the CPU may round one code to a neighbouring int8 step, and
#: how many codes sit on a rounding edge depends on the inputs and on the
#: kernels' summation order. At Whisper-large-v3-turbo width (int4 weights,
#: 8 steps x 4 slots, H100 80GB HBM3) the exact path has read 6.9e-4 and
#: 2.6e-3, the planted fault "codes truncated, not rounded" 3.9e-2: the
#: limit sits about 4x from each
TOL_LOGITS_Q8 = 1e-2
#: one fine-tune step, card vs CPU in float32: the loss (relative), and each
#: gradient leaf against 1e-3 of that leaf's largest CPU value (+1e-6)
TOL_STEP_LOSS = 1e-4
TOL_STEP_GRAD = 1e-3
#: classifiers, card vs CPU in float32 with dropout 0: eval logits against
#: 1e-3 of the largest CPU logit; BatchNorm running statistics after one
#: step against 1e-5 of each statistic's largest CPU value (at least 1)
TOL_CLS_LOGITS = 1e-3
TOL_BN_STATS = 1e-5

#: the two public frontends that take the direct log-mel tiers: PANNs'
#: Cnn14_16k geometry (power 2, g = 32, a = 5: not overlap-applicable -> K4)
#: and UrbanSound v2 as a magnitude mel (power 1 -> K5)
PANNS_MEL = dict(n_fft=512, hop_length=160, n_mels=64, fmin=50.0,
                 fmax=8000.0, htk=False, norm_slaney=True)
MAGNITUDE_MEL = dict(power=1.0)
#: a magnitude mel at Whisper's STFT geometry (n_fft 400, hop 160): K5's
#: FFT body takes it through the 400-point mixed radix, as K1's tier does
#: at power 2; K5's direct body keeps every n_fft off the FFT body's table
MAGNITUDE_400_MEL = dict(n_fft=400, hop_length=160, power=1.0)
MAGNITUDE_1000_MEL = dict(n_fft=1000, hop_length=160, power=1.0)

#: the kernels each main path must launch: K1's tier runs the FFT body
#: (``log_mel_overlap_fft``) at every Whisper and UrbanSound preset, K2
#: (and in the fine-tune K7 and K8) its float32 body on the tensor cores
#: (``*_tf32x3``); their CUDA-core bodies (``FLASH``) must not launch on
#: these paths
TRANSCRIBE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                      "decode_attention_stacked")
FINETUNE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                    "flash_backward_dq_tf32x3", "flash_backward_dkv_tf32x3",
                    "decode_attention_stacked")
SERVE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                 "decode_attention_stacked_int8", "int4_matmul_mma")
#: K9's launches per serving decode step on its tensor-core body: 4 decoder
#: layers x 8 projections and the tied logits; its split-half body, none
K9_PER_STEP = 33
#: K1's and K4's own kernels: no main path launches them, since every
#: config a path runs takes the FFT body (``ops/fused_mel.py:BODIES``)
OLD_MEL_BODIES = ("log_mel_overlap", "log_mel_packed")
#: the int4 tools and the kernels each must launch (K9's tensor-core body
#: is every tool's "current" arm)
PROBE_TOOLS = (("int4_layout_ab", ("int4_word_matmul", "int4_matmul_mma")),
               ("int4_plane_probe", ("int4_plane_matmul", "int4_matmul_mma")),
               ("w4a8_probe", ("w4a8_matmul", "int4_matmul_mma")),
               ("int4_unpack_probe", ("int4_unpack_v1", "int4_unpack_v2",
                                      "int4_matmul_mma")))
#: the attention tools' runs on the card: (label, tool, its arguments, the
#: kernels it must launch, the kernels it must not)
FLASH = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
#: every tool run is bf16, so the tensor-core bodies of K2, K7 and K8 must
#: serve it; in the step and MFU runs, whose every call is at a default
#: tile, unfolded, they alone
WGMMA = ("flash_forward_wgmma", "flash_backward_dq_wgmma",
         "flash_backward_dkv_wgmma")
FLASH_BF16 = FLASH + WGMMA
STEP_ARGS = dict(size="small", batch=8, label_len=32, iters=3)
ATTENTION_TOOLS = (
    ("attn_headfold_probe", "attn_headfold_probe", {},
     ("flash_forward", "flash_forward_fold", "flash_forward_wgmma"), ()),
    ("attn_block_probe", "attn_block_probe", {}, FLASH_BF16, ()),
    ("train_step_breakdown --attn flash", "train_step_breakdown",
     dict(STEP_ARGS, attn="flash"), WGMMA, FLASH),
    ("train_step_breakdown --attn xla", "train_step_breakdown",
     dict(STEP_ARGS, attn="xla"), (), FLASH_BF16 + ("flash_forward_fold",)),
    ("mfu_study --only 0,10", "mfu_study", dict(only="0,10", steps=3),
     WGMMA, FLASH),
)
#: the libraries of the bf16 tensor-core bodies: K2's, then K7's and K8's
TENSOR_CORE_LIBS = ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                    "flash_bwd_dkv_sm90")
#: the libraries of the float32 (3xTF32) tensor-core bodies: K2's, K7's, K8's
TF32X3_LIBS = ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3",
               "flash_bwd_dkv_tf32x3")
#: the classification path: one frontend config per log-mel tier and body
#: (the last is featurized only: no classifier trains on it)
CLASSIFY_FRONTENDS = (("UrbanSound v2", {}, "log_mel_overlap_fft"),
                      ("PANNs geometry", PANNS_MEL, "log_mel_packed_fft"),
                      ("magnitude v2", MAGNITUDE_MEL, "log_mel_fft"),
                      ("magnitude n_fft 400", MAGNITUDE_400_MEL,
                       "log_mel_fft"))


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


def _graph_ms(torch, fn):
    """Device ms per call of ``fn``, slope-timed in CUDA graphs: the host's
    launch overhead (the wrapper's Python, some 40 us a call on the card's
    host) left out, for calls that take less than it on the card."""
    from audax_torch.utils.profiling import slope_timed
    return 1e3 * slope_timed(fn, (), iters=(5, 25), repeats=3,
                             device=torch.device("cuda"))


def _ptxas_kernels(report):
    """``[(template arguments, registers, spill bytes)]`` of each kernel in
    a library's ``-Xptxas -v`` report, in the order ptxas compiled them."""
    import re
    kernels, args, spill = [], "?", 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\S*?kernelI((?:Li\d+E)+)",
                      line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels.append((args, int(m.group(1)), spill))
            args, spill = "?", 0
    return kernels


def _bound(flops, nbytes, flop_rate):
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _filterbank(cfg):
    from audax_torch.ops.mel import mel_filterbank
    return mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                          cfg.fmax, htk=cfg.htk, norm_slaney=cfg.norm_slaney)


def _logmel_bound(cfg, b, n, frames):
    """Least time of the log-mel of ``b`` clips of ``n`` samples
    (``frames`` frames each), whichever kernel computes it: by its cheapest
    known route, a real FFT per frame (2.5 n_fft log2 n_fft operations),
    the window, |X|^p, the filterbank's nonzeros and the log; the padded
    clips read once, the mel written once."""
    import math

    import numpy as np
    nnz = int(np.count_nonzero(_filterbank(cfg)))
    per_frame = (2.5 * cfg.n_fft * math.log2(cfg.n_fft) + cfg.win
                 + cfg.n_freqs * (3 if cfg.power == 2.0 else 5)
                 + 2 * nnz + cfg.n_mels)
    n_pad = n + 2 * (cfg.n_fft // 2) if cfg.center else n
    rows = b * frames
    nbytes = 4 * (b * n_pad + rows * cfg.n_mels + nnz)
    return _bound(rows * per_frame, nbytes, F32_FLOPS)


def _library_logmel(torch, x, cfg):
    """The composite yardstick of a log-mel kernel (no single PyTorch call
    computes a log-mel): ``torch.stft`` (cuFFT) + |X|^p + the mel product +
    the log, with Whisper's clamp for the Whisper preset."""
    from audax_torch.ops.stft import apply_log

    window = torch.hann_window(cfg.win, device=x.device)
    fb = torch.from_numpy(_filterbank(cfg)).to(x.device)

    def library():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, cfg.win,
                          window=window, center=cfg.center,
                          pad_mode="reflect", return_complex=True)
        mel = spec.abs().pow(cfg.power).transpose(1, 2) @ fb
        return apply_log(mel, cfg.log_mode)
    return library


def _report(case, err, tol, ms, plain_ms, lib_ms, bound,
            err_name="max_abs_err"):
    lib = f"{lib_ms:.4f}" if lib_ms is not None else "null"
    print(f"[kernels] {case}: {err_name} {err:.3e} (tol {tol:.0e}) "
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
    from audax_torch.ops import fused_mel, native

    dev = "cuda"
    out = {}

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # ---- K1's tier: the FFT body at power 2, the overlap kernel elsewhere ---
    def frames_f64(x, cfg):
        """The raw log-mel of ``x`` from a float64 FFT (cuFFT) of the
        windowed frames, ``|X|^power``: the oracle the races' and A/Bs'
        errors are read against."""
        from audax_torch.ops.stft import apply_log
        frames, _ = fused_mel.direct_frames(x, cfg)
        window, fb, _, _ = fused_mel.fft_constants(cfg, x.device)
        spec = torch.fft.rfft(frames.double() * window.double())
        p = spec.real ** 2 + spec.imag ** 2
        if cfg.power != 2.0:
            p = p.sqrt() ** cfg.power
        mel = p @ fb.double()
        return apply_log(mel, "log1e6" if cfg.log_mode == "log1e6"
                         else "log10")

    def race_note(kern, old_fn, ms, old_ms, old_e, old_name, oracle, got,
                  old_got, ref):
        """The A/B's line: the old body's device ms and error, both bodies'
        eager (CUDA events) ms, and each body's and the plain version's
        error against the float64 oracle."""
        def f64(a):
            return err(a.reshape(oracle.shape), oracle)
        return (f", {old_name} ms {old_ms:.4f} max_abs_err {old_e:.3e} "
                f"({old_ms / ms:.2f}x the FFT body; CUDA-graph device "
                f"times; events ms {_time_ms(torch, kern):.4f} / "
                f"{_time_ms(torch, old_fn):.4f}); against a float64 FFT: "
                f"FFT body {f64(got):.3e}, {old_name} {f64(old_got):.3e}, "
                f"plain {f64(ref):.3e}")

    def faster(label, ms, old_ms):
        """The FFT body must beat the tier's own kernel where BODIES sends
        it the tier's work."""
        if not ms < old_ms:
            raise AssertionError(f"{label}: the FFT body takes {ms:.4f} ms, "
                                 f"the old body {old_ms:.4f}")

    def overlap_case(name, cfg, shape, x_rng, main=False, race=False):
        """K1's tier through the body ``fused_mel.mel_body`` names, held
        against the tier's plain version; with ``race`` the overlap kernel
        (``csrc/log_mel_overlap.cu``, its wrapper called directly) beside
        the FFT body on the same input, held and timed too, and slower."""
        t = np.arange(shape[1]) / 16000.0
        x = (0.3 * np.sin(2 * np.pi * 440 * t) * (1 + np.sin(t))
             + 0.05 * x_rng.standard_normal(shape)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        body = fused_mel.mel_body(cfg)
        kern = (fused_mel.log_mel_overlap_fft_cuda
                if body == "log_mel_overlap_fft"
                else fused_mel.log_mel_overlap_cuda)
        got = kern(x, cfg)
        ref = fused_mel.log_mel_overlap_plain(x, cfg)
        e = err(got, ref)
        ms = (_graph_ms if race else _time_ms)(torch, lambda: kern(x, cfg))
        plain = _time_ms(torch, lambda: fused_mel.log_mel_overlap_plain(x, cfg))
        library = _library_logmel(torch, x, cfg)
        if cfg.log_mode == "whisper":       # the kernel leaves the clamp out
            ref_lib = fused_mel.whisper_post_clamp(ref)
        else:
            ref_lib = ref
        lib_err = err(library(), ref_lib)
        lib = _time_ms(torch, library)
        bound = _logmel_bound(cfg, shape[0], shape[1], got.shape[1])
        old = ""
        if race:
            old_fn = lambda: fused_mel.log_mel_overlap_cuda(x, cfg)  # noqa: E731
            old_e = err(old_fn(), ref)
            old_ms = _graph_ms(torch, old_fn)
            old = race_note(lambda: kern(x, cfg), old_fn, ms, old_ms, old_e,
                            "overlap kernel", frames_f64(x, cfg), got,
                            old_fn(), ref)
            _report(f"log_mel_overlap[{name} {list(shape)}]", old_e, TOL_MEL,
                    old_ms, plain, lib, bound)
            if main:
                out["log_mel_overlap"] = dict(max_abs_err=old_e, ms=old_ms,
                                              plain_ms=plain, library_ms=lib,
                                              bound=bound)
        _report(f"{body}[{name} {list(shape)} -> {list(got.shape)}] "
                f"(composite library vs plain {lib_err:.3e}{old})", e,
                TOL_MEL, ms, plain, lib, bound)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{body}[{name}]: non-finite log-mel")
        if old:
            faster(f"{body}[{name}]", ms, old_ms)
        if main:
            out[body] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                             library_ms=lib, bound=bound)

    for name, cfg, shape in (("whisper", MelConfig.whisper(), (4, 480000)),
                             ("whisper 128 mels", MelConfig.whisper(128),
                              (8, 480000)),
                             ("urbansound_v2", MelConfig.urbansound_v2(),
                              (16, 64000))):
        overlap_case(name, cfg, shape, rng, main=name == "whisper",
                     race=True)
    # their own generator: the later phases keep drawing the inputs they
    # drew before these cases existed
    overlap_rng = np.random.default_rng(9)
    # Whisper's geometry at 200 bands (F = 201, the widest mel tile), and
    # the overlap kernel off the FFT body's sizes
    overlap_case("n_fft 400 hop 160 200 mels center=False",
                 MelConfig(n_fft=400, hop_length=160, n_mels=200,
                           center=False), (3, 16001), overlap_rng)
    overlap_case("n_fft 480 hop 160", MelConfig(n_fft=480, hop_length=160),
                 (4, 64000), overlap_rng)
    # more than 256 bands on the FFT body in K1's tier
    overlap_case("n_fft 1024 hop 512 320 mels",
                 MelConfig(n_fft=1024, hop_length=512, n_mels=320),
                 (4, 64000), overlap_rng)

    # ---- K4 / K5: direct log-mel (packed; generic) ----------------------------
    from audax_torch.ops import direct_mel

    # their own generator: the later phases keep drawing the inputs they
    # drew before these cases existed
    direct_rng = np.random.default_rng(4)

    def direct_case(label, cfg, shape, main, silent=False, race=False,
                    direct_ab=False):
        """K4's or K5's tier through the body ``fused_mel.mel_body`` names,
        held against the tier's plain version (K5's bodies against the
        direct DFT's, on the bases of frontend_constants); a direct body
        must launch once per chunk of ``band_chunks``, the FFT body once.
        With ``race`` K4's packed kernel beside the FFT body, held and timed
        too, and slower; with ``direct_ab`` K5's direct body beside its FFT
        body on the same frames, held and timed in the same run."""
        t = np.arange(shape[1]) / 16000.0
        x = (0.3 * np.sin(2 * np.pi * 440 * t) * (1 + np.sin(t))
             + 0.05 * direct_rng.standard_normal(shape)).astype(np.float32)
        if silent:                 # one silent clip: its log floor is finite
            x[0] = 0.0
        x = torch.from_numpy(x).to(dev)
        frames, _ = fused_mel.direct_frames(x, cfg)
        consts = fused_mel.direct_constants(cfg, x.device)
        mode = "log1e6" if cfg.log_mode == "log1e6" else "log10"
        name = fused_mel.mel_body(cfg)
        if name in ("log_mel_packed_fft", "log_mel_fft"):
            fconsts = fused_mel.fft_constants(cfg, x.device)
        packed = lambda: direct_mel.fused_logmel_packed_cuda(  # noqa: E731
            frames, *consts, mode)
        if name == "log_mel_packed_fft":
            kern = lambda: direct_mel.fused_logmel_packed_fft_cuda(  # noqa: E731
                frames, *fconsts, mode)
        elif name == "log_mel_packed":
            kern = packed
        elif name == "log_mel_fft":
            kern = lambda: direct_mel.fused_logmel_fft_cuda(  # noqa: E731
                frames, *fconsts, mode, cfg.power)
        else:
            kern = lambda: direct_mel.fused_logmel_frames_cuda(  # noqa: E731
                frames, *consts, mode, cfg.power)
        if cfg.power == 2.0:
            plain = lambda: direct_mel.fused_logmel_packed_plain(  # noqa: E731
                frames, *consts, mode)
        else:
            plain = lambda: direct_mel.fused_logmel_frames_plain(  # noqa: E731
                frames, *consts, mode, cfg.power)
        counter = {"log_mel_packed": direct_mel.fused_logmel_packed_cuda,
                   "log_mel_generic": direct_mel.fused_logmel_frames_cuda,
                   "log_mel_fft": direct_mel.fused_logmel_fft_cuda,
                   "log_mel_packed_fft":
                       direct_mel.fused_logmel_packed_fft_cuda}[name]
        want = (len(direct_mel.band_chunks(cfg.n_mels))
                if name in ("log_mel_packed", "log_mel_generic") else 1)
        n0 = counter.launches
        got = kern()
        if counter.launches - n0 != want:
            raise AssertionError(f"{name}[{label}]: {counter.launches - n0} "
                                 f"launches for {cfg.n_mels} bands, not "
                                 f"{want}")
        ref = plain()
        e = err(got, ref)
        if want > 1:
            label += f", {want} launches of <= {direct_mel.MAX_MELS} bands"
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}[{label}]: non-finite log-mel")
        if silent:
            floor = math.log(1e-6) if mode == "log1e6" else -10.0
            e_floor = float((got[0] - floor).abs().max())
            if not e_floor <= TOL_MEL:
                raise AssertionError(f"{name}[{label}]: the silent clip is "
                                     f"{e_floor:.3e} off the log floor")
            label += f", silent clip at the floor within {e_floor:.1e}"
        ms = (_graph_ms if race else _time_ms)(torch, kern)
        plain_ms = _time_ms(torch, plain)
        library = _library_logmel(torch, x, cfg)
        lib_err = err(library(), ref)
        lib = _time_ms(torch, library)
        bound = _logmel_bound(cfg, shape[0], shape[1], frames.shape[1])
        old = ""
        if race:
            old_e = err(packed(), ref)
            old_ms = _graph_ms(torch, packed)
            old = race_note(kern, packed, ms, old_ms, old_e, "packed kernel",
                            frames_f64(x, cfg), got, packed(), ref)
            _report(f"log_mel_packed[{label} x {list(shape)}]", old_e,
                    TOL_MEL, old_ms, plain_ms, lib, bound)
            if main:
                out["log_mel_packed"] = dict(max_abs_err=old_e, ms=old_ms,
                                             plain_ms=plain_ms,
                                             library_ms=lib, bound=bound)
        _report(f"{name}[{label} x {list(shape)} -> {list(got.shape)}] "
                f"(composite library vs plain {lib_err:.3e}{old})", e,
                TOL_MEL, ms, plain_ms, lib, bound)
        if race:
            faster(f"{name}[{label}]", ms, old_ms)
        if main:
            out[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib, bound=bound)
        if direct_ab:
            direct = lambda: direct_mel.fused_logmel_frames_cuda(  # noqa: E731
                frames, *consts, mode, cfg.power)
            dgot = direct()
            de = err(dgot, ref)
            dms = _time_ms(torch, direct)
            oracle = frames_f64(x, cfg).reshape(got.shape)
            _report(f"log_mel_generic[{label} x {list(shape)}] (K5's direct "
                    "body beside its FFT body)", de, TOL_MEL, dms, plain_ms,
                    lib, bound)
            print(f"[kernels] K5 [{label}] A/B in one run on frames "
                  f"{list(frames.shape)}: FFT body {ms:.4f} ms, direct body "
                  f"{dms:.4f} ms ({dms / ms:.2f}x), composite {lib:.4f} ms, "
                  f"plain {plain_ms:.4f} ms; against a float64 FFT: FFT "
                  f"body {err(got, oracle):.3e}, direct body "
                  f"{err(dgot, oracle):.3e}, plain {err(ref, oracle):.3e}",
                  flush=True)

    # the classification path's shapes: 64 clips of 4 s per featurize batch
    direct_case("PANNs geometry", MelConfig(**PANNS_MEL), (64, 64000), True,
                race=True)
    direct_case("magnitude v2", MelConfig(**MAGNITUDE_MEL), (64, 64000),
                True)
    direct_case("magnitude n_fft 400", MelConfig(**MAGNITUDE_400_MEL),
                (64, 64000), False, direct_ab=True)
    # ragged edges: n_fft 400 (not a multiple of 32), a short window, log10,
    # center=False, odd F with a power of 1.5, 200 and 256 mel bands
    direct_case("n_fft 400 win 320 hop 160 80 mels log10",
                MelConfig(n_fft=400, win_length=320, hop_length=160,
                          n_mels=80, log_mode="log10"), (4, 16001), False)
    direct_case("n_fft 400 power 1.5 200 mels center=False",
                MelConfig(n_fft=400, hop_length=160, n_mels=200, power=1.5,
                          center=False), (3, 16001), False)
    direct_case("n_fft 1024 hop 100 256 mels",
                MelConfig(n_fft=1024, hop_length=100, n_mels=256),
                (2, 8000), False)
    # the FFT body off the main shape: 256 bands at power 1.5, n_fft 512
    # and 2048 unpadded, and a silent clip
    direct_case("n_fft 1024 hop 100 256 mels power 1.5",
                MelConfig(n_fft=1024, hop_length=100, n_mels=256, power=1.5),
                (2, 8000), False)
    direct_case("n_fft 512 hop 160 power 1 center=False",
                MelConfig(n_fft=512, hop_length=160, power=1.0,
                          center=False), (3, 16001), False)
    direct_case("n_fft 2048 hop 512 power 1 center=False",
                MelConfig(n_fft=2048, hop_length=512, power=1.0,
                          center=False), (3, 16001), False)
    direct_case("magnitude v2", MelConfig(**MAGNITUDE_MEL), (4, 64000),
                False, silent=True)
    # the 400-point body at a short window, unpadded, in log10, with a
    # silent clip; the packed kernel off the FFT body's sizes
    direct_case("n_fft 400 win 320 hop 160 80 mels log10 center=False",
                MelConfig(n_fft=400, win_length=320, hop_length=160,
                          n_mels=80, log_mode="log10", center=False),
                (4, 16001), False, silent=True)
    direct_case("n_fft 1000 hop 160", MelConfig(n_fft=1000, hop_length=160),
                (4, 64000), False)
    # K5's direct body at the classification path's batch, off the FFT
    # body's sizes (n_fft 1000)
    direct_case("magnitude n_fft 1000", MelConfig(**MAGNITUDE_1000_MEL),
                (64, 64000), True)
    # more than 256 bands: the FFT body in K4's and K5's tiers (320), and
    # both direct bodies (512), one launch per chunk of 256 bands
    direct_case("n_fft 1024 hop 160 320 mels",
                MelConfig(n_fft=1024, hop_length=160, n_mels=320),
                (4, 16000), False)
    direct_case("n_fft 1024 hop 256 320 mels power 1",
                MelConfig(n_fft=1024, hop_length=256, n_mels=320, power=1.0),
                (4, 16000), False)
    direct_case("n_fft 1000 hop 160 512 mels",
                MelConfig(n_fft=1000, hop_length=160, n_mels=512),
                (4, 16000), False)
    direct_case("n_fft 1000 hop 160 512 mels power 1.5",
                MelConfig(n_fft=1000, hop_length=160, n_mels=512, power=1.5),
                (4, 16000), False)

    # ---- K2: flash forward ---------------------------------------------------
    #: K2's bodies: the launcher that counts each (launch_flash_forward runs
    #: the CUDA-core body uncounted), the rate that bounds it, and its key
    #: in the kernels line
    k2_bodies = {"cuda_core": (None, F32_FLOPS, "flash_forward"),
                 "tf32x3": (att.flash_forward_tf32x3_cuda, TF32X3_FLOPS,
                            "flash_forward_tf32x3"),
                 "wgmma": (att.flash_forward_wgmma_cuda, BF16_FLOPS,
                           "flash_forward_wgmma")}

    def flash_case(label, b, hq, hkv, tq, tk, dtype, causal, tol, main,
                   tile=(None, None), gen=None, d=64, kv_len=None,
                   core_ab=False):
        """K2 on the body ``FWD_BODIES`` names, held (o and lse) against
        the plain version; with ``core_ab`` the same call on the CUDA-core
        body too, held and timed in the same run."""
        q = torch.randn(b, hq, tq, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, hkv, tk, d, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, hkv, tk, d, device=dev, generator=gen).to(dtype)
        bq, bk = tile
        kv = tk if kv_len is None else kv_len
        body = att.fwd_body(dtype, d, bq, bk)
        _, rate, key = k2_bodies[body]

        def kern(body=None):
            return att.launch_flash_forward(q, k, v, causal=causal,
                                            block_q=bq, block_k=bk,
                                            kv_len=kv, body=body)
        counted = {n: c for n, (c, _, _) in k2_bodies.items() if c}
        before = {n: c.launches for n, c in counted.items()}
        o, lse = kern()
        ran = {n: c.launches - before[n] for n, c in counted.items()}
        if ran != {n: int(n == body) for n in counted}:
            raise AssertionError(f"{key}[{label}]: the {body} body did not "
                                 f"serve the call alone, once ({ran})")
        ks, vs = k[:, :, :kv], v[:, :, :kv]
        o_ref, lse_ref = att.flash_forward_plain(q, ks, vs, causal=causal)
        e = max(err(o, o_ref), err(lse, lse_ref))
        if dtype == torch.bfloat16:
            # each element of o against the rounding bf16 allows: both
            # sides round p to bf16 (relative 2^-8 each, the kernel before
            # normalising, the plain version after), so o moves by at most
            # 2^-7 of the attention-weighted |v| (P|V|, in float32 here),
            # and each rounds its output (one bf16 step of the larger
            # between them); 2^-12 of P|V| more for float32 sums
            pv = att.flash_forward_plain(q.float(), ks.float(),
                                         vs.float().abs(), causal=causal)[0]
            a, r = o.float(), o_ref.float()
            big = torch.maximum(a.abs(), r.abs())
            step = torch.where(big > 0, torch.ldexp(
                torch.ones_like(big), torch.frexp(big)[1] - 8), 0.0)
            steps = float(((a - r).abs() / ((2 ** -7 + 2 ** -12) * pv
                                             + step)).max())
            print(f"[kernels] {key}[{label}]: o at {steps:.3f} of its "
                  "bf16 rounding bound", flush=True)
            if not steps <= 1.0:
                raise AssertionError(f"{key}[{label}]: o off the plain "
                                     f"version by {steps:.3f} of the bf16 "
                                     "rounding bound")
        ms = _time_ms(torch, kern)
        plain = _time_ms(torch, lambda: att.flash_forward_plain(
            q, ks, vs, causal=causal))
        lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ks, vs, is_causal=causal, enable_gqa=hq != hkv))
        pairs = tq * (tq + 1) // 2 if causal else tq * kv
        flops = 4 * b * hq * pairs * d
        elt = q.element_size()
        nbytes = elt * d * (2 * b * hq * tq + 2 * b * hkv * kv) + 4 * b * hq * tq
        bound = _bound(flops, nbytes, rate)
        _report(f"{key}[{label}] ({body} body, o and lse)", e, tol, ms,
                plain, lib, bound)
        if main:
            out[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                            library_ms=lib, bound=bound)
        if core_ab:
            co, clse = kern("cuda_core")
            ce = max(err(co, o_ref), err(clse, lse_ref))
            cms = _time_ms(torch, lambda: kern("cuda_core"))
            cbound = _bound(flops, nbytes, F32_FLOPS)
            _report(f"flash_forward[{label}] (cuda_core body, o and lse)",
                    ce, tol, cms, plain, lib, cbound)
            print(f"[kernels] K2 [{label}] A/B in one run: {body} body "
                  f"{ms:.4f} ms, CUDA-core body {cms:.4f} ms "
                  f"({cms / ms:.2f}x), SDPA {lib:.4f} ms; bound "
                  f"{bound[0]:.4f} ms ({body}) / {cbound[0]:.4f} ms (CUDA "
                  "cores)", flush=True)
            if main:
                out["flash_forward"] = dict(max_abs_err=ce, ms=cms,
                                            plain_ms=plain, library_ms=lib,
                                            bound=cbound)

    f32 = torch.float32
    flash_case("f32 [4,6,1500,64]", 4, 6, 6, 1500, 1500, f32, False,
               TOL_F32, True, core_ab=True)
    flash_case("bf16 [4,6,1500,64]", 4, 6, 6, 1500, 1500, torch.bfloat16,
               False, TOL_BF16, False)
    flash_case("f32 causal GQA 8q/2kv T=200", 2, 8, 2, 200, 200, f32, True,
               TOL_F32, False)
    # the fine-tune path's sites at Whisper-base width
    flash_case("f32 [4,8,1500,64]", 4, 8, 8, 1500, 1500, f32, False,
               TOL_F32, False)
    flash_case("f32 cross q [4,8,56,64] kv [4,8,1500,64]", 4, 8, 8, 56, 1500,
               f32, False, TOL_F32, False)
    flash_case("f32 decoder self causal [4,8,56,64]", 4, 8, 8, 56, 56, f32,
               True, TOL_F32, False)
    # K2's float32 body on the tensor cores off the main shape: a ragged key
    # count, head dims 16/32/128, and the serving encoder at Whisper-large-
    # v3-turbo width (8 windows, 20 heads) beside the CUDA-core body; on
    # their own generator
    gen11 = torch.Generator(device=dev).manual_seed(11)
    flash_case("f32 ragged kv_len 1400 of 1536 rows", 4, 6, 6, 1500, 1536,
               f32, False, TOL_F32, False, gen=gen11, kv_len=1400)
    for d in (16, 32, 128):
        flash_case(f"f32 head_dim {d} [4,8,300,{d}]", 4, 8, 8, 300, 300, f32,
                   False, TOL_F32, False, gen=gen11, d=d)
        flash_case(f"f32 head_dim {d} causal GQA 8q/4kv T=130", 2, 8, 4, 130,
                   130, f32, True, TOL_F32, False, gen=gen11, d=d)
    flash_case("f32 serving [8,20,1500,64]", 8, 20, 20, 1500, 1500, f32,
               False, TOL_F32, False, gen=gen11, core_ab=True)
    # K2's bf16 body on the tensor cores (csrc/flash_fwd_sm90.cu): Whisper-
    # small's encoder (the bf16 fine-tune step's shape), the masks, head
    # dims 16/32/128 and every tile it is built at; on their own generator
    gen9 = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16
    flash_case("bf16 [8,12,1500,64]", 8, 12, 12, 1500, 1500, bf16, False,
               TOL_BF16, True, gen=gen9)
    flash_case("bf16 causal GQA 8q/2kv T=200", 2, 8, 2, 200, 200, bf16,
               True, TOL_BF16, False, gen=gen9)
    flash_case("bf16 cross q [4,8,56,64] kv [4,8,1500,64]", 4, 8, 8, 56,
               1500, bf16, False, TOL_BF16, False, gen=gen9)
    flash_case("bf16 ragged kv_len 1400 of 1536 rows", 4, 6, 6, 1500, 1536,
               bf16, False, TOL_BF16, False, gen=gen9, kv_len=1400)
    for d in (16, 32, 128):
        flash_case(f"bf16 head_dim {d} [4,8,300,{d}]", 4, 8, 8, 300, 300,
                   bf16, False, TOL_BF16, False, gen=gen9, d=d)
        flash_case(f"bf16 head_dim {d} causal GQA 8q/4kv T=130", 2, 8, 4,
                   130, 130, bf16, True, TOL_BF16, False, gen=gen9, d=d)
    for tile in att.TILES:
        if tile[0] >= 64 and tile != att.WGMMA_TILE:
            flash_case(f"bf16 [8,12,1500,64] block_q {tile[0]} block_k "
                       f"{tile[1]}", 8, 12, 12, 1500, 1500, bf16, False,
                       TOL_BF16, False, tile=tile, gen=gen9)

    # ---- K3: stacked decode attention -----------------------------------------
    def decode_case(label, s_len, pos, main, h=6, hkv=6, tq=1, gen=None):
        L, b, d = 4, 4, 64
        q = torch.randn(b, h, tq, d, device=dev, generator=gen)
        k = torch.randn(L, b, hkv, s_len, d, device=dev, generator=gen)
        v = torch.randn(L, b, hkv, s_len, d, device=dev, generator=gen)
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
    # more rows than one launch takes (a speculative prefill): chunks of 16
    # at pos + 0, 16, 32, each row masked at its own position
    gen = torch.Generator(device=dev).manual_seed(6)
    decode_case("self Tq=40 in chunks of 16, pos [0,17,200,400]", 448,
                [0, 17, 200, 400], False, tq=40, gen=gen)

    # ---- K7 / K8: flash backward (dQ; dK and dV) ------------------------------
    # each kernel's counted launchers by body, its plain version beside them;
    # the rate that bounds each body in float32 (in bf16 every body is
    # bounded at the bf16 tensor cores' peak)
    bwd_bodies = {kn: {"cuda_core": getattr(att, f"flash_backward_{kn}_cuda"),
                       "tf32x3": getattr(att,
                                         f"flash_backward_{kn}_tf32x3_cuda"),
                       "wgmma": getattr(att, f"flash_backward_{kn}_wgmma_cuda"),
                       "plain": getattr(att, f"flash_backward_{kn}_plain")}
                  for kn in ("dq", "dkv")}
    f32_rates = {"cuda_core": F32_FLOPS, "tf32x3": TF32X3_FLOPS}
    suffix = {"cuda_core": "", "tf32x3": "_tf32x3", "wgmma": "_wgmma"}

    def core_bwd(kn, q, k, v, do, lse, delta, causal, tile):
        """One launch of the CUDA-core body (csrc/flash_bwd.cu), its library
        called directly at ``tile``, in q's dtype: the A/B of the bodies."""
        b, hq, tq, d = q.shape
        outs = ([torch.empty_like(q)] if kn == "dq"
                else [torch.empty_like(k), torch.empty_like(v)])
        lib = native.library(f"flash_bwd_{kn}")
        status = getattr(lib, f"flash_bwd_{kn}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b, hq, k.shape[1], tq, k.shape[2], d, d ** -0.5, int(causal),
            int(q.dtype == torch.bfloat16), *tile,
            torch.cuda.current_stream().cuda_stream)
        native.check(status, f"flash_bwd_{kn}")
        return outs

    def bwd_case(label, b, hq, hkv, tq, tk, dtype, causal, tol, main,
                 tile=(None, None), gen=None, d=64, reps=20, plain_reps=5,
                 core_ab=False):
        """K7 and K8 on the bodies ``BWD_BODIES`` names, held against the
        plain versions (relative to the plain gradient's largest value);
        with ``core_ab`` the same call on the CUDA-core body at 64 x 64
        too, held and timed in the same run, which both bodies must beat.
        ``main`` records the bodies' rows of the kernels line, and in
        float32 with ``core_ab`` the CUDA-core rows too."""
        q = torch.randn(b, hq, tq, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, hkv, tk, d, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, hkv, tk, d, device=dev, generator=gen).to(dtype)
        do = torch.randn(b, hq, tq, d, device=dev, generator=gen).to(dtype)
        o, lse = att.flash_forward_cuda(q, k, v, causal=causal)
        args = (q, k, v, o, lse, do)
        delta = att._delta(o, do)       # shared by both kernels on the path
        tiles = dict(block_q=tile[0], block_k=tile[1])
        # the body BWD_BODIES names must serve each kernel exactly once, and
        # no other body nor the plain version
        bodies = {kn: att.bwd_body(kn, dtype, d, *tile) for kn in bwd_bodies}
        before = {kn: {n: f.launches for n, f in fns.items()}
                  for kn, fns in bwd_bodies.items()}
        dq = att.flash_backward_dq_cuda(*args, causal=causal, delta=delta,
                                        **tiles)
        dk, dv = att.flash_backward_dkv_cuda(*args, causal=causal,
                                             delta=delta, **tiles)
        for kn, fns in bwd_bodies.items():
            ran = {n: f.launches - before[kn][n] for n, f in fns.items()}
            if ran != {n: int(n == bodies[kn]) for n in fns}:
                raise AssertionError(f"flash_backward_{kn}[{label}]: the "
                                     f"{bodies[kn]} body did not serve the "
                                     f"call alone, once ({ran})")
        rdq = att.flash_backward_dq_plain(*args, causal=causal)
        rdk, rdv = att.flash_backward_dkv_plain(*args, causal=causal)

        def rel(a, r):        # max |err| scaled by the plain gradient's max
            return err(a, r) / float(r.float().abs().max())
        e_dq, e_dkv = rel(dq, rdq), max(rel(dk, rdk), rel(dv, rdv))
        ms_dq = _time_ms(torch, lambda: att.flash_backward_dq_cuda(
            *args, causal=causal, delta=delta, **tiles), reps=reps)
        ms_dkv = _time_ms(torch, lambda: att.flash_backward_dkv_cuda(
            *args, causal=causal, delta=delta, **tiles), reps=reps)
        plain_dq = _time_ms(torch, lambda: att.flash_backward_dq_plain(
            *args, causal=causal), reps=plain_reps, warmup=1)
        plain_dkv = _time_ms(torch, lambda: att.flash_backward_dkv_plain(
            *args, causal=causal), reps=plain_reps, warmup=1)
        # yardstick: the backward alone of SDPA (all three gradients), on a
        # graph built once
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                              enable_gqa=hq != hkv)
        lib = _time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do, retain_graph=True), reps=reps)
        pairs = tq * (tq + 1) // 2 if causal else tq * tk
        elt = q.element_size()
        rows_q, rows_kv = b * hq * tq, b * hkv * tk

        def bounds(body):
            """(dQ, dK/dV) bounds on ``body``: dQ's S, dP and dS K (6 per
            pair and dim) against q, do, k, v, lse, delta read and dq
            written; dK/dV's S, dP, P^T dO and dS^T Q (8) against dk, dv
            written"""
            rate = (f32_rates[body] if dtype == torch.float32
                    else BF16_FLOPS)
            return (_bound(6 * b * hq * pairs * d,
                           elt * d * (3 * rows_q + 2 * rows_kv) + 8 * rows_q,
                           rate),
                    _bound(8 * b * hq * pairs * d,
                           elt * d * (2 * rows_q + 4 * rows_kv) + 8 * rows_q,
                           rate))
        bound_dq, bound_dkv = bounds(bodies["dq"])[0], bounds(bodies["dkv"])[1]
        keys = {kn: f"flash_backward_{kn}{suffix[bodies[kn]]}"
                for kn in bwd_bodies}
        _report(f"{keys['dq']}[{label}] ({bodies['dq']} body)", e_dq, tol,
                ms_dq, plain_dq, lib, bound_dq, "max_rel_err")
        _report(f"{keys['dkv']}[{label}] ({bodies['dkv']} body)", e_dkv, tol,
                ms_dkv, plain_dkv, lib, bound_dkv, "max_rel_err")
        if main:
            out[keys["dq"]] = dict(
                max_abs_err=err(dq, rdq), ms=ms_dq, plain_ms=plain_dq,
                library_ms=lib, bound=bound_dq)
            out[keys["dkv"]] = dict(
                max_abs_err=max(err(dk, rdk), err(dv, rdv)), ms=ms_dkv,
                plain_ms=plain_dkv, library_ms=lib, bound=bound_dkv)
        if not core_ab:
            return
        # the same call on the CUDA-core body (csrc/flash_bwd.cu) at 64 x
        # 64, held against the plain versions too: the tensor-core bodies
        # must beat it
        cdq, = core_bwd("dq", q, k, v, do, lse, delta, causal, (64, 64))
        cdk, cdv = core_bwd("dkv", q, k, v, do, lse, delta, causal, (64, 64))
        e_core = max(rel(cdq, rdq), rel(cdk, rdk), rel(cdv, rdv))
        if not e_core <= tol:
            raise AssertionError(f"K7/K8 [{label}]: the CUDA-core body is "
                                 f"off the plain versions by {e_core}")
        core = {kn: _time_ms(torch, lambda kn=kn: core_bwd(
            kn, q, k, v, do, lse, delta, causal, (64, 64)), reps=3,
            warmup=1) for kn in bwd_bodies}
        core_bounds = bounds("cuda_core")
        print(f"[kernels] K7/K8 [{label}] A/B in one run: {bodies['dq']} / "
              f"{bodies['dkv']} {ms_dq:.4f} + {ms_dkv:.4f} ms, CUDA-core "
              f"body (64 x 64, max_rel_err {e_core:.3e}) {core['dq']:.4f} + "
              f"{core['dkv']:.4f} ms ({core['dq'] / ms_dq:.2f}x, "
              f"{core['dkv'] / ms_dkv:.2f}x), SDPA's backward {lib:.4f} ms; "
              f"bound {bound_dq[0]:.4f} + {bound_dkv[0]:.4f} ms "
              f"({bodies['dq']}) / {core_bounds[0][0]:.4f} + "
              f"{core_bounds[1][0]:.4f} ms (CUDA cores)", flush=True)
        if not (ms_dq < core["dq"] and ms_dkv < core["dkv"]):
            raise AssertionError(f"K7/K8 [{label}]: a tensor-core body is "
                                 "not faster than the CUDA-core body")
        if main and dtype == torch.float32:
            out["flash_backward_dq"] = dict(
                max_abs_err=err(cdq, rdq), ms=core["dq"], plain_ms=plain_dq,
                library_ms=lib, bound=core_bounds[0])
            out["flash_backward_dkv"] = dict(
                max_abs_err=max(err(cdk, rdk), err(cdv, rdv)),
                ms=core["dkv"], plain_ms=plain_dkv, library_ms=lib,
                bound=core_bounds[1])

    bwd_case("encoder f32 [4,8,1500,64]", 4, 8, 8, 1500, 1500, torch.float32,
             False, TOL_F32, True, core_ab=True)
    bwd_case("encoder bf16 [4,8,1500,64]", 4, 8, 8, 1500, 1500,
             torch.bfloat16, False, TOL_BF16, False)
    # the bf16 fine-tune step's encoder shape (Whisper-small, B = 8), on the
    # lse of K2's tensor-core body, beside SDPA's bf16 backward and the
    # CUDA-core body
    bwd_case("encoder bf16 [8,12,1500,64]", 8, 12, 12, 1500, 1500,
             torch.bfloat16, False, TOL_BF16, True, gen=gen9, core_ab=True)
    bwd_case("decoder self causal f32 [4,8,56,64]", 4, 8, 8, 56, 56,
             torch.float32, True, TOL_F32, False)
    bwd_case("cross f32 q [4,8,56,64] kv [4,8,1500,64]", 4, 8, 8, 56, 1500,
             torch.float32, False, TOL_F32, False, core_ab=True)
    bwd_case("causal GQA 8q/2kv T=77 f32", 2, 8, 2, 77, 77, torch.float32,
             True, TOL_F32, False)
    # K7/K8's float32 bodies on the tensor cores at head dims 16/32/128 and
    # at the longest sums of the encoder shape (K8's over a q-head group of
    # four times 1500 queries), on their own generator
    gen12 = torch.Generator(device=dev).manual_seed(12)
    bwd_case("f32 GQA 8q/2kv [4,8,1500,64]", 4, 8, 2, 1500, 1500,
             torch.float32, False, TOL_F32, False, gen=gen12, reps=5)
    for d in (16, 32, 128):
        bwd_case(f"f32 head_dim {d} [4,8,300,{d}]", 4, 8, 8, 300, 300,
                 torch.float32, False, TOL_F32, False, gen=gen12, d=d, reps=5)
        bwd_case(f"f32 head_dim {d} causal GQA 8q/4kv T=130", 2, 8, 4, 130,
                 130, torch.float32, True, TOL_F32, False, gen=gen12, d=d,
                 reps=5)
    # K7/K8's bf16 bodies on the tensor cores (csrc/flash_bwd_sm90.cu): the
    # bf16 step's decoder sites at Whisper-small width (40 label tokens),
    # the masks and head dims 16/32/128, on their own generator
    gen8 = torch.Generator(device=dev).manual_seed(8)
    bf16 = torch.bfloat16
    bwd_case("decoder self causal bf16 [8,12,40,64]", 8, 12, 12, 40, 40,
             bf16, True, TOL_BF16, False, gen=gen8)
    bwd_case("cross bf16 q [8,12,40,64] kv [8,12,1500,64]", 8, 12, 12, 40,
             1500, bf16, False, TOL_BF16, False, gen=gen8)
    # the bf16 Whisper-base fine-tune's decoder sites (56 label tokens)
    bwd_case("decoder self causal bf16 [4,8,56,64]", 4, 8, 8, 56, 56, bf16,
             True, TOL_BF16, False, gen=gen8)
    bwd_case("cross bf16 q [4,8,56,64] kv [4,8,1500,64]", 4, 8, 8, 56, 1500,
             bf16, False, TOL_BF16, False, gen=gen8)
    bwd_case("causal GQA 8q/2kv T=77 bf16", 2, 8, 2, 77, 77, bf16, True,
             TOL_BF16, False, gen=gen8)
    for d in (16, 32, 128):
        bwd_case(f"bf16 head_dim {d} [4,8,300,{d}]", 4, 8, 8, 300, 300, bf16,
                 False, TOL_BF16, False, gen=gen8, d=d, reps=5)
        bwd_case(f"bf16 head_dim {d} causal GQA 8q/4kv T=130", 2, 8, 4, 130,
                 130, bf16, True, TOL_BF16, False, gen=gen8, d=d, reps=5)
    # every caller-set bf16 tile, on whichever body BWD_BODIES names for
    # each kernel (few reps: the tile sweep itself is attn_block_probe's)
    for tile in att.TILES:
        if tile != att.BWD_WGMMA_TILE:
            bwd_case(f"bf16 [8,12,1500,64] block_q {tile[0]} block_k "
                     f"{tile[1]}", 8, 12, 12, 1500, 1500, bf16, False,
                     TOL_BF16, False, tile=tile, gen=gen8, reps=3,
                     plain_reps=1)

    # ---- caller-set tiles of K2, K7, K8 and P1 (K2 folding heads) -------------
    # on their own generator: the later phases keep the inputs they drew
    # before these cases existed
    gen = torch.Generator(device=dev).manual_seed(7)
    for tile in att.TILES:
        if tile == (64, 64):
            continue
        label = f"f32 [4,8,1500,64] block_q {tile[0]} block_k {tile[1]}"
        flash_case(label, 4, 8, 8, 1500, 1500, torch.float32, False,
                   TOL_F32, False, tile=tile, gen=gen)
        bwd_case(label, 4, 8, 8, 1500, 1500, torch.float32, False, TOL_F32,
                 False, tile=tile, gen=gen)
    out["flash_forward_fold"] = fold_cases(torch, gen)

    # ---- K3 int8 arm and K6 (K3's kernel at L = 1) ----------------------------
    from audax_torch.models.whisper import quantize_kv

    def deq(codes, scales):
        return codes.float() * scales[..., None]

    def q8_case(label, L, b, h, s_len, pos, main):
        d = 64
        q = torch.randn(b, h, 1, d, device=dev)
        kv = quantize_kv(torch.randn(L, b, h, s_len, d, device=dev),
                         torch.randn(L, b, h, s_len, d, device=dev))
        pos_t = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if pos is not None else None)
        e = max(err(att.decode_attention_stacked_int8_cuda(q, kv, li,
                                                           pos=pos_t),
                    att.decode_attention_stacked_int8_plain(q, kv, li,
                                                            pos=pos_t))
                for li in range(L))
        it = iter(range(10 ** 9))         # cycle the layers past the L2
        ms = _time_ms(torch, lambda: att.decode_attention_stacked_int8_cuda(
            q, kv, next(it) % L, pos=pos_t))
        plain = _time_ms(torch, lambda: att.decode_attention_stacked_int8_plain(
            q, kv, next(it) % L, pos=pos_t))
        kf, vf = deq(kv.k_q, kv.k_scale), deq(kv.v_q, kv.v_scale)
        if pos is None:
            mask, pos = None, [s_len] * b
        else:
            cols = torch.arange(s_len, device=dev)
            mask = (cols[None, None, :] <= pos_t[:, None, None].long()
                    )[:, None]

        def sdpa():
            li = next(it) % L
            return F.scaled_dot_product_attention(q, kf[li], vf[li],
                                                  attn_mask=mask)
        lib = _time_ms(torch, sdpa)
        rows = sum(min(s_len, p + 1) for p in pos)
        # one layer's valid int8 K/V rows and their scales, q in, o out
        nbytes = h * rows * 2 * (d + 4) + 4 * 2 * b * h * d
        bound = _bound(4 * d * h * rows, nbytes, F32_FLOPS)
        _report(f"decode_attention_stacked_int8[{label}]", e, TOL_F32, ms,
                plain, lib, bound)
        if main:
            out["decode_attention_stacked_int8"] = dict(
                max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib,
                bound=bound)

    q8_case("cross [4,8,20,1500,64] pos=None", 4, 8, 20, 1500, None, True)
    pos = [int(p) for p in rng.integers(0, 68, size=8)]
    q8_case(f"self [4,8,20,68,64] pos {pos}", 4, 8, 20, 68, pos, False)

    def k6_case(label, quant, pos, main):
        b, h, s_len, d = 8, 20, 1500, 64
        q = torch.randn(b, h, 1, d, device=dev)
        k = torch.randn(b, h, s_len, d, device=dev)
        v = torch.randn(b, h, s_len, d, device=dev)
        kv = quantize_kv(k, v) if quant else (k, v)
        kf, vf = ((deq(kv.k_q, kv.k_scale), deq(kv.v_q, kv.v_scale))
                  if quant else (k, v))
        e = err(att.decode_attention_cuda(q, kv, pos=pos),
                att.decode_attention_plain(q, kv, pos=pos))
        ms = _time_ms(torch, lambda: att.decode_attention_cuda(q, kv, pos=pos))
        plain = _time_ms(torch, lambda: att.decode_attention_plain(
            q, kv, pos=pos))
        mask = (None if pos is None else
                torch.arange(s_len, device=dev)[None, None, None] <= pos)
        lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kf, vf, attn_mask=mask))
        rows = b * h * (s_len if pos is None else min(s_len, pos + 1))
        elt = 1 if quant else 4
        nbytes = rows * 2 * (d * elt + (4 if quant else 0)) + 8 * b * h * d
        bound = _bound(4 * d * rows, nbytes, F32_FLOPS)
        _report(f"decode_attention[{label}]", e, TOL_F32, ms, plain, lib,
                bound)
        if main:
            out["decode_attention"] = dict(max_abs_err=e, ms=ms,
                                           plain_ms=plain, library_ms=lib,
                                           bound=bound)

    k6_case("int8 [8,20,1500,64] pos=None", True, None, True)
    k6_case("f32 [8,20,1500,64] pos=700", False, 700, False)

    # ---- K9 and the int4 tools' kernels at the decode shapes (M = 8) --------
    from audax_torch.ops import int4_matmul as i4
    from audax_torch.tools import arm_times
    from audax_torch.tools import int4_layout_ab as lab
    from audax_torch.tools import int4_plane_probe as pp
    from audax_torch.tools import int4_unpack_probe as up
    from audax_torch.tools import w4a8_probe as wp

    def split_half(w):
        q, s = i4.quantize_int4(w)
        return (q, s), i4.dequantize_int4(q, s)

    def words(quantize):
        def pack(w):
            word, s = quantize(w)[:2]
            return (word, s), lab.dequantize_int4_v2(word, s)
        return pack

    def plane(fn):              # the group from the shapes: K / G
        return lambda x, word, s: fn(x, word, s,
                                     group=8 * word.shape[0] // s.shape[0])

    #: name -> (CUDA wrapper, plain version, packing, peak of the unit that
    #: does its products exactly: None = f32 CUDA cores for f32 x, bf16
    #: tensor cores for bf16 x; int8 tensor cores for W4A8)
    int4_kernels = {
        "int4_word_matmul": (lab.int4_matmul_v2_cuda,
                             lab.int4_matmul_v2_plain,
                             words(lab.quantize_int4_v2), None),
        "int4_plane_matmul": (plane(pp.plane_matmul_cuda),
                              plane(pp.plane_matmul_plain),
                              words(pp.quantize_int4_planes), None),
        "w4a8_matmul": (wp.w4a8_matmul_cuda, wp.w4a8_matmul_plain,
                        split_half, INT8_OPS),
        "int4_unpack_v1": (up.unpack_v1_cuda, up.unpack_v1_plain, split_half,
                           None),
        "int4_unpack_v2": (up.unpack_v2_cuda, up.unpack_v2_plain, split_half,
                           None),
    }

    def int4_bound(m, k_dim, n, dtype, weights, rate):
        nbytes = (torch.finfo(dtype).bits // 8) * m * (k_dim + n) + sum(
            t.numel() * t.element_size() for t in weights)
        return _bound(2 * m * k_dim * n, nbytes, rate)

    def int4_case(name, what, k_dim, n, dtype, tol, main, gen=None):
        """One int4 tool kernel against its plain version; its time with the
        weights from HBM -- copies cycled past twice the 50 MB L2, one per
        captured call, as a decode step's other weights evict them -- and
        warm in L2 (``tools.arm_times``); the yardstick ``torch.matmul`` on
        the dequantized weights in x's dtype, from HBM the same way."""
        cuda_fn, plain_fn, pack, rate = int4_kernels[name]
        m = 8
        weights, wd = pack(torch.randn(k_dim, n, device=dev, generator=gen)
                           / k_dim ** 0.5)
        x = torch.randn(m, k_dim, device=dev, generator=gen).to(dtype)
        got, ref = cuda_fn(x, *weights), plain_fn(x, *weights)
        e = err(got, ref)
        cold, warm = arm_times(cuda_fn, x, weights)
        plain = _time_ms(torch, lambda: plain_fn(x, *weights))
        lib, _ = arm_times(torch.matmul, x, (wd.to(dtype),))
        if rate is None:
            rate = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        bound = int4_bound(m, k_dim, n, dtype, weights, rate)
        dt = "f32" if dtype == torch.float32 else "bf16"
        _report(f"{name}[{what}{dt} [8,{k_dim}]x[{k_dim},{n}]] (max_abs_err "
                f"{e:.3e}; ms from HBM, L2-warm {1e3 * warm:.4f})",
                e / float(ref.float().abs().max()), tol, 1e3 * cold, plain,
                1e3 * lib, bound, "max_rel_err")
        if main:
            out[name] = dict(max_abs_err=e, ms=1e3 * cold, plain_ms=plain,
                             library_ms=1e3 * lib, bound=bound)

    def int4pack_mm(x, q, s):
        """``torch.ops.aten._weight_int4pack_mm`` on K9's codes, packed by
        ``_convert_weight_to_int4pack`` (contiguous bytes of [N, K/2],
        K-row 2j in the high nibble) with the scales rounded to bf16 and a
        zero point of 0: (code - 8) * scale, K9's function; the conversion
        is outside the timed call. Returns (the call, its packed operands,
        None), or (None, None, why) where the card's build does not take
        it (its kernel wants N % 8 == 0, which the tied logits are not)."""
        try:
            aten = torch.ops.aten
            codes = torch.cat([q & 0xF, q >> 4], 0).t().to(torch.int32)
            packed = aten._convert_weight_to_int4pack(
                (codes[:, 0::2] << 4 | codes[:, 1::2]).to(torch.uint8)
                .contiguous(), 8)
            group = 2 * q.shape[0] // s.shape[0]
            sz = torch.stack([s, torch.zeros_like(s)], -1).to(
                torch.bfloat16).contiguous()
            fn = lambda x, w, z: aten._weight_int4pack_mm(x, w, group, z)
            fn(x, packed, sz)
            torch.cuda.synchronize()
            return fn, (packed, sz), None
        except (RuntimeError, NotImplementedError, AttributeError) as exc:
            return None, None, f"{type(exc).__name__}: {str(exc)[:120]}"

    #: K9's bodies -> their wrappers (``BODIES`` names each one's counter)
    k9_wrappers = {"mma": i4.int4_matmul_mma_cuda,
                   "split_half": i4.int4_matmul_cuda}

    def k9_case(what, m, k_dim, n, dtype, tol, main=False, timed=False,
                layers=None, group=128, gen=None):
        """K9 through ``int4_matmul`` -- one launch of the body ``BODIES``
        gives the call and none of the other's -- against its plain version
        at [m, K] x [K, N] (a stacked layer view with ``layers``), called
        twice: the outputs must be the same bits. ``timed``: its time from
        HBM and L2-warm; the split-half body's at the same shape
        (``int4_matmul_cuda`` called directly), held against the plain
        version with the same tolerance; cuBLAS on the dequantized weights
        and, in bf16, ``_weight_int4pack_mm``."""
        shape = (k_dim, n) if layers is None else (layers, k_dim, n)
        q, s = i4.quantize_int4(torch.randn(*shape, device=dev, generator=gen)
                                / k_dim ** 0.5, group=group)
        group = 2 * q.shape[-2] // s.shape[-2]
        body = i4.int4_body(k_dim, group)
        layer = None if layers is None else layers // 2
        x = torch.randn(m, k_dim, device=dev, generator=gen).to(dtype)
        before = {b: fn.launches for b, fn in k9_wrappers.items()}
        got = i4.int4_matmul(x, q, s, layer=layer)
        again = i4.int4_matmul(x, q, s, layer=layer)
        runs = {b: fn.launches - before[b] for b, fn in k9_wrappers.items()}
        if runs != {b: 2 * (b == body) for b in k9_wrappers}:
            raise AssertionError(f"K9 {what}: launches {runs}, not two of "
                                 f"the {body} body alone")
        if not torch.equal(got, again):
            raise AssertionError(f"K9 {what}: two calls differ")
        ref = i4.int4_matmul_plain(x, q, s, layer=layer)
        ref_max = float(ref.float().abs().max())
        e = err(got, ref)
        rel = e / ref_max
        dt = "f32" if dtype == torch.float32 else "bf16"
        view = "" if layers is None else f" layer {layer} of {layers}"
        shape_text = (f"{what} {dt} [{m},{k_dim}]x[{k_dim},{n}]{view} "
                      f"group {group}")
        label = f"{i4.BODIES[body][0]}[{shape_text}]"
        if not timed:
            if not rel <= tol:
                raise AssertionError(f"{label}: max rel err {rel:.3e} > "
                                     f"{tol:.0e}")
            print(f"[kernels] {label}: max_rel_err {rel:.3e} (tol {tol:.0e}),"
                  f" max_abs_err {e:.3e}, bit-identical twice", flush=True)
            return
        weights = (q, s)
        cold, warm = arm_times(k9_wrappers[body], x, weights)
        old_e = err(i4.int4_matmul_cuda(x, q, s), ref)
        old_cold, old_warm = arm_times(i4.int4_matmul_cuda, x, weights)
        plain = _time_ms(torch, lambda: i4.int4_matmul_plain(x, q, s))
        lib, _ = arm_times(torch.matmul, x,
                           (i4.dequantize_int4(q, s).to(dtype),))
        pack_note = "bf16 only"
        if dtype == torch.bfloat16:
            fn, ops, why = int4pack_mm(x, q, s)
            pack_note = f"not available ({why})"
            if fn is not None:
                pk_e = err(fn(x, *ops), ref)
                pk_cold, pk_warm = arm_times(fn, x, ops)
                pack_note = (f"{1e3 * pk_cold:.4f}, L2-warm "
                             f"{1e3 * pk_warm:.4f} (max_rel_err "
                             f"{pk_e / ref_max:.3e}, scales in bf16)")
        parts = 3 if dtype == torch.float32 else 1
        bound = int4_bound(m, k_dim, n, dtype, weights, BF16_FLOPS / parts)
        old_bound = int4_bound(m, k_dim, n, dtype, weights,
                               F32_FLOPS if dtype == torch.float32
                               else BF16_FLOPS)
        _report(f"int4_matmul[{shape_text}] (split-half body, CUDA cores, "
                f"the A/B; max_abs_err {old_e:.3e}; ms from HBM, L2-warm "
                f"{1e3 * old_warm:.4f})", old_e / ref_max, tol,
                1e3 * old_cold, plain, 1e3 * lib, old_bound, "max_rel_err")
        _report(f"{label} (max_abs_err {e:.3e}, bit-identical twice; ms from "
                f"HBM, L2-warm {1e3 * warm:.4f}; _weight_int4pack_mm ms "
                f"{pack_note})", rel, tol, 1e3 * cold, plain, 1e3 * lib,
                bound, "max_rel_err")
        if main:
            out[i4.BODIES[body][0]] = dict(max_abs_err=e, ms=1e3 * cold,
                                           plain_ms=plain,
                                           library_ms=1e3 * lib, bound=bound)
            out["int4_matmul"] = dict(max_abs_err=old_e, ms=1e3 * old_cold,
                                      plain_ms=plain, library_ms=1e3 * lib,
                                      bound=old_bound)

    # K9 at the serving step's four shapes, M = 8 (24, 4, 4 and 1 launches a
    # step), both dtypes; then, on their own generator (the later phases
    # keep the inputs they drew before these cases existed), ragged N (odd;
    # 258 = 2 mod 16, as 51,866), M = 1, 16 and 256, groups 64 and 80 and a
    # stacked layer view; then, drawn after those, group 40 and K/2 = 8704
    # on the split-half body
    for k_dim, n, what in ((1280, 1280, "q/k/v/out"), (1280, 5120, "mlp_in"),
                           (5120, 1280, "mlp_out"),
                           (1280, 51866, "tied logits")):
        for dtype, tol in ((torch.float32, TOL_INT4_F32),
                           (torch.bfloat16, TOL_BF16)):
            k9_case(what, 8, k_dim, n, dtype, tol,
                    main=what == "tied logits" and dtype == torch.float32,
                    timed=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    for dtype, tol in ((torch.float32, TOL_INT4_F32),
                       (torch.bfloat16, TOL_BF16)):
        for m, n in ((8, 1287), (8, 258), (1, 7), (1, 1280), (16, 1280),
                     (16, 51866), (256, 1280), (256, 258)):
            k9_case("ragged" if n % 16 else "rows", m, 1280, n, dtype, tol,
                    gen=gen)
        k9_case("stacked", 8, 1280, 1280, dtype, tol, layers=4, gen=gen)
        k9_case("stacked ragged", 8, 1280, 1287, dtype, tol, layers=3,
                gen=gen)
        k9_case("group 64", 8, 1280, 258, dtype, tol, group=64, gen=gen)
        k9_case("group 80", 8, 640, 1280, dtype, tol, group=80, gen=gen)
    for dtype, tol in ((torch.float32, TOL_INT4_F32),
                       (torch.bfloat16, TOL_BF16)):
        k9_case("group 40", 8, 1280, 1287, dtype, tol, group=40, gen=gen)
        k9_case("K/2 8704", 8, 17408, 258, dtype, tol, gen=gen)
    # the tools' kernels at the tools' shapes, on their own generator (the
    # later phases keep the inputs they drew before these cases existed);
    # the main case is the tools' own: bf16 x at [8,1280]x[1280,5120]
    gen = torch.Generator(device=dev).manual_seed(5)
    tool_shapes = {"int4_word_matmul": ((1280, 5120), (5120, 1280),
                                        (1280, 1280))}
    for name in ("int4_word_matmul", "int4_plane_matmul", "w4a8_matmul",
                 "int4_unpack_v1", "int4_unpack_v2"):
        for k_dim, n in tool_shapes.get(name, ((1280, 5120),)):
            for dtype in (torch.float32, torch.bfloat16):
                tol = (TOL_BF16 if dtype == torch.bfloat16 else
                       TOL_W4A8_F32 if name == "w4a8_matmul" else
                       TOL_INT4_F32)
                int4_case(name, "", k_dim, n, dtype, tol,
                          (k_dim, n) == (1280, 5120)
                          and dtype == torch.bfloat16, gen)
    return out


def fold_cases(torch, gen):
    """P1 (``tools/attn_headfold_probe.py:fold_fwd``: K2's kernel folding 2
    or 4 heads per block) against its plain version at the tool's shape,
    bf16 [96, 1536, 64], and with a ragged key count (1500 of 1536 rows) in
    float32 and bf16; returns the summary of the fold-2 case at the tool's
    shape. The bound takes the bf16 tensor cores' peak for bf16 inputs;
    the label gives the float32 CUDA-core bound beside it (the cores the
    kernel runs on)."""
    import torch.nn.functional as F

    from audax_torch.tools import attn_headfold_probe as hf

    dev, bh, t, d = "cuda", 96, 1536, 64
    main = None
    for fold, dtype, kv_len in ((2, torch.bfloat16, t), (4, torch.bfloat16, t),
                                (2, torch.float32, 1500),
                                (2, torch.bfloat16, 1500)):
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        kw = dict(scale=d ** -0.5, kv_len=kv_len)
        o, lse = hf.fold_fwd_cuda(q, k, v, fold=fold, **kw)
        o_ref, lse_ref = hf.fold_fwd_plain(q, k, v, **kw)
        e = float((o.float() - o_ref.float()).abs().max())
        if dtype == torch.float32:
            e, tol = max(e, float((lse - lse_ref).abs().max())), TOL_F32
            rel = e
        else:       # bf16: against the plain output's largest value
            tol, rel = TOL_BF16, e / float(o_ref.float().abs().max())
        ms = _time_ms(torch, lambda: hf.fold_fwd_cuda(q, k, v, fold=fold,
                                                      **kw))
        plain = _time_ms(torch, lambda: hf.fold_fwd_plain(q, k, v, **kw),
                         reps=5)
        ks, vs = k[None, :, :kv_len], v[None, :, :kv_len]
        lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], ks, vs))
        flops = 4 * bh * t * kv_len * d
        nbytes = q.element_size() * d * 2 * bh * (t + kv_len) + 4 * bh * t
        rate = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        bound = _bound(flops, nbytes, rate)
        f32_core = _bound(flops, nbytes, F32_FLOPS)[0]
        dt = "f32" if dtype == torch.float32 else "bf16"
        _report(f"flash_forward_fold[fold {fold} {dt} [{bh},{t},{d}] kv_len "
                f"{kv_len}] (max_abs_err {e:.3e}; bound on f32 CUDA cores "
                f"{f32_core:.4f} ms)", rel, tol, ms, plain, lib, bound,
                "max_abs_err" if dtype == torch.float32 else "max_rel_err")
        if main is None:
            main = dict(max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib,
                        bound=bound)
    return main


def precision_check(torch):
    """A bf16 ``models/whisper.py:dense`` at Whisper-large-v3's MLP shape,
    x [8*1500, 5120] @ [5120, 1280], against the float64 product of the
    same bf16 operands: with float32 accumulation (``resolve_device``'s
    flags) every output lies within one bf16 step (ulp) of it, plus 1e-5
    of max |y| for the outputs near zero, where the float32 sum's own
    rounding (~1e-6) outweighs their step. The old flags (reduced-precision
    reduction allowed) are read beside it, not held."""
    from audax_torch.models.whisper import dense

    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(8 * 1500, 5120, device="cuda", generator=gen).bfloat16()
    w = torch.randn(5120, 1280, device="cuda", generator=gen) / 5120 ** 0.5
    ref = x.double() @ w.bfloat16().double()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    ulp += 1e-5 * ref.abs().max()
    flags = torch.backends.cuda.matmul
    readings = {}
    for label, reduced in (("float32 accumulation", False),
                           ("reduced-precision reduction", True)):
        flags.allow_bf16_reduced_precision_reduction = reduced
        try:
            y = dense({"kernel": w}, x).double()
        finally:
            flags.allow_bf16_reduced_precision_reduction = False
        readings[label] = (float(((y - ref).abs() / ulp).max()),
                           float((y - ref).abs().max() / ref.abs().max()))
    (ulps, rel), (ulps_old, rel_old) = readings.values()
    print(f"[precision] bf16 dense [12000,5120]x[5120,1280] vs float64: float32 "
          f"accumulation max {ulps:.3f} bf16 steps + 1e-5 max|y| ({rel:.3e} "
          f"of max|y|, tol 1); reduced-precision reduction {ulps_old:.3f} "
          f"({rel_old:.3e})", flush=True)
    if not ulps <= 1.0:
        raise AssertionError(f"bf16 dense off by {ulps} bf16 steps")


def _tokenizer(vocab_size=51865):
    """Whisper tokenizer with a published layout (51,865 tokens; 51,866 for
    large-v3, whose 100 languages add one): a BPE trained on a tiny corpus,
    padded with never-produced filler tokens to the published 50,257-token
    base."""
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
    return WhisperTokenizer.for_vocab_size(BPE(vocab, bpe.merges), vocab_size)


def _speechlike(rng, seconds, sr=16000, pitch=120.0, syllables=4.0):
    """Deterministic synthetic audio: gliding harmonic tones under a
    syllable-rate envelope, plus noise."""
    import numpy as np
    t = np.arange(int(seconds * sr)) / sr
    f0 = pitch + 40 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * syllables * t)) ** 2
    x = 0.2 * env * voiced + 0.01 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _no_core_flash(counts, path):
    """The flash kernels' float32 calls on a main path all take the 3xTF32
    bodies: the CUDA-core bodies (``FLASH``: K2, K7, K8) launched none."""
    ran = {k: counts[k]["cuda"] for k in FLASH if counts[k]["cuda"]}
    if ran:
        raise AssertionError(f"the {path} path launched the CUDA-core "
                             f"flash bodies: {ran}")


def _check_launches(counts, kernels, path):
    """Every kernel of ``kernels`` launched, no plain version ran, and no
    old K1 or K4 body (``OLD_MEL_BODIES``) unless ``kernels`` names it."""
    for name, c in counts.items():
        if (c["plain"] != 0 or (name in kernels and c["cuda"] <= 0)
                or (name in OLD_MEL_BODIES and name not in kernels
                    and c["cuda"])):
            raise AssertionError(f"{name}: kernel launches {c['cuda']}, plain "
                                 f"{c['plain']} on the {path} path")


def main_path_phase(torch, rng):
    import numpy as np

    from audax_torch.core.config import WhisperConfig
    from audax_torch.frontend.features import LogMelFrontend
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
    _check_launches(counts, TRANSCRIBE_KERNELS, "transcription")
    _no_core_flash(counts, "transcription")

    # ---- the card against the port's CPU path, float32 ------------------------
    audio = requests[0][1][None, : tr.chunk_samples]
    mel = tr.frontend(audio)
    mel_cpu = LogMelFrontend(tr.frontend.cfg, device="cpu",
                             whisper_frames=True)(audio)
    e_mel = float((mel.cpu() - mel_cpu).abs().max())
    print(f"[main] log-mel card (FFT body) vs CPU (K1's plain version): "
          f"max_abs_err {e_mel:.3e} (tol {TOL_MEL:.0e})", flush=True)
    if not e_mel <= TOL_MEL:
        raise AssertionError(f"log-mel differs by {e_mel:.3e}")
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
    if not all(np.isfinite(v) for v in (e_mel, e_enc, e_log)):
        raise AssertionError("non-finite comparison")
    return counts


def _transcripts(rng, tok, n, lo=30, hi=45):
    """``n`` texts of ``lo``..``hi`` tokens from the tokenizer's corpus."""
    words = ("the quick brown fox jumps over the lazy dog hello world how "
             "are you today speech recognition on a graphics card one two "
             "three four five six seven eight nine ten").split()
    texts = []
    while len(texts) < n:
        text, target = [], int(rng.integers(lo, hi + 1))
        while len(tok.encode(" ".join(text))) < target:
            text.append(str(rng.choice(words)))
        if lo <= len(tok.encode(" ".join(text))) <= hi:
            texts.append(" ".join(text))
    return texts


def _kernel_group(name):
    """The family of a CUDA kernel, from its name."""
    groups = (("K9 int4_matmul (mma body; split-half body)",
               ("int4mma", "split_half_kernel", "reduce_splits")),
              ("K3/K6 decode_attn", ("decode_attn",)),
              ("K7 flash_bwd_dq_sm90 (wgmma)", ("flash_bwd_dq_sm90",)),
              ("K8 flash_bwd_dkv_sm90 (wgmma)", ("flash_bwd_dkv_sm90",)),
              ("K7 flash_bwd_dq_tf32x3 (3xTF32)", ("flash_bwd_dq_tf32x3",)),
              ("K8 flash_bwd_dkv_tf32x3 (3xTF32)", ("flash_bwd_dkv_tf32x3",)),
              ("K7 flash_bwd_dq", ("flash_bwd_dq",)),
              ("K8 flash_bwd_dkv", ("flash_bwd_dkv",)),
              ("K2 flash_fwd_sm90 (wgmma)", ("flash_fwd_sm90",)),
              ("K2 flash_fwd_tf32x3 (3xTF32)", ("flash_fwd_tf32x3",)),
              ("K2 flash_fwd", ("flash_fwd",)),
              ("K4/K5 log_mel_direct", ("log_mel_direct",)),
              ("K1/K4/K5 log_mel_fft", ("log_mel_fft",)),
              ("K1 log_mel", ("log_mel",)),
              ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "splitK")),
              ("conv (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad")),
              ("optimizer foreach", ("multi_tensor_apply",)),
              ("reductions", ("reduce",)),
              ("elementwise", ("elementwise", "vectorized", "unrolled")),
              ("index/scatter", ("index", "scatter", "gather")))
    low = name.lower()
    for group, keys in groups:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _profile(torch, fn, label, n=3):
    """``n`` calls of ``fn`` under ``torch.profiler``: device time by kernel
    family and the ten longest kernels, and the device's busy share of the
    window (the kernels' summed time over the window's wall time, which the
    profiler's own host overhead lengthens, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        print(f"[profile] {label}: the profiler saw no device time; busy "
              "share not measured", flush=True)
        return
    groups = {}
    for e in kernels:
        g = groups.setdefault(_kernel_group(e.key), [0.0, 0])
        g[0] += e.self_device_time_total
        g[1] += e.count
    fams = ", ".join(f"{g} {t / n / 1e3:.2f} ms ({100 * t / total:.1f}%, "
                     f"{c // n} launches)"
                     for g, (t, c) in sorted(groups.items(),
                                             key=lambda kv: -kv[1][0]))
    print(f"[profile] {label}: device {total / n / 1e3:.2f} ms per call of "
          f"{wall_us / n / 1e3:.2f} ms wall (busy share >= "
          f"{total / wall_us:.3f}); by family: {fams}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:8.3f} ms "
              f"{e.count // n:5d}x  {e.key[:110]}", flush=True)


def finetune_phase(torch, rng, profile=False):
    """Whisper-base fine-tunes through ``finetune_whisper(device="cuda")``;
    returns the launch counts of both runs. ``profile`` adds a profiler
    window over each mode's step."""
    import os
    import tempfile

    import numpy as np

    from audax_torch.core.config import FineTuneConfig, MelConfig, WhisperConfig
    from audax_torch.data.audio_io import write_wav
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.train.finetune_loop import (build_speech_dataset,
                                                 finetune_whisper)
    from audax_torch.train.optim import GradientTransformation
    from audax_torch.train.seq2seq import (LABEL_PAD, FTState,
                                           collate_seq2seq, init_finetune,
                                           make_finetune_step)

    cfg = WhisperConfig.base()
    tok = _tokenizer()
    mel_cfg = MelConfig.whisper(cfg.n_mels)
    params = W.init_whisper_params(cfg, torch.Generator().manual_seed(1),
                                   device="cuda")
    n_params = sum(t.numel() for t in W.tree_leaves(params))
    with tempfile.TemporaryDirectory() as d:
        for i, text in enumerate(_transcripts(rng, tok, 8)):
            audio = _speechlike(rng, 30.0, pitch=100.0 + 15 * i,
                                syllables=3.0 + 0.5 * i)
            write_wav(os.path.join(d, f"clip{i}.wav"), audio, 16000)
            with open(os.path.join(d, f"clip{i}.txt"), "w") as fh:
                fh.write(text)
        examples = build_speech_dataset(d, tok, mel_cfg, chunk_seconds=30.0)
    lens = [len(ex["labels"]) for ex in examples]
    print(f"[finetune] Whisper-base (d_model {cfg.d_model}, "
          f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, {cfg.heads} "
          f"heads, vocab {cfg.vocab_size}, {n_params} parameters); "
          f"{len(examples)} clips of 30 s, label lengths {lens}", flush=True)
    if len(examples) != 8:
        raise AssertionError(f"dataset holds {len(examples)} examples, not 8")

    reset_launches()
    # ---- LoRA: rank 8 on attn/q and attn/v, one WER eval ----------------------
    snapshot = W.tree_map(lambda t: t.clone(), params)
    lora_ft = FineTuneConfig(lora_rank=8, batch_size=4, max_steps=10,
                             eval_every=10, learning_rate=1e-3,
                             warmup_steps=2)
    t0 = time.perf_counter()
    state, hist = finetune_whisper(params, cfg, tok, examples, lora_ft,
                                   eval_examples=examples[:1], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = max(float(ab["b"].detach().abs().max())
                for ab in state.trainable.values())
    same = all(torch.equal(a, b) for a, b in zip(
        W.tree_leaves(state.base_params), W.tree_leaves(snapshot)))
    print(f"[finetune] LoRA rank 8 ({len(state.trainable)} adapted kernels): "
          f"10 steps + eval in {wall:.2f} s, losses "
          f"{[round(x, 4) for x in hist['loss']]}, eval WER "
          f"{hist['wer'][0]['wer']:.3f}, base bit-unchanged {same}, max |B| "
          f"{moved:.3e}", flush=True)
    if not same or not moved > 0 or len(hist["wer"]) != 1:
        raise AssertionError("LoRA run: base changed, adapters still, or no "
                             "eval")
    del snapshot

    # ---- full-parameter: overfit four clips -----------------------------------
    ft = FineTuneConfig(batch_size=4, max_steps=20, moment_dtype="float32",
                        learning_rate=1e-3, warmup_steps=2)
    t0 = time.perf_counter()
    state, hist = finetune_whisper(params, cfg, tok, examples[:4], ft,
                                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = hist["loss"]
    print(f"[finetune] full-parameter, 4 clips x 20 steps in {wall:.2f} s "
          f"({20 / wall:.3f} steps/s with loop overhead), losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]):
        raise AssertionError(f"full fine-tune loss {losses[0]} -> "
                             f"{losses[-1]}: not below 0.7x")
    counts = launch_counts()
    print(f"[finetune] launches: {json.dumps(counts)}", flush=True)
    _check_launches(counts, FINETUNE_KERNELS, "fine-tune")
    _no_core_flash(counts, "float32 fine-tune")
    ran = {k: counts[k]["cuda"] for k in WGMMA if counts[k]["cuda"]}
    if ran:
        raise AssertionError(f"the float32 fine-tunes ran bf16 tensor-core "
                             f"bodies: {ran}")
    del state

    # ---- bf16 LoRA: K2, K7 and K8 on their tensor-core bodies ----------------
    reset_launches()
    bf16_ft = FineTuneConfig(lora_rank=8, batch_size=4, max_steps=5,
                             learning_rate=1e-3, warmup_steps=0,
                             dtype="bfloat16")
    t0 = time.perf_counter()
    state, hist = finetune_whisper(params, cfg, tok, examples[:4], bf16_ft,
                                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bf16_counts = launch_counts()
    losses = hist["loss"]
    print(f"[finetune] LoRA rank 8 in bf16, 4 clips x 5 steps in {wall:.2f} "
          f"s, losses {[round(x, 4) for x in losses]}, launches "
          f"{json.dumps({k: c['cuda'] for k, c in bf16_counts.items() if c['cuda']})}",
          flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 LoRA loss {losses[0]} -> {losses[-1]}: "
                             "not finite and falling")
    _check_launches(bf16_counts, ("log_mel_overlap_fft",) + WGMMA,
                    "bf16 fine-tune")
    ran = {k: bf16_counts[k]["cuda"] for k in FLASH if bf16_counts[k]["cuda"]}
    if ran:
        raise AssertionError(f"bf16 fine-tune calls ran on the CUDA-core "
                             f"bodies: {ran}")
    for k, c in bf16_counts.items():
        counts[k] = {"cuda": counts[k]["cuda"] + c["cuda"],
                     "plain": counts[k]["plain"] + c["plain"]}
    del state

    # ---- the step alone, both modes: time, rate, memory, launches ------------
    frontend = LogMelFrontend(mel_cfg, device="cuda", whisper_frames=True)
    audio = np.stack([ex["audio"] for ex in examples[:4]])
    coll = collate_seq2seq([ex["labels"] for ex in examples[:4]],
                           decoder_start_id=tok.sot)
    batch = {"mel": frontend(audio),
             **{k: torch.from_numpy(v).cuda() for k, v in coll.items()}}
    labels = int((coll["labels"] != LABEL_PAD).sum())
    tokens = 4 * cfg.n_audio_ctx + labels
    step = make_finetune_step(cfg, remat=True)
    for mode, mode_cfg in (("full-parameter", ft), ("LoRA rank 8", lora_ft)):
        state = init_finetune(params, mode_cfg)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        launches = {k: c["cuda"] / n for k, c in launch_counts().items()}
        print(f"[finetune] {mode} step (B=4, L={coll['labels'].shape[1]}, "
              f"remat, f32): {step_s * 1e3:.2f} ms, {1 / step_s:.3f} steps/s, "
              f"{tokens} tokens/step ({4 * cfg.n_audio_ctx} audio frames + "
              f"{labels} label tokens) = {tokens / step_s:.1f} tokens/s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches per step {json.dumps(launches)}", flush=True)
        if profile:
            _profile(torch, lambda: step(state, batch), f"{mode} step")
        del state

    # ---- one step's loss and gradients, card vs CPU (batch 1, f32) ------------
    def recording(trainable):
        seen = []

        def update(grads, st, p):
            seen.append(W.tree_map(lambda g: g.detach().cpu(), grads))
            return W.tree_map(torch.zeros_like, grads), st
        return FTState(step=0, base_params={}, trainable=W.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), trainable),
            opt_state=None, tx=GradientTransformation(lambda p: None,
                                                      update)), seen

    one = {k: v[:1] for k, v in batch.items()}
    step = make_finetune_step(cfg, remat=True)
    st, g_card = recording(params)
    _, m_card = step(st, one)
    cpu_params = W.tree_map(lambda t: t.cpu(), params)
    st, g_cpu = recording(cpu_params)
    _, m_cpu = step(st, {k: v.cpu() for k, v in one.items()})
    l_card, l_cpu = float(m_card["loss"]), float(m_cpu["loss"])
    worst, worst_name = 0.0, ""
    for name, a, b in zip(_paths(g_cpu[0]), W.tree_leaves(g_card[0]),
                          W.tree_leaves(g_cpu[0])):
        ratio = float((a - b).abs().max()) / (
            TOL_STEP_GRAD * float(b.abs().max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"[finetune] one step card vs CPU (B=1, f32): loss {l_card:.6f} vs "
          f"{l_cpu:.6f} (rel {rel:.2e}, tol {TOL_STEP_LOSS:.0e}); worst "
          f"gradient leaf {worst_name} at {worst:.3f} of its tolerance "
          f"({TOL_STEP_GRAD:.0e} x max|g_cpu| + 1e-6)", flush=True)
    if not (rel <= TOL_STEP_LOSS and worst <= 1.0):
        raise AssertionError("card and CPU fine-tune steps disagree")
    return counts


def _post_wav(port, body, timeout=600):
    """POST one WAV to the server; (status, parsed JSON body, seconds)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions", data=body,
        method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as exc:
        code, raw = exc.code, exc.read()
    return code, json.loads(raw), time.perf_counter() - t0


def serve_phase(torch, rng, profile=False):
    """Quantized continuous-batching serving at Whisper-large-v3-turbo
    width: int4 weights (quantized on the CPU, then moved to the card),
    int8 KV, 8 slots, behind ``serve_http``; twelve concurrent clients.
    ``profile`` adds a profiler window over one decode step of the eight
    slots. Returns (the serving launch counts, the K6 launch counts of
    ``attention(kv_cached=)``)."""
    import os
    import tempfile
    import threading

    import numpy as np

    from audax_torch.cli.http_server import serve_http
    from audax_torch.core.config import WhisperConfig
    from audax_torch.data.audio_io import write_wav
    from audax_torch.infer.continuous import ContinuousBatcher
    from audax_torch.models import whisper as W
    from audax_torch.models.quantize import quantize_tree, tree_bytes
    from audax_torch.ops import int4_matmul as i4
    from audax_torch.ops import launch_counts, reset_launches

    cfg = WhisperConfig.large_v3_turbo()
    tok = _tokenizer(cfg.vocab_size)
    t0 = time.perf_counter()
    params = W.init_whisper_params(cfg, torch.Generator().manual_seed(2),
                                   device="cpu")
    qcpu = quantize_tree(params, bits=4)         # identical codes on both
    float_bytes = tree_bytes(params)
    del params
    qparams = W.tree_map(lambda t: t.cuda(), qcpu)
    torch.cuda.synchronize()
    print(f"[serve] Whisper-large-v3-turbo (d_model {cfg.d_model}, "
          f"{cfg.encoder_layers}+{cfg.decoder_layers} layers, {cfg.heads} "
          f"heads, {cfg.n_mels} mels, vocab {cfg.vocab_size}): tree_bytes "
          f"float {float_bytes} -> int4 {tree_bytes(qcpu)} "
          f"({float_bytes / tree_bytes(qcpu):.2f}x); init + quantize on the "
          f"CPU + copy {time.perf_counter() - t0:.2f} s", flush=True)

    cb = ContinuousBatcher(qparams, cfg, tok, slots=8, kv_quant=True,
                           max_new_tokens=64, device="cuda")
    t0 = time.perf_counter()
    cb.warmup()
    torch.cuda.synchronize()
    print(f"[serve] ContinuousBatcher(slots=8, kv_quant=True, "
          f"max_new_tokens=64) warmup {time.perf_counter() - t0:.2f} s",
          flush=True)

    seconds = np.linspace(5.0, 30.0, 12)
    bodies = []
    with tempfile.TemporaryDirectory() as d:
        for i, sec in enumerate(seconds):
            path = os.path.join(d, f"req{i}.wav")
            write_wav(path, _speechlike(rng, float(sec), pitch=95.0 + 10 * i),
                      16000)
            with open(path, "rb") as fh:
                bodies.append(fh.read())
    server = serve_http(cb, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    results, errors = {}, []

    def client(i):
        try:
            results[i] = _post_wav(port, bodies[i])
        except OSError as exc:           # reported by the check below
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        dequant = i4.int4_matmul_dequant.launches
        peak = torch.cuda.max_memory_allocated()
        metrics = server.scheduler.metrics()
    finally:
        server.scheduler.shutdown()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if errors or any(t.is_alive() for t in threads) or len(results) != 12:
        raise AssertionError(f"clients failed: {errors}")
    lat, n_tok = [], 0
    for i, (code, body, sec) in sorted(results.items()):
        ok = (code == 200 and set(body) == {"text", "avg_logprob", "tokens",
                                            "audio_seconds"}
              and isinstance(body["text"], str)
              and np.isfinite(body["avg_logprob"])
              and abs(body["audio_seconds"] - seconds[i]) < 1e-3
              and all(0 <= t < cfg.vocab_size for t in body["tokens"]))
        if not ok:
            raise AssertionError(f"request {i}: {code} {body}")
        lat.append(sec)
        n_tok += len(body["tokens"])
    steps = counts["decode_attention_stacked_int8"]["cuda"] // (
        2 * cfg.decoder_layers)
    per_step = {k: round(c["cuda"] / max(steps, 1), 3)
                for k, c in counts.items() if c["cuda"]}
    print(f"[serve] 12 requests of 5-30 s over HTTP in {wall:.3f} s: "
          f"{12 / wall:.4f} requests/s; latency p50 "
          f"{float(np.percentile(lat, 50)):.3f} s, max {max(lat):.3f} s; "
          f"{steps} decode steps, {n_tok} generated tokens "
          f"({n_tok / wall:.2f} tokens/s, {steps / wall:.2f} steps/s); "
          f"launches per decode step {json.dumps(per_step)}; int4 "
          f"dequantize+matmul branch {dequant} calls (encoder and cross-K/V "
          f"at admit); peak memory {peak / 2**30:.3f} GiB; server metrics "
          f"{json.dumps(metrics)}", flush=True)
    print(f"[serve] launches: {json.dumps(counts)}", flush=True)
    _check_launches(counts, SERVE_KERNELS, "serving")
    _no_core_flash(counts, "serving")
    if counts["decode_attention_stacked"]["cuda"]:
        raise AssertionError("the float K3 arm ran on the int8-KV path")
    k9 = (counts["int4_matmul_mma"]["cuda"], counts["int4_matmul"]["cuda"])
    if k9 != (K9_PER_STEP * steps, 0):
        raise AssertionError(f"K9 launches (tensor-core, split-half body) "
                             f"{k9} over {steps} decode steps; want "
                             f"{K9_PER_STEP} a step on the tensor-core body")

    # ---- the card against the port's CPU path, teacher-forced ----------------
    b, n_steps, max_len = 4, 8, 16
    audio = np.stack([_speechlike(rng, 30.0, pitch=110.0 + 20 * i)
                      for i in range(b)])
    with torch.inference_mode():
        enc = W.encode(qparams, cfg, cb.frontend(audio))
        xkv = W.precompute_cross_kv(qparams, cfg, enc, quant=True)
    xkv_cpu = W.QuantKV(*(t.cpu() for t in xkv))
    toks = torch.from_numpy(rng.integers(0, 50257, size=(b, max_len)))
    start = torch.tensor([0, 1, 3, 6])

    def teacher_forced(p, dev, quant_self, cross):
        """[n_steps, b, vocab] logits of ragged steps at per-slot positions
        (slot i starts at step start[i]), on the CPU."""
        cache = W.init_kv_cache(cfg, b, max_len, device=dev, quant=quant_self)
        out = []
        for step in range(n_steps):
            pos = torch.clamp_min(step - start, 0)
            tok = toks[torch.arange(b), pos]
            lg, _ = W.decode_step_ragged(p, cfg, tok.to(dev), pos.to(dev),
                                         cache, cross)
            out.append(lg.cpu())
        return torch.stack(out)

    what = (f"int8 cross-KV, int4 weights, {n_steps} steps x {b} slots at "
            f"positions start {start.tolist()}")
    for quant_self, tol in ((False, TOL_LOGITS), (True, TOL_LOGITS_Q8)):
        lg = teacher_forced(qparams, "cuda", quant_self, xkv)
        lc = teacher_forced(qcpu, "cpu", quant_self, xkv_cpu)
        e_log = float((lg - lc).abs().max())
        agree = int((lg.argmax(-1) == lc.argmax(-1)).sum())
        kind = "int8" if quant_self else "float"
        print(f"[serve] teacher-forced decode_step_ragged card vs CPU, {kind} "
              f"self-KV, {what}: logits max_abs_err {e_log:.3e} (tol "
              f"{tol:.0e}), argmax agreement {agree}/{n_steps * b}",
              flush=True)
        if not (np.isfinite(e_log) and e_log <= tol):
            raise AssertionError(f"{kind} self-KV logits differ by {e_log}")

    # planted faults in the card's int8 self-KV writes, held against the int8
    # run's CPU logits ``lc``: the limit above must catch each of them
    exact = W.quantize_kv

    def v_scale_dropped(k, v):
        kq, ks, vq, vs = exact(k, v)
        return W.QuantKV(kq, ks, vq, torch.ones_like(vs))

    def truncated(k, v):
        def one(t):
            s = torch.clamp_min(t.float().abs().amax(-1) / 127.0, 1e-8)
            return torch.trunc(t.float() / s[..., None]).to(torch.int8), s
        return W.QuantKV(*one(k), *one(v))

    for label, fault in (("v_scale dropped", v_scale_dropped),
                         ("codes truncated, not rounded", truncated)):
        W.quantize_kv = fault
        try:
            lf = teacher_forced(qparams, "cuda", True, xkv)
        finally:
            W.quantize_kv = exact
        e_f = float((lf - lc).abs().max())
        print(f"[serve] planted fault in the card's int8 self-KV writes "
              f"({label}), {what}: logits max_abs_err {e_f:.3e} (must exceed "
              f"tol {TOL_LOGITS_Q8:.0e})", flush=True)
        if not e_f > TOL_LOGITS_Q8:
            raise AssertionError(f"the int8 self-KV limit misses a planted "
                                 f"fault ({label}): {e_f}")

    q8_margin(torch, qparams, qcpu, cfg, xkv, xkv_cpu)

    if profile:
        cache = W.init_kv_cache(cfg, 8, cb._max_len, device="cuda",
                                quant=True)
        with torch.inference_mode():
            mels = cb.frontend(np.stack([_speechlike(rng, 30.0)] * 8))
            xkv8 = W.precompute_cross_kv(
                qparams, cfg, W.encode(qparams, cfg, mels), quant=True)
        tok8 = torch.randint(0, 50257, (8,), device="cuda")
        pos8 = torch.arange(8, device="cuda") * 7
        _profile(torch, lambda: W.decode_step_ragged(qparams, cfg, tok8, pos8,
                                                     cache, xkv8),
                 "serving decode step (8 slots, int4, int8 KV)")
        del cache, xkv8

    # ---- K6's entry point: attention(kv_cached=) over one layer's cache ------
    layer = W.layer_params(qparams["decoder"]["layers"]["cross_attn"], 0)
    layer_cpu = W.layer_params(qcpu["decoder"]["layers"]["cross_attn"], 0)
    one = W.QuantKV(*(t[0] for t in xkv))
    h = torch.randn(b, 1, cfg.d_model, device="cuda")
    reset_launches()
    with torch.inference_mode():
        got = W.attention(layer, h, cfg.heads, kv_cached=one)
    k6_counts = launch_counts()
    ref = W.attention(layer_cpu, h.cpu(), cfg.heads,
                      kv_cached=W.QuantKV(*(t.cpu() for t in one)))
    e = float((got.cpu() - ref).abs().max())
    print(f"[serve] attention(kv_cached=QuantKV) [{b},1,{cfg.d_model}] over "
          f"[{b},{cfg.heads},{cfg.n_audio_ctx},64] card vs CPU: max_abs_err "
          f"{e:.3e} (tol {TOL_LOGITS:.0e}); K6 launches "
          f"{k6_counts['decode_attention']['cuda']}", flush=True)
    _check_launches(k6_counts, ("decode_attention",), "attention(kv_cached=)")
    if not e <= TOL_LOGITS:
        raise AssertionError(f"attention(kv_cached=) differs by {e}")
    return counts, k6_counts


def q8_margin(torch, qparams, qcpu, cfg, xkv, xkv_cpu, seeds=16):
    """The int8 self-KV reading over ``seeds`` inputs: per seed, one
    ``decode_step_ragged`` of 4 slots at random positions over a random int8
    cache (identical codes on both devices), card vs the port's CPU path.
    Prints the largest and the median logits difference beside
    ``TOL_LOGITS_Q8``, and what the step wrote: the new K/V codes (card vs
    CPU, each rounded from its own float32 projection) and their scales.
    Holds every reading below the limit, the codes within +-1 (a tie of
    the rounding) and the scales within 1e-3 relative: the K/V projections
    differ in float32 between the card's int4 kernel and the CPU's plain
    version (read 6.9e-6 absolute on scales of ~2e-2)."""
    import numpy as np

    from audax_torch.models import whisper as W

    b, max_len = 4, 16
    shape = (cfg.decoder_layers, b, cfg.heads, max_len,
             cfg.d_model // cfg.heads)
    logit_err, code_diff, scale_diff, scale_rel, flipped = [], 0, 0.0, 0.0, 0
    for seed in range(seeds):
        rng = np.random.default_rng(1000 + seed)
        kv = W.quantize_kv(*(torch.from_numpy(rng.standard_normal(shape)
                                              .astype(np.float32))
                             for _ in range(2)))
        tok = torch.from_numpy(rng.integers(0, 50257, size=b))
        pos = torch.from_numpy(rng.integers(1, max_len, size=b))
        caches, logits = [], []
        for p, dev, cross in ((qparams, "cuda", xkv), (qcpu, "cpu", xkv_cpu)):
            cache = W.QuantKV(*(t.clone().to(dev) for t in kv))
            lg, _ = W.decode_step_ragged(p, cfg, tok.to(dev), pos.to(dev),
                                         cache, cross)
            caches.append(W.QuantKV(*(t.cpu() for t in cache)))
            logits.append(lg.cpu())
        logit_err.append(float((logits[0] - logits[1]).abs().max()))
        for i in (0, 2):                        # codes k_q, v_q
            d = (caches[0][i].int() - caches[1][i].int()).abs()
            code_diff = max(code_diff, int(d.max()))
            flipped += int((d > 0).sum())
        for i in (1, 3):                        # scales
            d = (caches[0][i] - caches[1][i]).abs()
            scale_diff = max(scale_diff, float(d.max()))
            scale_rel = max(scale_rel, float((d / caches[1][i].abs()).max()))
    print(f"[serve] int8 self-KV over {seeds} seeds (one decode_step_ragged, "
          f"4 slots at random positions over a random int8 cache): logits "
          f"max_abs_err largest {max(logit_err):.3e}, median "
          f"{float(np.median(logit_err)):.3e} (limit {TOL_LOGITS_Q8:.0e}); "
          f"written codes card vs CPU differ by at most {code_diff} "
          f"({flipped} of {seeds * 2 * cfg.decoder_layers * b * cfg.heads * shape[-1]}"
          f" codes flipped), scales by at most {scale_diff:.3e} = "
          f"{scale_rel:.3e} relative (tol 1e-03); "
          f"readings {[float(f'{e:.3e}') for e in logit_err]}", flush=True)
    if not (code_diff <= 1 and scale_rel <= 1e-3
            and all(e <= TOL_LOGITS_Q8 for e in logit_err)):
        raise AssertionError(f"int8 self-KV over seeds: logits {logit_err}, "
                             f"codes by {code_diff}, scales by {scale_rel}")
    return logit_err


def _featurize(torch, us, name, kw, kernel):
    """The synthetic dataset through ``featurize_clips`` on the card in
    batches of 64; (x [N, T, n_mels], y, fold) on the host and the launch
    counts of the run."""
    import numpy as np

    from audax_torch.core.config import MelConfig
    from audax_torch.data.urbansound import featurize_clips
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.ops import launch_counts, reset_launches

    mel = MelConfig(**kw)
    frontend = LogMelFrontend(mel, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, rows = [], []
    for batch_rows, f in featurize_clips(us, mel, batch_size=64,
                                         frontend=frontend):
        if f is None:
            raise AssertionError(f"{batch_rows[0]['slice_file_name']} did "
                                 "not decode")
        feats.append(f.transpose(1, 2))           # [B, T, n_mels]
        rows.extend(batch_rows)
    x = torch.cat(feats).cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    direct = {"log_mel_overlap", "log_mel_overlap_fft", "log_mel_packed",
              "log_mel_packed_fft", "log_mel_generic", "log_mel_fft"}
    _check_launches(counts, (kernel,), f"featurize ({name})")
    others = {k: c["cuda"] for k, c in counts.items()
              if k in direct - {kernel} and c["cuda"]}
    if others or not np.isfinite(x).all():
        raise AssertionError(f"featurize ({name}): other tiers {others} or "
                             "non-finite features")
    print(f"[classify] featurize {name} (n_fft {mel.n_fft}, hop "
          f"{mel.hop_length}, {mel.n_mels} mels, power {mel.power}): "
          f"{len(rows)} clips -> {list(x.shape)} in {wall:.3f} s = "
          f"{len(rows) / wall:.1f} clips/s (WAV read, int16 upload, "
          f"{kernel} {counts[kernel]['cuda']} launches)", flush=True)
    y = np.array([r["class_id"] for r in rows], np.int64)
    fold = np.array([r["fold"] for r in rows])
    return (x, y, fold), counts


def _check_card_vs_cpu(torch, label, build, x, y):
    """One model built twice from the same draws (dropout 0): eval logits
    on 8 clips, then one ``train_step``'s loss and BatchNorm running
    statistics in float32, and its gradients in float64, card vs the port's
    CPU path.

    The gradient is discontinuous where a ReLU input sits at 0 or two
    max-pooled values tie: in float32 the card and the CPU, rounding
    differently, can take different branches at a few of the model's
    ~1.8 M such points, and each moves a reduction of ~1,000 terms by about
    one term (a few 1e-3 of a gradient's largest value). In float64 both
    take the same branches, so the gradients are held there."""
    import copy

    from audax_torch.train.optim import GradientTransformation
    from audax_torch.train.steps import TrainState, make_classifier_steps

    torch.manual_seed(1)
    cpu = build(0.0)
    card = copy.deepcopy(cpu).cuda()
    cpu64 = copy.deepcopy(cpu).double()
    card64 = copy.deepcopy(cpu64).cuda()
    with torch.no_grad():
        lc = cpu(torch.from_numpy(x[:8]))
        lg = card(torch.from_numpy(x[:8]).cuda()).cpu()
    e_log = float((lg - lc).abs().max()) / float(lc.abs().max())

    def step(model, batch, device):
        """One train step whose update is zero; returns (metrics, grads)."""
        seen = {}

        def update(grads, st, p):
            seen.update({k: g.detach().cpu() for k, g in grads.items()})
            return {k: torch.zeros_like(g) for k, g in grads.items()}, st
        st = TrainState.create(model, GradientTransformation(
            lambda p: None, update))
        _, metrics = make_classifier_steps(model)[0](
            st, {k: v.to(device) for k, v in batch.items()})
        return metrics, seen

    batch = {"x": torch.from_numpy(x[:16]), "y": torch.from_numpy(y[:16])}
    m_card, _ = step(card, batch, "cuda")
    m_cpu, _ = step(cpu, batch, "cpu")
    batch64 = dict(batch, x=batch["x"].double())
    _, g_card = step(card64, batch64, "cuda")
    _, g_cpu = step(cpu64, batch64, "cpu")
    l_cpu, l_card = float(m_cpu["loss"]), float(m_card["loss"])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name = 0.0, ""
    for name, g in g_cpu.items():
        ratio = float((g_card[name] - g).abs().max()) / (
            TOL_STEP_GRAD * float(g.abs().max()) + 1e-6)
        if ratio >= worst:
            worst, worst_name = ratio, name
    e_bn = 0.0
    for name, b in dict(cpu.named_buffers()).items():
        a = dict(card.named_buffers())[name].cpu()
        e_bn = max(e_bn, float((a - b).abs().max())
                   / max(1.0, float(b.abs().max())))
    print(f"[classify] {label} card vs CPU (dropout 0): eval logits on 8 "
          f"clips (f32) {e_log:.3e} of max|logit| (tol {TOL_CLS_LOGITS:.0e});"
          f" one step (B=16, f32) loss {l_card:.6f} vs {l_cpu:.6f} (rel "
          f"{rel:.2e}, tol {TOL_STEP_LOSS:.0e}); BatchNorm running "
          f"statistics {e_bn:.3e} (tol {TOL_BN_STATS:.0e}); the step's "
          f"gradients (f64): worst leaf {worst_name} at {worst:.3e} of its "
          f"tolerance ({TOL_STEP_GRAD:.0e} x max|g_cpu| + 1e-6)", flush=True)
    if not (e_log <= TOL_CLS_LOGITS and rel <= TOL_STEP_LOSS and worst <= 1.0
            and e_bn <= TOL_BN_STATS):
        raise AssertionError(f"{label}: card and CPU disagree")
    return card, batch


def classify_phase(torch, profile=False):
    """The UrbanSound fold protocol on the synthetic stand-in dataset: 400
    clips featurized on the card under one frontend config per log-mel
    tier (K1, K4, K5), then three classifiers at the reference widths
    trained 3 epochs on folds 1-8 and evaluated on folds 9 and 10. Returns
    the featurize runs' launch counts, summed. ``profile`` adds a profiler
    window over each classifier's train step."""
    import os
    import tempfile

    import numpy as np

    from audax_torch.core.config import (ClassifierTrainConfig,
                                         CNNClassifierConfig,
                                         TransformerClassifierConfig,
                                         UrbanSoundConfig)
    from audax_torch.data.synth import make_synthetic_urbansound
    from audax_torch.models.classifiers import (CNNClassifier,
                                                TransformerClassifier)
    from audax_torch.train.loops import evaluate_classifier, fit_classifier
    from audax_torch.train.metrics_sink import MetricsSink
    from audax_torch.train.optim import adamw
    from audax_torch.train.steps import TrainState, make_classifier_steps

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        make_synthetic_urbansound(d, per_fold=40, seed=0)
        print(f"[classify] synthetic UrbanSound8K layout: 400 clips of 4 s "
              f"(40 per fold, 16-bit WAV) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        us = UrbanSoundConfig(dataset_root=d)
        feats, counts = {}, None
        for name, kw, kernel in CLASSIFY_FRONTENDS:
            feats[name], c = _featurize(torch, us, name, kw, kernel)
            counts = c if counts is None else {
                k: {s: counts[k][s] + c[k][s] for s in c[k]} for k in c}

        cfg = ClassifierTrainConfig(epochs=3)
        # the reference widths and dropouts (the CLI's max_len 2048 for
        # the CLS transformer); ``build(rate)`` draws from torch's generator
        cnn, tf = CNNClassifierConfig(), TransformerClassifierConfig()
        models = (
            ("CNNClassifier", "cnn", "UrbanSound v2", cnn.dropout,
             lambda rate: CNNClassifier(CNNClassifierConfig(dropout=rate),
                                        n_mels=128)),
            ("TransformerClassifier(cls, max_len 2048)", "transformer_cls",
             "PANNs geometry", tf.dropout, lambda rate: TransformerClassifier(
                 TransformerClassifierConfig(pool="cls", dropout=rate),
                 max_len=2048, n_mels=64)),
            ("TransformerClassifier(mean)", "transformer_mean",
             "magnitude v2", tf.dropout,
             lambda rate: TransformerClassifier(TransformerClassifierConfig(
                 pool="mean", dropout=rate), n_mels=128)),
        )
        for label, run, feat_name, dropout, build in models:
            x, y, fold = feats[feat_name]

            def split(folds):
                keep = np.isin(fold, folds)
                return {"x": x[keep], "y": y[keep]}
            train = split(us.train_folds)
            torch.manual_seed(0)
            model = build(dropout)
            n_params = sum(p.numel() for p in model.parameters())
            sink = MetricsSink(run, out_dir=os.path.join(d, "runs"))
            t0 = time.perf_counter()
            state, hist = fit_classifier(model, train, split([us.eval_fold]),
                                         cfg, sink=sink, device="cuda")
            wall = time.perf_counter() - t0
            sink.close()
            with open(sink.path) as fh:
                rate = [json.loads(line)["examples_per_s"] for line in fh
                        if "examples_per_s" in line]
            _, eval_step = make_classifier_steps(model)
            m10, _ = evaluate_classifier(eval_step, state,
                                         split([us.test_fold]),
                                         cfg.batch_size, 10)
            m9, losses = hist["eval"][-1], hist["train_loss"]
            print(f"[classify] {label} on {feat_name} features "
                  f"{list(x.shape[1:])} ({n_params} parameters): 3 epochs "
                  f"on folds 1-8 ({len(train['y'])} clips, batch "
                  f"{cfg.batch_size}, lr {cfg.learning_rate}, wd "
                  f"{cfg.weight_decay}) in {wall:.2f} s; train loss "
                  f"{[round(v, 4) for v in losses]}; examples/s per epoch "
                  f"{[round(v, 1) for v in rate]}; fold 9 accuracy "
                  f"{m9['accuracy']:.4f} f1_macro {m9['f1_macro']:.4f}; "
                  f"fold 10 accuracy {m10['accuracy']:.4f} f1_macro "
                  f"{m10['f1_macro']:.4f}", flush=True)
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise AssertionError(f"{label}: train loss {losses[0]} -> "
                                     f"{losses[-1]} did not fall")

            card, batch = _check_card_vs_cpu(torch, label, build, x, y)
            # the step alone on the card: batch 16, AdamW, dropout 0
            step, _ = make_classifier_steps(card)
            st = TrainState.create(card, adamw(cfg.learning_rate,
                                               cfg.weight_decay))
            batch = {k: v.cuda() for k, v in batch.items()}
            st, _ = step(st, batch)
            torch.cuda.synchronize()
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                st, _ = step(st, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / n * 1e3
            print(f"[classify] {label} train step (B=16, AdamW, f32): "
                  f"{step_ms:.3f} ms = {16e3 / step_ms:.1f} examples/s",
                  flush=True)
            if profile:
                _profile(torch, lambda: step(st, batch),
                         f"{label} train step")
    return counts


def probes_phase(torch):
    """The four int4 tools of ``audax_torch.tools`` on the card, each
    through its own entry point (``int4_layout_ab``: ``check`` then
    ``bench``): one JSON line per tool with its rows and verdict. Each
    tool's kernels must launch and no plain version may. Returns the launch
    counts of the tools' kernels, summed over the four."""
    import importlib

    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.tools import probe_launch_counts, reset_probe_launches

    total = {}
    for name, kernels in PROBE_TOOLS:
        tool = importlib.import_module(f"audax_torch.tools.{name}")
        runs = ((tool.check, tool.bench) if name == "int4_layout_ab"
                else (tool.main,))
        reset_launches()
        reset_probe_launches()
        t0 = time.perf_counter()
        reports = [run(device="cuda") for run in runs]
        wall = time.perf_counter() - t0
        counts = {**launch_counts(), **probe_launch_counts()}
        _check_launches(counts, kernels, f"{name} tool")
        print(json.dumps({
            "probe": name, "seconds": round(wall, 3),
            "verdicts": [r["verdict"] for r in reports],
            "launches": {k: c["cuda"] for k, c in counts.items()
                         if c["cuda"]},
            "reports": reports}), flush=True)
        for k, c in probe_launch_counts().items():
            total[k] = total.get(k, 0) + c["cuda"]
    return total


def attention_tools_phase(torch):
    """The four attention tools of ``audax_torch.tools`` on the card through
    their entry points (``train_step_breakdown`` once per ``--attn`` arm):
    one JSON line per run with its rows, verdict, seconds and launches. The
    kernels each run drives must launch, the CUDA-core K2/K7/K8 none in the
    step and MFU runs, none in the xla arm, and no plain version anywhere.
    Returns the launch counts of the runs, summed."""
    import importlib

    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.tools import probe_launch_counts, reset_probe_launches

    total = {}
    for label, name, kwargs, kernels, absent in ATTENTION_TOOLS:
        tool = importlib.import_module(f"audax_torch.tools.{name}")
        reset_launches()
        reset_probe_launches()
        t0 = time.perf_counter()
        rep = tool.main(device="cuda", **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**launch_counts(), **probe_launch_counts()}
        _check_launches(counts, kernels, f"{label} tool")
        ran = {k for k in absent if counts[k]["cuda"]}
        if ran:
            raise AssertionError(f"{label}: {sorted(ran)} launched")
        rows = rep.get("rows", rep.get("configs"))
        if not rows or any("error" in r for r in rows):
            raise AssertionError(f"{label}: no rows, or rows with errors")
        print(json.dumps({
            "attention_tool": label, "seconds": round(wall, 3),
            "verdict": rep["verdict"],
            "launches": {k: c["cuda"] for k, c in counts.items()
                         if c["cuda"]},
            "report": rep}), flush=True)
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c["cuda"]
        torch.cuda.empty_cache()
    return total


def _paths(tree, prefix=""):
    """Leaf paths of a nested dict, in ``tree_leaves`` order."""
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.extend(_paths(v, p) if isinstance(v, dict) else [p])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler window over each "
                             "fine-tune step, one serving decode step and "
                             "each classifier's train step: device time by "
                             "kernel family and the device's busy share")
    args = parser.parse_args()
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
    spills = sorted({line.strip() for text in reports.values()
                     for line in text.splitlines()
                     if "spill" in line and not line.strip().startswith("0")
                     and " 0 bytes spill stores, 0 bytes spill loads" not in line})
    nvcc_s = [text.splitlines()[0] for text in reports.values()]
    print(f"[build] {len(native.KERNEL_SOURCES)} kernel libraries "
          f"({len(reports)} compiled now) in {time.perf_counter() - t0:.2f} s "
          f"({'; '.join(nvcc_s)}); ptxas: {' | '.join(regs)}; spills: "
          f"{' | '.join(spills) or 'none'}", flush=True)

    cuobjdump = str(Path(native.nvcc_path()).parent / "cuobjdump")
    for name in TENSOR_CORE_LIBS:
        sass = _run([cuobjdump, "--dump-sass", str(native.lib_path(name))])
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        print(f"[build] {name} SASS: {hgmma} HGMMA instructions", flush=True)
        if hgmma == 0:
            raise AssertionError(f"the tensor-core body {name} holds no "
                                 "HGMMA")
    # registers of each tensor-core instantiation (D, BQ, BK); the
    # backward's accumulators must stay in registers: a spill in either of
    # its libraries fails (ptxas reports only what this call compiled)
    for name in TENSOR_CORE_LIBS:
        if name not in reports:
            print(f"[build] {name} was built before: its registers and "
                  "spills are not reported", flush=True)
            continue
        kernels = _ptxas_kernels(reports[name])
        print(f"[build] {name} ptxas (D,BQ,BK: registers, spill bytes): "
              + "; ".join(f"{a}: {r}, {sp}" for a, r, sp in kernels),
              flush=True)
        spilled = [k for k in kernels if k[2]]
        if name != TENSOR_CORE_LIBS[0] and (spilled or not kernels):
            raise AssertionError(f"{name} spills (or reports no kernel): "
                                 f"{spilled}")

    # the float32 bodies on the tensor cores (K2, K7, K8): TF32 HMMA
    # (mma.sync) in each SASS, and every instantiation's registers without
    # a spill (K2's by (D, BK), K7's by (D, BK), K8's by (D, BQ))
    for tf32 in TF32X3_LIBS:
        sass = _run([cuobjdump, "--dump-sass", str(native.lib_path(tf32))])
        hmma = sum("HMMA" in line and "TF32" in line
                   for line in sass.splitlines())
        print(f"[build] {tf32} SASS: {hmma} TF32 HMMA instructions",
              flush=True)
        if hmma == 0:
            raise AssertionError(f"the 3xTF32 body {tf32} holds no TF32 "
                                 "HMMA")
        if tf32 not in reports:
            print(f"[build] {tf32} was built before: its registers and "
                  "spills are not reported", flush=True)
            continue
        kernels = _ptxas_kernels(reports[tf32])
        print(f"[build] {tf32} ptxas (template arguments: registers, spill "
              "bytes): " + "; ".join(f"{a}: {r}, {sp}" for a, r, sp in kernels),
              flush=True)
        if not kernels or any(sp for _, _, sp in kernels):
            raise AssertionError(f"{tf32} spills (or reports no kernel): "
                                 f"{kernels}")

    # the FFT log-mel body's instantiations by n_fft, Whisper's 400-point
    # mixed radix among them: registers and spills (a spill fails)
    if "log_mel_fft" in reports:
        kernels = _ptxas_kernels(reports["log_mel_fft"])
        print("[build] log_mel_fft ptxas (n_fft: registers, spill bytes): "
              + "; ".join(f"{a}: {r}, {sp}" for a, r, sp in kernels),
              flush=True)
        if any(sp for _, _, sp in kernels) or "400" not in {
                a for a, _, _ in kernels}:
            raise AssertionError(f"log_mel_fft spills or lacks n_fft 400: "
                                 f"{kernels}")
    else:
        print("[build] log_mel_fft was built before: its registers and "
              "spills are not reported", flush=True)

    rng = np.random.default_rng(0)
    kern = kernel_phase(torch, rng)
    precision_check(torch)
    transcribe = main_path_phase(torch, rng)
    train = finetune_phase(torch, rng, profile=args.profile)
    serve, k6 = serve_phase(torch, rng, profile=args.profile)
    classify = classify_phase(torch, profile=args.profile)
    probes = probes_phase(torch)
    tools = attention_tools_phase(torch)
    # launches of the main paths, each counted from 0 just before it; the
    # tools' kernels from the probes phase; K2/K7/K8 and P1 from the
    # attention tools as well
    launches = {k: sum(p[k]["cuda"] for p in (transcribe, train, serve, k6,
                                              classify))
                for k in transcribe}
    launches.update(probes)
    for k in FLASH_BF16 + ("flash_forward_fold",):
        launches[k] = launches.get(k, 0) + tools[k]

    sources = {"log_mel_overlap": ("audax_torch/csrc/log_mel_overlap.cu",
                                   "audax/ops/pallas_mel.py:199"),
               "log_mel_overlap_fft": ("audax_torch/csrc/log_mel_fft.cu",
                                       "audax/ops/pallas_mel.py:199"),
               "log_mel_packed": ("audax_torch/csrc/log_mel_direct.cu",
                                  "audax/ops/pallas_mel.py:271"),
               "log_mel_packed_fft": ("audax_torch/csrc/log_mel_fft.cu",
                                      "audax/ops/pallas_mel.py:271"),
               "log_mel_generic": ("audax_torch/csrc/log_mel_direct.cu",
                                   "audax/ops/pallas_mel.py:334"),
               "log_mel_fft": ("audax_torch/csrc/log_mel_fft.cu",
                               "audax/ops/pallas_mel.py:334"),
               "flash_forward": ("audax_torch/csrc/flash_fwd.cu",
                                 "audax/ops/attention.py:161"),
               "flash_forward_wgmma": ("audax_torch/csrc/flash_fwd_sm90.cu",
                                       "audax/ops/attention.py:161"),
               "flash_forward_tf32x3": (
                   "audax_torch/csrc/flash_fwd_tf32x3.cu",
                   "audax/ops/attention.py:161"),
               "flash_forward_fold": ("audax_torch/csrc/flash_fwd.cu",
                                      "tools/attn_headfold_probe.py:90"),
               "flash_backward_dq": ("audax_torch/csrc/flash_bwd.cu",
                                     "audax/ops/attention.py:293"),
               "flash_backward_dkv": ("audax_torch/csrc/flash_bwd.cu",
                                      "audax/ops/attention.py:329"),
               "flash_backward_dq_wgmma": (
                   "audax_torch/csrc/flash_bwd_sm90.cu",
                   "audax/ops/attention.py:293"),
               "flash_backward_dkv_wgmma": (
                   "audax_torch/csrc/flash_bwd_sm90.cu",
                   "audax/ops/attention.py:329"),
               "flash_backward_dq_tf32x3": (
                   "audax_torch/csrc/flash_bwd_tf32x3.cu",
                   "audax/ops/attention.py:293"),
               "flash_backward_dkv_tf32x3": (
                   "audax_torch/csrc/flash_bwd_tf32x3.cu",
                   "audax/ops/attention.py:329"),
               "decode_attention_stacked": (
                   "audax_torch/csrc/decode_attention.cu",
                   "audax/ops/attention.py:680"),
               "decode_attention_stacked_int8": (
                   "audax_torch/csrc/decode_attention.cu",
                   "audax/ops/attention.py:680"),
               "decode_attention": ("audax_torch/csrc/decode_attention.cu",
                                    "audax/ops/attention.py:547"),
               "int4_matmul": ("audax_torch/csrc/int4_matmul.cu",
                               "audax/ops/int4_matmul.py:236"),
               "int4_matmul_mma": ("audax_torch/csrc/int4_matmul_mma.cu",
                                   "audax/ops/int4_matmul.py:236"),
               "int4_word_matmul": ("audax_torch/csrc/int4_word_matmul.cu",
                                    "tools/int4_layout_ab.py:107"),
               "int4_plane_matmul": ("audax_torch/csrc/int4_word_matmul.cu",
                                     "tools/int4_plane_probe.py:114"),
               "w4a8_matmul": ("audax_torch/csrc/w4a8_matmul.cu",
                               "tools/w4a8_probe.py:66"),
               "int4_unpack_v1": ("audax_torch/csrc/int4_unpack_variants.cu",
                                  "tools/int4_unpack_probe.py:105"),
               "int4_unpack_v2": ("audax_torch/csrc/int4_unpack_variants.cu",
                                  "tools/int4_unpack_probe.py:105")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
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
