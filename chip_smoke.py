#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``audax_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--profile]

``--profile`` adds a ``torch.profiler`` window over each fine-tune step,
one serving decode step and each classifier's train step (device time by
kernel family, the device's busy share). It builds the
port's CUDA kernels from ``audax_torch/csrc`` and drives the port's four
main paths -- Whisper transcription at the full width of Whisper-tiny,
the rest of Whisper decoding (beam search, best-of, speculative decoding,
word timestamps in the seek loop, language detection, streaming over
WebSocket) at the full widths of Whisper-small and Whisper-tiny,
Whisper fine-tuning at the full width of Whisper-base, quantized
continuous-batching serving over HTTP at the full width of
Whisper-large-v3-turbo, UrbanSound classification at the reference
classifiers' widths, and the music two-tower's serving path (``infer-
music``) at Qwen3-0.6B + Whisper-base width -- the four int4
kernel-experiment tools and the four attention tools, then the music
training path (``fit_two_tower`` and ``train-lm`` at Qwen3-0.6B width) and
the mixture-of-experts paths of the causal LM at Qwen3-30B-A3B's widths
(the two-tower served with an int4 MoE decoder, ``fit_lm`` with the aux
loss, the MoE decode probe), the Whisper and classifier commands of the
command line (weight I/O at Whisper-large-v3-turbo width), and last the
five bench commands with the browser demo and the host C++ (the SF2
synth), and the parallelism of the port over ``torch.distributed``
(``parallel_phase``), in twenty-two phases,
one output line each (the kernel and path phases print one line per
case):

  1. device  -- nvidia-smi's name and power limit, torch/CUDA/nvcc versions;
  2. build   -- nvcc of every kernel library (twenty-three), in parallel, with
     the wall time of each and of all, the registers and any spills; then
     the count of HGMMA (wgmma) instructions in the SASS of the three bf16
     tensor-core libraries, K2's and K7's and K8's (``cuobjdump
     --dump-sass``), none of which may be 0, and a spill in K7's or K8's
     fails; the count of TF32 HMMA (mma.sync) instructions in the SASS of
     the three float32 tensor-core libraries, K2's, K7's and K8's
     (``flash_fwd_tf32x3``, ``flash_bwd_dq_tf32x3``,
     ``flash_bwd_dkv_tf32x3``), none of which may be 0, and their registers
     by instantiation, where a spill fails; the
     registers and spills of P1's folded instantiations (fold 2 and 4 of
     K2's two tensor-core bodies), of each n_fft the FFT log-mel body is built for (Whisper's
     400-point mixed radix among them) and of each instantiation of K3's
     and K6's sm90 body, where a spill fails; the registers and spills of
     each instantiation of ``csrc/int4_matmul_mma.cu``'s five libraries
     (K9, P5 v1, P5 v2, P4, the word kernel of P2 and P3; reported);
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
     and stacked layer views. The tools' P4 and P5 v2 run on their
     tensor-core bodies on K9's skeleton (``csrc/int4_matmul_mma.cu``: v2
     on bf16 ``mma.sync`` and in 3xTF32, W4A8 on the int8 tensor cores with
     its activation quantization inside) through the tools' entry points
     (``w4a8_matmul``, ``run_variant("v2")``), each call launching the
     body its table gives once and no other, twice for the same bits: at
     the tools' shape in both dtypes, timed beside their first bodies
     (called directly, the A/B) and cuBLAS, then at N 1287 and M = 9; at
     group 40 the tables send both to their first bodies (``__dp4a``, and
     v2's 64-column body). P5 v1 (K9 with a mask-and-magic unpack) and the
     word kernel (P2, and P3 at its group 128 that straddles planes) run on
     their tensor-core bodies on the same skeleton through the tools' entry
     points (``run_variant("v1")``, ``int4_matmul_v2``, ``plane_matmul``)
     in the same way: timed at the tools' shapes (P2 at its three) in both
     dtypes beside their first bodies (called directly) and cuBLAS, then at
     N 1287 and M = 9; off the tables (group 40; P3 at K/8 = 168) on their
     first bodies. K3, its int8 arm and K6 run on their sm90
     body (``csrc/decode_attention_sm90.cu``, the keys split over a thread
     block cluster) at the transcription and serving shapes, each call made
     twice (the same bits), slope-timed in CUDA graphs beside the first
     body (``body="cuda_core"``, ``csrc/decode_attention.cu``) and SDPA,
     then held at S 1 with pos 0, Tq 16 and 40 (chunks of 16), head dims
     16, 32 and 128, GQA, bf16 q, per-slot positions at 0 and S - 1, and a
     chunk copied in tiles; the music LM's decode step (28 stacked layers,
     GQA 16q/8kv at head dim 128, S 256) at a host-int position and at
     per-slot positions with 0 and S - 1 among them, timed too. It also holds every caller-set tile of K2, K7
     and K8 at
     [4, 8, 1500, 64] float32, and P1 -- K2 folding 2 or 4 heads per block,
     ``tools/attn_headfold_probe.py:fold_fwd``, on the tensor-core body of
     its dtype (wgmma in bf16, 3xTF32 in float32) -- at the tool's bf16
     [96, 1536, 64] and with a ragged key count (1500 of 1536 rows) in
     float32 (folds 2 and 4) and bf16, slope-timed in CUDA graphs beside
     the CUDA-core fold and SDPA. K2's
     float32 body on the tensor cores (``csrc/flash_fwd_tf32x3.cu``,
     3xTF32) is held, o and lse, within the float32 tolerance at Whisper-
     base's [4, 6, 1500, 64] and [4, 8, 1500, 64], its cross and causal
     decoder sites, causal GQA, a ragged key count, head dims 16/32/128 and
     the serving encoder's [8, 20, 1500, 64], the music path's sites at
     head dim 128 (the adapter's cross-attention q 64 x kv 500, the LM's
     causal GQA 16q/8kv at 64 and 256 tokens) and its Whisper-base encoder
     over 10 s windows [4, 8, 500, 64], and timed beside the
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
  3a. K9's device index -- K9 at the MoE decode path's two expert shapes
     (x [1, 2048] @ int4 [1024, 768], x [1, 768] @ int4 [384, 2048], group
     128), float32 and bf16, its slice of a [256, K/2, N] stack named by a
     one-element index tensor on the card that the kernel reads itself
     (``csrc/int4_select.cuh``): one launch of the tensor-core body a call,
     against the plain version (``index_select``), bit-equal to the
     host-int route on the same slice, another index giving another
     result, the split-half body with the same device index against the
     plain version too; timed in CUDA graphs from HBM (128 slices cycled)
     and L2-warm beside the plain version and cuBLAS on the dequantized
     slice;
  3b. K9's trap -- a child process (``sys.executable``) launches K9 with a
     device index equal to the stack length, once on each body (the
     tensor-core one through ``int4_matmul``, the split-half one through
     its wrapper): each child must exit non-zero with a CUDA error in its
     stderr (the trap ends its CUDA context); then one in-range call here
     against the plain version;
  3c. precision -- a bf16 ``dense`` at [12000, 5120] x [5120, 1280] within
     one bf16 step of the float64 product (float32 accumulation);
  4. transcription -- random Whisper-tiny weights from a seeded generator,
     a tokenizer with the published 51,865-token layout, two requests (30 s
     and 47 s of synthetic audio) through ``Transcriber(device="cuda")``;
     the counters of its kernels (K1's tier on the FFT body, K2 on its
     3xTF32 body, K3 on its sm90 body) must rise and no plain version's,
     old K1/K4 body's, CUDA-core K2's or first K3 body's may; then the
     card is
     held against the port's CPU path in float32 (the log-mel, FFT body
     against K1's plain version; encoder states, and teacher-forced
     logits of every decode step);
  4b. decoders -- random Whisper-small and Whisper-tiny weights, a 30 s
     and a 47 s request (its last 10 s silent), ``max_new_tokens`` 64,
     through ``Transcriber`` on the card: beam search (``beam_width=5,
     patience=2.0``) in float32 and with int8 KV, ``best_of=5`` at
     t = 0.4, speculative decoding (Whisper-tiny drafting for
     Whisper-small with 8 tokens a pass, then Whisper-small drafting for
     itself with 9), ``word_timestamps`` in the seek loop
     (``seek_by_timestamps``, ``hallucination_silence_threshold=2.0``,
     ``vad_threshold_db=-40``, the silent tail as a clip of its own) and
     ``lang="auto"``; then ``StreamingTranscriber`` at Whisper-tiny (8
     slots, 6 streams of two windows fed in 0.5 s pieces, one silent
     under VAD) and the same audio through ``serve_streaming`` to two
     WebSocket clients. Each path must launch K1 (its FFT body), K2 (its
     3xTF32 body) and K3 (its sm90 body; its int8 arm with int8 KV) and
     no plain version; the silent window no K3. Then: ``beam_width=1``
     equals greedy ``generate`` token for token; the best beam's
     sum-logprob teacher-forced through the port's CPU path within 1e-3
     per token; best-of keeps the ranker's maximum; speculative tokens
     equal greedy's up to a position where greedy's top two logits are
     closer than ``TOL_SPEC_TIE`` (printed with its margin, the accepted
     tokens per pass and the wall time against greedy); one window's
     alignment matrix card against CPU within ``TOL_ALIGN`` and its word
     timings within one frame; the WebSocket clients receive the direct
     calls' segments. Each request prints its wall time and RTF with the
     card's name and power limit;
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
     version may; K3-int8 8 times a decode step and K9 33, all on their
     sm90 and tensor-core bodies. Then requests/s, latency
     p50 and max, decode steps, tokens/s, launches per decode step and peak memory; the card
     against the port's CPU path (teacher-forced ``decode_step_ragged``
     with float and with int8 self-KV, two faults planted in the int8
     writes that the limit must reject, and the int8 reading over 16 seeds
     of one decode step: largest and median beside the limit, the written
     codes within +-1 and scales within 1e-3 relative), and
     ``attention(kv_cached=)`` through K6 (its sm90 body's int8 arm);
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
     K9's tensor-core body, its "current" arm) must launch on their
     tensor-core bodies, none of the tools' first bodies may (the tools'
     shapes take the tensor-core bodies) and no plain version may;
  9. attention_tools -- ``attn_headfold_probe`` (the four kernel arms and
     the product A/B), ``attn_block_probe`` (the tile set, forward and
     backward, at [8, 12, 1500, 64] bf16), ``train_step_breakdown`` at
     Whisper-small width (B = 8, label length 32, ``--attn flash`` and
     ``--attn xla``, 3 iterations) and ``mfu_study --only 0,10 --steps 3``,
     each through its entry point on the card: one JSON line each with
     its rows, verdict, seconds and launches; K2/K7/K8 (and P1 in the fold
     probe) must launch where a tool drives them, their tensor-core bodies
     in every run (and they alone in the fold probe, the step and the MFU
     runs), none in the xla arm, and no plain version anywhere;
 9b. music -- Qwen3-0.6B's published config (hidden 1024, 28 layers, 16
     query and 8 KV heads of 128, intermediate 3072, q/k norms, tied
     embeddings) with its 151,936-row vocabulary grown by 128 added ABC
     tokens (a BPE trained on synthetic ABC tunes, padded with filler to
     Qwen's size), a Whisper-base audio tower and the 8-head adapter, all
     random from seed 0 on the card, float32, as ``infer-music`` builds
     them; the adapter's zero-initialised gates opened. A trainable-only
     checkpoint saved by ``save_trainable_checkpoint`` and merged back by
     ``load_trainable_checkpoint`` must restore every leaf bit-exactly;
     one teacher-forced 64-token sequence through ``TwoTowerModel.forward``
     (K2 at the adapter's cross and the LM's causal GQA sites) within
     ``TOL_LOGITS`` of the CPU path; one 4-slot decode step
     (``two_tower_step``, the step both generators serve) timed and
     profiled (its kernels by family, its launches, the busy share; a
     profile with no device time fails the phase); then ``infer-music
     --constrained`` at t = 0 through ``cli.main.main`` with the
     checkpoint: ``--wav`` on one 10 s synthetic clip with ``--prompt``,
     ``--wav-dir`` on six clips over four slots. Each run must launch K1
     (FFT body), K2 (3xTF32 body) and K3 (sm90 body, 28 a decode step
     exactly) and no plain version; the tokens of the first
     ``MUSIC_HOLD_REQUESTS`` requests (the ``--wav`` clip's, then the
     last ``--wav-dir`` ones', admitted into freed slots) must equal the CPU path's teacher-forced argmax
     over the allowed ids up to the first near-tie (``TOL_MUSIC_TIE``). Prints wall, ms a step, tokens/s and
     launches a step with the card's name and power limit;
 9c. music_train -- the music training path at Qwen3-0.6B + Whisper-base
     width, float32: 24 in-memory 10 s examples from the ported MIDI
     datagen (``_random_melody`` -> ``render_midi`` -> ``midi_to_abc`` ->
     BPE over Qwen3's vocabulary layout), ``fit_two_tower`` for one epoch
     at batch 8 and 512 target tokens (two train steps, one val batch;
     launches K1 once a batch, K2 six times in the frozen encoder and once
     in the adapter a batch, K7 and K8 once a train step, exactly), one
     ``eval_note_f1`` on 4 examples at ``max_len`` 64 (K1, K2, K3), two
     more steps timed (step ms, tokens/s, peak memory, launches a step),
     the frozen layers bit-identical after the epoch, and one step at batch
     1 and ``HOLD_TOKENS`` (32) tokens held against the CPU path (loss within
     ``TOL_STEP_LOSS``, the adapter's and the top layer's gradients within
     ``TOL_STEP_GRAD`` of each leaf's largest); then ``train-lm --lm-size
     qwen3-0.6b`` through ``cli.main.main`` for 3 steps at batch 32 x 256
     on an ABC corpus and BPE written in the phase (K2, K7, K8 on their
     3xTF32 bodies, 28 launches each a step), 2 steps of ``fit_lm`` at
     bfloat16 (the wgmma bodies at head_dim 128) and 2 with ``remat``
     "full" (K2 56 a step), each loss finite, and one float32 step at batch
     1 x ``HOLD_TOKENS`` held against the CPU (loss and every gradient). Its
     kernel shapes (the adapter's cross-attention at head_dim 128 over 500
     keys, the LM's causal GQA in float32 and bf16) are phase 3's
     ``music train`` cases;
 9d. moe -- the two-tower with a mixture-of-experts decoder at
     Qwen3-30B-A3B's published widths (hidden 2048, 32 query and 4 KV heads
     of 128, 128 experts of 768, top 8 renormalised, untied head, vocab
     151,936 + 128; 4 of its 48 layers), a Whisper-base tower and the
     8-head adapter, random from a seed, the LM int4 by ``quantize_tree``:
     the MoE blocks of a 4-slot decode step under
     ``torch.cuda.set_sync_debug_mode("error")`` (the expert ids never
     reach the host); one ``two_tower_step`` launching K9 exactly
     ``layers x slots x k x 3 + layers x 4 + 1`` times (401), timed and
     profiled; a 1-layer copy's decode step card against CPU (the selected
     experts equal, logits within ``TOL_INT4_F32`` of the largest, the
     router's smallest top-k gap printed); then ``ContinuousGenerator``
     over six 10 s clips on four slots, 64 tokens at t = 0 (K1, K2, K3,
     K9 on their card bodies, no plain version, K9 401 a decode step);
 9e. moe training -- ``fit_lm`` at the same widths, 2 of 48 layers, batch 4
     x 256, 2 steps, bf16 over float32 masters with float32 Adam moments
     and the originals on the card (its peak memory printed),
     ``aux_loss_coef`` 0.001, ragged
     (the wgmma K2, K7, K8 four times each); one layer's forward dense
     against ragged on the card within ``TOL_F32``; one float32 step of a
     1-layer copy at batch 1 x 64 with the aux term, card against CPU
     (loss within ``TOL_STEP_LOSS``, every gradient within
     ``TOL_STEP_GRAD`` of its leaf's largest, the router's non-zero);
 9f. moe probe -- ``audax_torch.tools.moe_decode_probe`` on the card (d
     2048, E 128, k 8, f 768, n 1 and 4, bf16): every arm beside its
     selected-bytes floor; K9's tensor-core body serves the int4 arm, no
     plain version runs;
 9g. cli -- the Whisper and classifier commands through
     ``audax_torch.cli.main.main([...])`` in a temporary working
     directory: ``export-hf`` -> ``convert-hf`` at Whisper-large-v3-turbo
     (random weights; every tensor bit-equal, and with ``--quantize int4``
     equal to ``quantize_tree``) and Qwen3-0.6B (``--kind causal-lm``), with
     the seconds and GB/s of each; ``transcribe --size large-v3-turbo
     --ckpt <int4>`` on a 30 s WAV (K1, K2, K3, K9; its CSV text equal to
     an in-process ``Transcriber`` on the same checkpoint and tokenizer);
     ``serve --kv-quant`` on the same checkpoint, two concurrent requests
     answered with HTTP 200 and the text of a ``Transcriber`` at t = 0 with
     int8 KV (K1, K2, K3's int8 arm, K9); ``finetune --size base`` (3 steps,
     full and LoRA rank 8: K1, K2, K7, K8) read back by ``export-hf``
     (both) and ``transcribe --ckpt`` (the full one); ``detect-language``
     and ``stream-serve`` (one WebSocket window, bf16: the wgmma K2) at
     Whisper-base;
     ``preprocess``, ``train-*``/``test-* --no-plot`` (2 epochs),
     ``classifier-proof --no-plot`` and ``verify-parity --kind classifier``
     on 200 synthetic UrbanSound clips (the card machine has no
     matplotlib); every command with its counts from 0, no plain version;
 9h. bench -- the five ``bench-*`` commands through ``cli.main`` at their
     models' published widths (random weights from seeds; the Whisper
     benches with a tokenizer of the published 51,865/51,866-token
     layout; only run lengths cut, ``BENCH_RUNS``): ``bench-rtf --size
     base`` (bf16, the full fallback ladder) and ``--size large-v3-turbo
     --quantize int4 --kv-quant --no-fallback``, ``bench-streaming --size
     base``, ``bench-continuous --engine asr --size base`` and ``--engine
     music --lm-preset qwen3-0.6b``, ``bench-speculative --size base
     --draft-size tiny``, ``bench-train`` at its default (Whisper-tiny,
     B 16, LoRA 8, float32) and ``--size base --dtype bfloat16
     --lora-rank 0``. Each prints one JSON line with every key the JAX
     command prints and finite numbers, exits by its own rule
     (``bench-rtf``: 1 exactly when its RTF is above the 0.05 target),
     launches its kernels and no plain version (the FFT log-mel body,
     K2's wgmma body in the bf16 encoders, K3 and its int8 arm, K9 in the
     int4 run; K2/K7/K8 on 3xTF32 in f32 training, wgmma in bf16, with
     exact counts); the continuous schedule takes no more decode steps
     than the convoy; ``mfu_pct`` reads against the dtype's peak. Then
     ``demo`` at Whisper-tiny on a thread: a WAV through ``/transcribe``
     equal to an in-process Transcriber, ``/add`` of three labelled WAVs,
     a 5-step ``/finetune`` polled on ``/status`` to ``done`` (``failed``
     fails the phase), ``/swap`` and ``/transcribe?model=finetuned``.
     First the host libraries: ``g++ --version`` and whether
     ``ctypes.util.find_library`` finds libav (printed, never branched
     on), and the SF2 synth built by g++ from ``audax_torch/native`` and
     a minimal soundfont written here rendered twice (finite, not silent,
     bit-equal);
 9i. parallel -- data, tensor, fully-sharded and expert parallelism
     (``parallel_phase``): a world of one over NCCL holds
     ``finetune_whisper(mesh=, fsdp=True)`` at Whisper-base, float32,
     ``ContinuousBatcher(mesh=)`` at Whisper-large-v3-turbo width with int8
     KV, ``moe_expert_parallel`` on one Qwen3-30B-A3B layer and
     ``fit_lm(mesh=, fsdp=True)`` at Qwen3-0.6B width against the same
     paths without a mesh; then a world of two processes on the one card
     over gloo probes which collectives gloo carries on CUDA tensors,
     decodes at turbo width with 10 of 20 heads a rank (the world of
     one's tokens) and, where gloo carries its collectives, trains
     Whisper-base under FSDP (data 2: a world of one cuts nothing) against
     the whole run: losses, gathered first moments and updates. Sequence
     and pipeline parallelism run in the same world of two, on
     the weights it already holds: two more worlds probe whether gloo
     carries ``send``/``recv``/``batch_isend_irecv`` on CUDA tensors
     (``parallel/comm.py:ring_shift`` is one ``all_to_all_single`` either
     way); the SP encoder at turbo width on (seq 2), ring and Ulysses,
     against ``encode``; ``finetune_whisper(sp_mesh=)`` at Whisper-base
     against the run without a mesh; the PP encoder at turbo width over 2
     stages; and the PP causal-LM train step at Qwen3-0.6B width against
     the one-rank step, each with its K2/K7/K8 launches as predicted. The
     world of one also holds ``fit_two_tower(mesh=, fsdp=True)`` at
     music_train's widths (losses bit-equal) and
     ``StreamingTranscriber(mesh=)`` at Whisper-base (the same text);
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
#: speculative decoding against greedy ``generate`` on the card: a token
#: where the two part is allowed only where greedy's top two logits there
#: are closer than this (the K-row verify span and the 1-row step are
#: different products, so a near-tie may flip)
TOL_SPEC_TIE = TOL_LOGITS
#: word alignment, card against the port's CPU path on the same tokens and
#: encoder states: the alignment matrix and the attention mass; each word's
#: start and end within one encoder frame
TOL_ALIGN = 1e-3
ALIGN_FRAME_S = 0.02
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
                      "decode_attention_stacked", "decode_attention_sm90")
FINETUNE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                    "flash_backward_dq_tf32x3", "flash_backward_dkv_tf32x3",
                    "decode_attention_stacked", "decode_attention_sm90")
SERVE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                 "decode_attention_stacked_int8", "decode_attention_sm90_int8",
                 "int4_matmul_mma")
#: the decoders phase's paths with ``kv_quant``: K3's int8 arm (its other
#: paths launch ``TRANSCRIBE_KERNELS``)
DECODE_Q8_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                     "decode_attention_stacked_int8",
                     "decode_attention_sm90_int8")
#: K6's entry point, ``attention(kv_cached=QuantKV)``
K6_KERNELS = ("decode_attention", "decode_attention_sm90_int8")
#: K9's launches per serving decode step on its tensor-core body: 4 decoder
#: layers x 8 projections and the tied logits; its split-half body, none
K9_PER_STEP = 33
#: K1's and K4's own kernels: no main path launches them, since every
#: config a path runs takes the FFT body (``ops/fused_mel.py:BODIES``)
OLD_MEL_BODIES = ("log_mel_overlap", "log_mel_packed")
#: K3's and K6's first body (``csrc/decode_attention.cu``): only phase 3's
#: A/B launches it (``body="cuda_core"``); every path runs the sm90 body
OLD_DECODE_BODIES = ("decode_attention_cuda_core",)
#: the counters of K3's and K6's entry points (one per TPU kernel and arm)
#: and of the sm90 body's two arms, which every launch of theirs must match
DECODE_ENTRY = ("decode_attention_stacked", "decode_attention_stacked_int8",
                "decode_attention")
DECODE_SM90 = ("decode_attention_sm90", "decode_attention_sm90_int8")
#: the int4 tools and the kernels each must launch (K9's tensor-core body
#: is every tool's "current" arm)
PROBE_TOOLS = (("int4_layout_ab", ("int4_word_matmul_mma", "int4_matmul_mma")),
               ("int4_plane_probe", ("int4_plane_matmul_mma",
                                     "int4_matmul_mma")),
               ("w4a8_probe", ("w4a8_matmul_mma", "int4_matmul_mma")),
               ("int4_unpack_probe", ("int4_unpack_v1_mma",
                                      "int4_unpack_v2_mma",
                                      "int4_matmul_mma")))
#: the int4 tools' first bodies (``csrc/w4a8_matmul.cu``,
#: ``csrc/int4_unpack_variants.cu``'s v1 and v2, ``csrc/int4_word_matmul.cu``
#: as P2 and P3): the tools' shapes take the tensor-core bodies
#: (``W4A8_BODIES``, ``V1_BODIES``, ``V2_BODIES``, ``WORD_BODIES``,
#: ``PLANE_BODIES``), so no tool run may launch them; phase 3 holds them
#: off those tables and times them directly
OLD_TOOL_BODIES = ("w4a8_matmul", "int4_unpack_v1", "int4_unpack_v2",
                   "int4_word_matmul", "int4_plane_matmul")
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
     ("flash_forward_fold", "flash_forward_wgmma"), ("flash_forward",)),
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
#: the libraries that hold P1, K2's head folds on its tensor-core bodies,
#: with the number of folded instantiations each must hold
FOLD_LIBS = (("flash_fwd_sm90", 2), ("flash_fwd_tf32x3", 2))
#: the libraries built from ``csrc/int4_matmul_mma.cu``: K9's tensor-core
#: body, and P5 v1's, P5 v2's, P4's and the word kernel's (P2, P3) on its
#: skeleton
INT4_MMA_LIBS = ("int4_matmul_mma", "int4_unpack_v1_mma",
                 "int4_unpack_v2_mma", "w4a8_matmul_mma",
                 "int4_word_matmul_mma")
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


def _int4mma_kernels(report):
    """``_ptxas_kernels`` of a library built from ``csrc/int4_matmul_mma.cu``:
    the template arguments read as (route, dtype, vec, nt), route 0 K9, 1
    P5 v2, 2 P4, 3 P5 v1, 4 the word kernel (``int4word_kernel``), dtype 0
    float32, 1 bfloat16."""
    import re
    report = re.sub(r"int4mma_kernelILi(\d)E(f|13__nv_bfloat16)",
                    lambda m: f"kernelILi{m[1]}ELi{int(m[2] != 'f')}E",
                    report)
    return _ptxas_kernels(re.sub(
        r"int4word_kernelI(f|13__nv_bfloat16)",
        lambda m: f"kernelILi4ELi{int(m[1] != 'f')}E", report))


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
    # the music path's clips: Whisper's 80 mels over a 10 s window, an admit
    # of four slots (on a generator of its own)
    overlap_case("whisper 10 s (music)", MelConfig.whisper(), (4, 160000),
                 np.random.default_rng(19))
    # the music training step's batch: eight 10 s windows
    overlap_case("whisper 10 s (music train, batch 8)", MelConfig.whisper(),
                 (8, 160000), np.random.default_rng(20))

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
                   core_ab=False, ref32=False):
        """K2 on the body ``FWD_BODIES`` names, held (o and lse) against
        the plain version; with ``core_ab`` the same call on the CUDA-core
        body too, held and timed in the same run. ``ref32`` (bf16): the
        plain version runs in float32 on the same bf16 inputs (their exact
        attention); o is gated by the element-wise rounding bound and lse
        (float32 on both sides) by ``TOL_F32``: the bf16 plain version also
        rounds q * scale and the scores to bf16, which the bound does not
        model, and among millions of outputs some reach |o| >= 4, where
        one bf16 step (0.031) is past ``TOL_BF16``."""
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
        if ref32:
            e16 = e
            o_ref, lse_ref = att.flash_forward_plain(
                q.float(), ks.float(), vs.float(), causal=causal)
            e_o, e_lse = err(o, o_ref), err(lse, lse_ref)
            e = max(e_o, e_lse)
            print(f"[kernels] {key}[{label}]: max |err| {e16:.3e} against "
                  f"the bf16 plain version (o and lse); against the float32 "
                  f"one o {e_o:.3e}, lse {e_lse:.3e} (tol {TOL_F32:.0e})",
                  flush=True)
            if not e_lse <= TOL_F32:
                raise AssertionError(f"{key}[{label}]: lse off the float32 "
                                     f"plain version by {e_lse:.3e} > "
                                     f"{TOL_F32:.0e}")
        if dtype == torch.bfloat16:
            # each element of o against the rounding bf16 allows: each side
            # that rounds p to bf16 (relative 2^-8: the kernel before
            # normalising, the bf16 plain version after; not the float32
            # one) moves o by at most 2^-8 of the attention-weighted |v|
            # (P|V|, in float32 here), and each rounds its output (one bf16
            # step of the larger between them); 2^-12 of P|V| more for
            # float32 sums
            p_term = 2 ** -8 if ref32 else 2 ** -7
            pv = att.flash_forward_plain(q.float(), ks.float(),
                                         vs.float().abs(), causal=causal)[0]
            a, r = o.float(), o_ref.float()
            big = torch.maximum(a.abs(), r.abs())
            step = torch.where(big > 0, torch.ldexp(
                torch.ones_like(big), torch.frexp(big)[1] - 8), 0.0)
            steps = float(((a - r).abs() / ((p_term + 2 ** -12) * pv
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
        if ref32:
            _report(f"{key}[{label}] ({body} body, o and lse against the "
                    f"float32 plain version; lse {e_lse:.3e})", steps, 1.0,
                    ms, plain, lib, bound, "o/rounding bound")
        else:
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
    # the music two-tower's sites: its adapter's cross-attention (8 heads of
    # 128, q 64 x kv 500: a 64-token teacher-forced sequence over a 10 s
    # window) and Qwen3-0.6B's causal GQA (16q/8kv of 128) at 64 and at 256
    # tokens (the generation length), and Whisper-base's encoder over four
    # 10 s windows (an admit of four slots)
    flash_case("f32 music adapter cross q [1,8,64,128] kv [1,8,500,128]", 1,
               8, 8, 64, 500, f32, False, TOL_F32, False, gen=gen11, d=128)
    flash_case("f32 music LM causal GQA 16q/8kv [1,16,64,128]", 1, 16, 8, 64,
               64, f32, True, TOL_F32, False, gen=gen11, d=128)
    flash_case("f32 music LM causal GQA 16q/8kv [4,16,256,128]", 4, 16, 8,
               256, 256, f32, True, TOL_F32, False, gen=gen11, d=128)
    flash_case("f32 music encoder 10 s [4,8,500,64]", 4, 8, 8, 500, 500, f32,
               False, TOL_F32, False, gen=gen11)
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

    # ---- K3, its int8 arm and K6 on the sm90 body ------------------------------
    from audax_torch.models.whisper import quantize_kv

    def deq(codes, scales):
        return codes.float() * scales[..., None]

    def decode_case(label, s_len, pos, *, L=4, b=4, h=6, hkv=None, tq=1,
                    d=64, dtype=torch.float32, quant=False, k6=False,
                    main=None, timed=True, old=True, gen=None):
        """K3 (``k6``: K6 on one unstacked layer) on the sm90 body against
        its plain version, every call made twice for the same bits; the
        first body (``body="cuda_core"``) against it too where it takes the
        call (``old``). ``timed``: both bodies slope-timed in CUDA graphs
        (the device time; K/V cycled over L layers past the 50 MB L2 as on
        the main path) and by CUDA events (the host's launch time included), the
        plain version and SDPA beside, the bound from the visible keys."""
        hkv = h if hkv is None else hkv
        shape = (b, hkv, s_len, d) if k6 else (L, b, hkv, s_len, d)
        q = torch.randn(b, h, tq, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(*shape, device=dev, generator=gen)
        v = torch.randn(*shape, device=dev, generator=gen)
        kv = quantize_kv(k, v) if quant else (k.to(dtype), v.to(dtype))
        pos_t = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)

        def call(i, body="sm90"):
            if k6:
                return att.decode_attention_cuda(q, kv, pos=pos_t, body=body)
            return att.decode_attention_stacked_cuda(q, kv, i % L, pos=pos_t,
                                                     body=body)

        def plain(i):
            if k6:
                return att.decode_attention_plain(q, kv, pos=pos_t)
            return att.decode_attention_stacked_plain(q, kv, i % L,
                                                      pos=pos_t)

        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        e, old_e = 0.0, 0.0
        for li in range(1 if k6 else L):
            got, again, ref = call(li), call(li), plain(li)
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two calls gave other bits")
            e = max(e, err(got, ref))
            if old:
                old_e = max(old_e, err(call(li, "cuda_core"), ref))
        if not old_e <= tol:
            raise AssertionError(f"{label}: the first body's max |err| "
                                 f"{old_e:.3e} > {tol:.0e}")
        kind = "decode_attention" if k6 else (
            "decode_attention_stacked_int8" if quant
            else "decode_attention_stacked")
        if not timed:
            print(f"[kernels] {kind}[{label}]: max_abs_err {e:.3e} (tol "
                  f"{tol:.0e}), two calls the same bits"
                  + (f"; first body {old_e:.3e}" if old else ""), flush=True)
            if not e <= tol:
                raise AssertionError(f"{label}: max |err| {e:.3e} > {tol:.0e}")
            return
        it = iter(range(10 ** 9))
        ms = _graph_ms(torch, lambda: call(next(it)))
        old_ms = _graph_ms(torch, lambda: call(next(it), "cuda_core"))
        ev_ms = _time_ms(torch, lambda: call(next(it)))
        ev_old = _time_ms(torch, lambda: call(next(it), "cuda_core"))
        plain_ms = _time_ms(torch, lambda: plain(next(it)))
        kf, vf = ((deq(kv.k_q, kv.k_scale), deq(kv.v_q, kv.v_scale))
                  if quant else kv)
        kf, vf = kf.to(dtype), vf.to(dtype)
        ps = [s_len] * b if pos is None else (
            [int(pos)] * b if isinstance(pos, int) else list(pos))
        mask = None
        if pos is not None:
            cols = torch.arange(s_len, device=dev)
            rows = torch.arange(tq, device=dev)
            pv = torch.tensor(ps, device=dev)
            mask = (cols[None, None, :] <= pv[:, None, None]
                    + rows[None, :, None])[:, None]

        def sdpa():
            i = next(it) % L
            return F.scaled_dot_product_attention(
                q, kf if k6 else kf[i], vf if k6 else vf[i], attn_mask=mask,
                enable_gqa=h != hkv)
        lib = _graph_ms(torch, sdpa)
        # keys each row may see, and the K/V rows (and scales) a kv head
        # must read once
        seen = sum(max(0, min(s_len, p + r + 1)) for p in ps
                   for r in range(tq))
        rows_read = sum(max(0, min(s_len, p + tq)) for p in ps)
        elt = 1 if quant else kf.element_size()
        nbytes = (2 * hkv * rows_read * (d * elt + 4 * quant)
                  + 2 * b * h * tq * d * q.element_size())
        bound = _bound(4 * d * h * seen, nbytes, F32_FLOPS)
        _report(f"{kind}[{label}]", e, tol, ms, plain_ms, lib, bound)
        print(f"[kernels]   first body (cuda_core) {old_ms:.4f} ms "
              f"({old_ms / ms:.2f}x; max_abs_err {old_e:.3e}); CUDA-graph "
              f"device times, SDPA too; events ms {ev_ms:.4f} / first body "
              f"{ev_old:.4f}", flush=True)
        if main:
            out[main] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib, bound=bound)

    pos = [int(p) for p in rng.integers(0, 448, size=4)]
    decode_case(f"self [4,4,6,448,64] pos {pos}", 448, pos)
    decode_case("cross [4,4,6,1500,64] pos=None", 1500, None,
                main="decode_attention_stacked")
    decode_case("cross [4,4,6,1500,64] per-slot pos [0,1499,700,3]", 1500,
                [0, 1499, 700, 3])
    decode_case("GQA 8q/2kv Tq=3 S=64 pos [0,5,30,63]", 64, [0, 5, 30, 63],
                h=8, hkv=2, tq=3)
    decode_case("S=1 pos 0", 1, 0, timed=False)
    decode_case("Tq=16 S=448 pos [0,447,100,7]", 448, [0, 447, 100, 7],
                tq=16, timed=False)
    for d in (16, 32, 128):
        decode_case(f"head_dim {d} GQA 8q/2kv S=448 pos [0,447,200,31]", 448,
                    [0, 447, 200, 31], h=8, hkv=2, tq=2, d=d, timed=False)
    decode_case("bf16 cross [4,4,6,1500,64]", 1500, None,
                dtype=torch.bfloat16)
    decode_case("bf16 Tq=3 S=448 pos [0,447,9,100]", 448, [0, 447, 9, 100],
                tq=3, dtype=torch.bfloat16, timed=False)
    # a chunk past one block's shared memory, copied in tiles (the first
    # body takes no such call: its scores of S keys overflow)
    decode_case("tiles: head_dim 128 Tq=16 S=3000", 3000, None, L=1, b=1,
                h=2, tq=16, d=128, timed=False, old=False)
    # more rows than one launch takes (a speculative prefill): chunks of 16
    # at pos + 0, 16, 32, each row masked at its own position
    gen = torch.Generator(device=dev).manual_seed(6)
    decode_case("self Tq=40 in chunks of 16, pos [0,17,200,400]", 448,
                [0, 17, 200, 400], tq=40, gen=gen)
    decode_case("int8 cross [4,8,20,1500,64] pos=None", 1500, None, b=8,
                h=20, quant=True, main="decode_attention_stacked_int8")
    # slots at the first and the last position among them
    pos = [0, 67] + [int(p) for p in rng.integers(0, 68, size=8)][2:]
    decode_case(f"int8 self [4,8,20,68,64] pos {pos}", 68, pos, b=8, h=20,
                quant=True)
    decode_case("int8 Tq=16 head_dim 32 S=300 pos [0,299]", 300, [0, 299],
                b=2, h=4, hkv=2, tq=16, d=32, quant=True, timed=False)
    decode_case("int8 bf16 q S=500 pos [0,499,3,250]", 500, [0, 499, 3, 250],
                quant=True, dtype=torch.bfloat16, timed=False)
    decode_case("K6 int8 [8,20,1500,64] pos=None", 1500, None, b=8, h=20,
                quant=True, k6=True, main="decode_attention")
    decode_case("K6 f32 [8,20,1500,64] pos=700", 1500, 700, b=8, h=20,
                k6=True)
    # the music LM's decode step at Qwen3-0.6B width: 28 stacked layers, GQA
    # 16q/8kv (group 2) at head_dim 128 over a 256-row cache; a host-int
    # position (the single-clip generate) and per-slot positions at 0 and
    # S - 1 among them (ContinuousGenerator's four slots)
    gen19 = torch.Generator(device=dev).manual_seed(19)
    decode_case("music LM [28,1,8,256,128] GQA 16q/8kv pos 200", 256, 200,
                L=28, b=1, h=16, hkv=8, d=128, gen=gen19)
    decode_case("music LM [28,4,8,256,128] GQA 16q/8kv per-slot pos "
                "[0,255,17,128]", 256, [0, 255, 17, 128], L=28, b=4, h=16,
                hkv=8, d=128, gen=gen19)

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

    # ---- the music training path's sites, at their real shapes ----------------
    # the two-tower step (batch 8, 512 target tokens, 10 s windows): the
    # adapter's cross-attention, 8 heads of 128, 512 queries over 500 keys
    # (7 key tiles of 64 and a ragged 52); train-lm's step (batch 32 x 256):
    # Qwen3-0.6B's causal GQA, 16 query heads over 8 KV heads of 128, in
    # float32 (3xTF32 bodies) and bf16 (wgmma bodies); on their own generator
    gen20 = torch.Generator(device=dev).manual_seed(20)
    flash_case("f32 music train adapter cross q [8,8,512,128] kv "
               "[8,8,500,128]", 8, 8, 8, 512, 500, f32, False, TOL_F32,
               False, gen=gen20, d=128)
    bwd_case("music train adapter cross f32 q [8,8,512,128] kv "
             "[8,8,500,128]", 8, 8, 8, 512, 500, torch.float32, False,
             TOL_F32, False, gen=gen20, d=128, reps=5)
    for dt, tol, name in ((f32, TOL_F32, "f32"), (bf16, TOL_BF16, "bf16")):
        flash_case(f"{name} music train LM causal GQA 16q/8kv "
                   "[32,16,256,128]", 32, 16, 8, 256, 256, dt, True, tol,
                   False, gen=gen20, d=128, ref32=dt == bf16)
        bwd_case(f"music train LM causal GQA 16q/8kv {name} "
                 "[32,16,256,128]", 32, 16, 8, 256, 256, dt, True, tol,
                 False, gen=gen20, d=128, reps=5)

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

    # ---- K9 and the int4 tools' kernels at the decode shapes (M = 8) --------
    from audax_torch.ops import int4_matmul as i4
    from audax_torch.tools import arm_times, probe_kernels
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
    #: tensor cores for bf16 x; int8 tensor cores for W4A8). Each here is
    #: its tool's first body, called directly (the A/B of ``tool_case``
    #: below)
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

    def split_half_at(w, group):
        q, s = i4.quantize_int4(w, group=group)
        return (q, s), i4.dequantize_int4(q, s)

    def words_at(w, group):
        word, s = lab.quantize_words(w, group)
        return (word, s), lab.dequantize_int4_v2(word, s)

    #: P2-P5 through the tools' entry points: name -> (entry point, {body:
    #: its wrapper as (x, weights, scales)}, plain version, packing at a
    #: group, the body table (each body's launch counter in
    #: ``tools.probe_kernels`` and rule) and the body it gives, the peak of
    #: the unit each body's products run on, by x's dtype (f32, bf16)). The
    #: tensor-core bodies of K9's skeleton run float32 x as three bf16 parts
    mma3 = (BF16_FLOPS / 3, BF16_FLOPS)
    tool_entries = {
        "int4_unpack_v1": (
            lambda x, q, s: up.run_variant("v1", x, q, s),
            {"mma": up.unpack_v1_mma_cuda, "split_half": up.unpack_v1_cuda},
            up.unpack_v1_plain, split_half_at, up.V1_BODIES, up.v1_body,
            {"mma": mma3, "split_half": (F32_FLOPS, F32_FLOPS)}),
        "int4_unpack_v2": (
            lambda x, q, s: up.run_variant("v2", x, q, s),
            {"mma": up.unpack_v2_mma_cuda, "blocked": up.unpack_v2_cuda},
            up.unpack_v2_plain, split_half_at, up.V2_BODIES, up.v2_body,
            {"mma": (TF32X3_FLOPS, BF16_FLOPS),
             "blocked": (F32_FLOPS, BF16_FLOPS)}),
        "w4a8_matmul": (
            wp.w4a8_matmul,
            {"mma": wp.w4a8_matmul_mma_cuda, "dp4a": wp.w4a8_matmul_cuda},
            wp.w4a8_matmul_plain, split_half_at, wp.W4A8_BODIES,
            wp.w4a8_body,
            {"mma": (INT8_OPS, INT8_OPS), "dp4a": (INT8_OPS, INT8_OPS)}),
        "int4_word_matmul": (
            lab.int4_matmul_v2,
            {"mma": lab.int4_matmul_v2_mma_cuda,
             "cuda_core": lab.int4_matmul_v2_cuda},
            lab.int4_matmul_v2_plain, words_at, lab.WORD_BODIES,
            lab.word_body, {"mma": mma3, "cuda_core": (F32_FLOPS, F32_FLOPS)}),
        "int4_plane_matmul": (
            plane(pp.plane_matmul),
            {"mma": plane(pp.plane_matmul_mma_cuda),
             "cuda_core": plane(pp.plane_matmul_cuda)},
            plane(pp.plane_matmul_plain), words_at, pp.PLANE_BODIES,
            lab.word_body, {"mma": mma3, "cuda_core": (F32_FLOPS, F32_FLOPS)}),
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

    def tool_case(name, what, m, k_dim, n, dtype, tol, timed=False,
                  main=False, group=128, gen=None):
        """P2-P5 through the tool's entry point: each of two calls launches
        the body the tool's table gives once and no other, and both give
        the same bits; against the plain version at [m, K] x [K, N].
        ``timed``: the body's time from HBM and L2-warm beside cuBLAS on
        the dequantized weights in x's dtype."""
        (entry, wrappers, plain_fn, pack, bodies, body_of,
         rates) = tool_entries[name]
        (q, s), wd = pack(torch.randn(k_dim, n, device=dev, generator=gen)
                          / k_dim ** 0.5, group)
        body = body_of(k_dim, group)
        x = torch.randn(m, k_dim, device=dev, generator=gen).to(dtype)
        counters = {b: probe_kernels()[c][0] for b, (c, _) in bodies.items()}
        outs = []
        for _ in range(2):
            before = {b: fn.launches for b, fn in counters.items()}
            outs.append(entry(x, q, s))
            runs = {b: fn.launches - before[b] for b, fn in counters.items()}
            if runs != {b: int(b == body) for b in counters}:
                raise AssertionError(f"{name} {what}: launches {runs}, not "
                                     f"one of the {body} body alone")
        got = outs[0]
        if not torch.equal(got, outs[1]):
            raise AssertionError(f"{name} {what}: two calls differ")
        ref = plain_fn(x, q, s)
        ref_max = float(ref.float().abs().max())
        e = err(got, ref)
        rel = e / ref_max
        dt = "f32" if dtype == torch.float32 else "bf16"
        label = (f"{bodies[body][0]}[{what} {dt} [{m},{k_dim}]x[{k_dim},{n}] "
                 f"group {group}]")
        if not timed:
            if not rel <= tol:
                raise AssertionError(f"{label}: max rel err {rel:.3e} > "
                                     f"{tol:.0e}")
            print(f"[kernels] {label}: max_rel_err {rel:.3e} (tol {tol:.0e}),"
                  f" max_abs_err {e:.3e}, bit-identical twice, one launch "
                  f"of the {body} body a call", flush=True)
            return
        cold, warm = arm_times(wrappers[body], x, (q, s))
        plain = _time_ms(torch, lambda: plain_fn(x, q, s))
        lib, _ = arm_times(torch.matmul, x, (wd.to(dtype),))
        rate = rates[body][dtype == torch.bfloat16]
        bound = int4_bound(m, k_dim, n, dtype, (q, s), rate)
        _report(f"{label} (max_abs_err {e:.3e}, bit-identical twice, one "
                f"launch of the {body} body a call; ms from HBM, L2-warm "
                f"{1e3 * warm:.4f})", rel, tol, 1e3 * cold, plain, 1e3 * lib,
                bound, "max_rel_err")
        if main:
            out[bodies[body][0]] = dict(max_abs_err=e, ms=1e3 * cold,
                                        plain_ms=plain, library_ms=1e3 * lib,
                                        bound=bound)

    # P4 and P5 v2 on their tensor-core bodies at the tools' shape (the
    # main case bf16, as the tools run them), ragged N and M = 9; at group
    # 40 (not a whole k16 / k32 step) on their first bodies. On their own
    # generator: the later phases keep the inputs they drew before these
    # cases existed
    gen = torch.Generator(device=dev).manual_seed(16)
    for name in ("int4_unpack_v2", "w4a8_matmul"):
        for dtype in (torch.float32, torch.bfloat16):
            tol = (TOL_BF16 if dtype == torch.bfloat16 else
                   TOL_W4A8_F32 if name == "w4a8_matmul" else TOL_INT4_F32)
            tool_case(name, "tools", 8, 1280, 5120, dtype, tol, timed=True,
                      main=dtype == torch.bfloat16, gen=gen)
            tool_case(name, "ragged", 8, 1280, 1287, dtype, tol, gen=gen)
            tool_case(name, "rows", 9, 1280, 5120, dtype, tol, gen=gen)
            tool_case(name, "group 40", 8, 1280, 1287, dtype, tol, group=40,
                      gen=gen)
    # P5 v1 and the word kernel (P2; P3 at its straddling group 128) on
    # their tensor-core bodies at the tools' shapes (the main case bf16 at
    # [8,1280]x[1280,5120], as the tools run them; P2 at its three), ragged
    # N (the word body's 4-byte rows at nt 1, 4 and 2: N 1287 at K 1280,
    # N 5127, and N 1287 at K 5120) and M = 9, each dtype; off the tables on
    # their first bodies: group 40 (not a whole k16 step) and, for P3, K/8
    # = 168 (not one either). On their own generator, drawn after the cases
    # above
    gen = torch.Generator(device=dev).manual_seed(17)
    p2_shapes = ((1280, 5120, 32), (5120, 1280, 128), (1280, 1280, 32))
    p2_ragged = ((1280, 1287, 32), (1280, 5127, 32), (5120, 1287, 128))
    for name, timed_shapes, ragged, group, off_table in (
            ("int4_unpack_v1", ((1280, 5120, 128),), ((1280, 1287, 128),),
             128, (1280, 1287, 40)),
            ("int4_word_matmul", p2_shapes, p2_ragged, 32, (1280, 1287, 40)),
            ("int4_plane_matmul", ((1280, 5120, 128),), ((1280, 1287, 128),),
             128, (1344, 1287, 64))):
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_INT4_F32
            for k_dim, n, g in timed_shapes:
                tool_case(name, "tools", 8, k_dim, n, dtype, tol, timed=True,
                          main=(dtype == torch.bfloat16
                                and (k_dim, n) == (1280, 5120)),
                          group=g, gen=gen)
            for k_dim, n, g in ragged:
                tool_case(name, "ragged", 8, k_dim, n, dtype, tol, group=g,
                          gen=gen)
            tool_case(name, "rows", 9, 1280, 5120, dtype, tol, group=group,
                      gen=gen)
            k_dim, n, g = off_table
            tool_case(name, f"group {g} off the table", 8, k_dim, n, dtype,
                      tol, group=g, gen=gen)
    return out


def fold_cases(torch, gen):
    """P1 (``tools/attn_headfold_probe.py:fold_fwd``: K2 folding 2 or 4
    heads per block) on the tensor-core body of its dtype (wgmma in bf16,
    3xTF32 in float32) against its plain version at the tool's shape, bf16
    [96, 1536, 64], and with a ragged key count (1500 of 1536 rows) in
    float32 (folds 2 and 4: fold 4 rings 32-key half tiles and reads Q at
    use) and bf16; each call must launch that body once and no other.
    Each case is slope-timed in CUDA graphs beside the CUDA-core fold
    (``body="cuda_core"``, in brackets) and SDPA; the plain
    version by CUDA events. The bound takes the peak of the body's
    arithmetic (bf16 tensor cores; 3xTF32 for float32). Returns the
    summary of the fold-2 bf16 case at the tool's shape."""
    import torch.nn.functional as F

    from audax_torch.ops import attention as att
    from audax_torch.tools import attn_headfold_probe as hf

    dev, bh, t, d = "cuda", 96, 1536, 64
    counters = {"wgmma": att.flash_forward_wgmma_cuda,
                "tf32x3": att.flash_forward_tf32x3_cuda}
    main = None
    for fold, dtype, kv_len in ((2, torch.bfloat16, t), (4, torch.bfloat16, t),
                                (2, torch.float32, 1500),
                                (2, torch.bfloat16, 1500),
                                (4, torch.float32, 1500)):
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        kw = dict(scale=d ** -0.5, kv_len=kv_len)
        body = att.fwd_body(dtype, d, fold=fold)
        before = {n: c.launches for n, c in counters.items()}
        core_before = att.flash_forward_cuda.launches
        o, lse = hf.fold_fwd_cuda(q, k, v, fold=fold, **kw)
        ran = {n: c.launches - before[n] for n, c in counters.items()}
        if (ran != {n: int(n == body) for n in counters}
                or att.flash_forward_cuda.launches != core_before):
            raise AssertionError(f"P1 fold {fold} {dtype}: the {body} body "
                                 f"did not serve the call alone ({ran})")
        o_ref, lse_ref = hf.fold_fwd_plain(q, k, v, **kw)
        e = float((o.float() - o_ref.float()).abs().max())
        if dtype == torch.float32:
            e, tol = max(e, float((lse - lse_ref).abs().max())), TOL_F32
            rel = e
        else:       # bf16: against the plain output's largest value
            tol, rel = TOL_BF16, e / float(o_ref.float().abs().max())
        ms = _graph_ms(torch, lambda: hf.fold_fwd_cuda(
            q, k, v, fold=fold, **kw))
        core_ms = _graph_ms(torch, lambda: hf.fold_fwd_cuda(
            q, k, v, fold=fold, body="cuda_core", **kw))
        plain = _time_ms(torch, lambda: hf.fold_fwd_plain(q, k, v, **kw),
                         reps=5)
        ks, vs = k[None, :, :kv_len], v[None, :, :kv_len]
        lib = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], ks, vs))
        flops = 4 * bh * t * kv_len * d
        nbytes = q.element_size() * d * 2 * bh * (t + kv_len) + 4 * bh * t
        rate = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
        bound = _bound(flops, nbytes, rate)
        dt = "f32" if dtype == torch.float32 else "bf16"
        _report(f"flash_forward_fold[fold {fold} {dt} [{bh},{t},{d}] kv_len "
                f"{kv_len}] ({body} body, max_abs_err {e:.3e}; CUDA-core fold "
                f"[{core_ms:.4f}] ms)", rel, tol, ms, plain, lib, bound,
                "max_abs_err" if dtype == torch.float32 else "max_rel_err")
        print(f"[kernels] P1 fold {fold} {dt} kv_len {kv_len} A/B in one "
              f"run (CUDA graphs): {body} body {ms:.4f} ms; CUDA-core "
              f"fold {core_ms:.4f} ms ({core_ms / ms:.2f}x); SDPA "
              f"{lib:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})",
              flush=True)
        if main is None:
            main = dict(max_abs_err=e, ms=ms, plain_ms=plain, library_ms=lib,
                        bound=bound)
    return main


#: K9's expert shapes on the MoE decode path at Qwen3-30B-A3B width: x
#: [1, K] @ int4 [K/2, N] of one expert, selected from a [L E, K/2, N]
#: stack by a device index (the router's output): gate/up 2048 -> 768,
#: down 768 -> 2048, group 128
K9_EXPERT_SHAPES = ((2048, 768, "expert gate/up"), (768, 2048, "expert down"))
#: slices in the stacks the device-index cases select from (two layers of
#: 128 experts); the timed calls cycle over 128 of them, 0.1 GB of packed
#: weights, twice the L2, so each reads its slice from HBM
K9_STACK = 256


def k9_index_cases(torch):
    """K9 with its stacked index as a device tensor (``ops/int4_matmul.py``,
    ``csrc/int4_select.cuh``) at the two expert shapes, float32 and bf16:
    each call one launch of the tensor-core body, held against the plain
    version (which selects by ``index_select``), bit-equal to the host-int
    route on the same slice, different for another index; the split-half
    body with the same device index held against the plain version too.
    Timed in CUDA graphs from HBM (128 indices cycled, one slice each) and
    L2-warm, beside the plain version (events) and cuBLAS on the
    dequantized slice in x's dtype (cycled the same way). Returns {label:
    summary} for the records."""
    from audax_torch.ops import int4_matmul as i4
    from audax_torch.utils.profiling import slope_timed

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())

    def graphs_ms(fns):
        it = iter(range(10 ** 9))
        return 1e3 * slope_timed(lambda: fns[next(it) % len(fns)](), (),
                                 iters=(128, 384), repeats=3, device=dev)

    for k_dim, n, what in K9_EXPERT_SHAPES:
        q, s = i4.quantize_int4(torch.randn(K9_STACK, k_dim, n, device=dev,
                                            generator=gen) / k_dim ** 0.5)
        idx = [torch.tensor(j, device=dev) for j in range(0, K9_STACK, 2)]
        deq = {dt: [i4.dequantize_int4(q[j], s[j]).to(dt)
                    for j in range(0, K9_STACK, 2)]
               for dt in (torch.float32, torch.bfloat16)}
        group = 2 * q.shape[-2] // s.shape[-2]
        body = i4.int4_body(k_dim, group)
        for dtype, tol in ((torch.float32, TOL_INT4_F32),
                           (torch.bfloat16, TOL_BF16)):
            x = torch.randn(1, k_dim, device=dev, generator=gen).to(dtype)
            sel, other = idx[37], idx[38]
            before = (i4.int4_matmul_mma_cuda.launches,
                      i4.int4_matmul_cuda.launches)
            got = i4.int4_matmul(x, q, s, layer=sel)
            runs = (i4.int4_matmul_mma_cuda.launches - before[0],
                    i4.int4_matmul_cuda.launches - before[1])
            if body != "mma" or runs != (1, 0):
                raise AssertionError(f"K9 {what}: body {body}, launches "
                                     f"{runs}, not one of the tensor-core "
                                     "body")
            host = i4.int4_matmul(x, q, s, layer=74)
            if not torch.equal(got, host):
                raise AssertionError(f"K9 {what}: the device index and the "
                                     "host int give different bits")
            if torch.equal(got, i4.int4_matmul(x, q, s, layer=other)):
                raise AssertionError(f"K9 {what}: another index gave the "
                                     "same result")
            ref = i4.int4_matmul_plain(x, q, s, layer=sel)
            e = rel(got, ref)
            e_split = rel(i4.int4_matmul_cuda(x, q, s, layer=sel), ref)
            e_split_host = rel(i4.int4_matmul_cuda(x, q, s, layer=74), ref)
            dt = "f32" if dtype == torch.float32 else "bf16"
            label = (f"int4_matmul_mma[{what} {dt} [1,{k_dim}]x[{k_dim},{n}]"
                     f" device index into [{K9_STACK}, {k_dim // 2}, {n}] "
                     f"group {group}]")
            if not (e <= tol and e_split <= tol and e_split_host <= tol):
                raise AssertionError(f"{label}: max rel err {e:.3e}, "
                                     f"split-half {e_split:.3e} / "
                                     f"{e_split_host:.3e} > {tol:.0e}")
            cold = graphs_ms([lambda j=j: i4.int4_matmul(x, q, s, layer=j)
                              for j in idx])
            warm = graphs_ms([lambda: i4.int4_matmul(x, q, s, layer=sel)])
            lib = graphs_ms([lambda w=w: torch.matmul(x, w)
                             for w in deq[dtype]])
            plain = _time_ms(torch, lambda: i4.int4_matmul_plain(
                x, q, s, layer=sel))
            nbytes = (q[0].numel() + 4 * s[0].numel()
                      + x.element_size() * (k_dim + n) + 8)
            parts = 3 if dtype == torch.float32 else 1
            bound = _bound(2 * k_dim * n, nbytes, BF16_FLOPS / parts)
            _report(f"{label} (max_abs_err {float((got - ref).abs().max()):.3e}"
                    f", bit-equal to the host-int route, another index "
                    f"differs; split-half body with the device index "
                    f"{e_split:.3e}; ms from HBM (128 slices cycled), "
                    f"L2-warm {warm:.4f})", e, tol, cold, plain, lib, bound,
                    "max_rel_err")
            out[f"{what} {dt}"] = dict(max_rel_err=e, ms=cold, warm_ms=warm,
                                       plain_ms=plain, library_ms=lib,
                                       bound=bound)
        del q, s, deq
    return out


#: the child of ``k9_trap_cases``: K9 launched with a device index equal to
#: the stack length L; the kernel's trap must end the child with a CUDA
#: error (argv: the body, "mma" or "split")
K9_TRAP_CHILD = """
import sys
sys.path.insert(0, sys.argv[2])
import torch
from audax_torch.core.runtime import resolve_device
from audax_torch.ops import int4_matmul as i4
resolve_device("cuda")
g = torch.Generator(device="cuda").manual_seed(5)
q, s = i4.quantize_int4(torch.randn(4, 2048, 768, device="cuda",
                                    generator=g) / 2048 ** 0.5)
x = torch.randn(1, 2048, device="cuda", generator=g)
bad = torch.tensor(q.shape[0], device="cuda")
call = i4.int4_matmul if sys.argv[1] == "mma" else i4.int4_matmul_cuda
y = call(x, q, s, layer=bad)
torch.cuda.synchronize()
print("finished", float(y.abs().max()))
"""


def k9_trap_cases(torch):
    """K9's out-of-range trap (``csrc/int4_select.cuh``): a child process
    (``sys.executable``) launches each body, the tensor-core one through
    ``int4_matmul`` and the split-half one through its wrapper, with a
    device index equal to L. A trap ends the CUDA context, so it runs
    apart: the parent requires each child to exit non-zero with a CUDA
    error in its stderr (a child that exits 0 fails the run), then makes
    one in-range K9 call here and holds it against its plain version."""
    from audax_torch.ops import int4_matmul as i4

    # both children at once: each process's start is most of its time
    t0 = time.perf_counter()
    children = {body: subprocess.Popen(
        [sys.executable, "-c", K9_TRAP_CHILD, body, str(ROOT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT)) for body in ("mma", "split")}
    for body, child in children.items():
        try:
            out, stderr = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        err = [ln for ln in stderr.splitlines() if "cuda error" in ln.lower()]
        print(f"[k9_trap] {body} body, device index L = 4 into a stack of "
              f"4: child exit {child.returncode} in "
              f"{time.perf_counter() - t0:.1f} s (both children at once); "
              f"{err[-1] if err else ''}{out.strip()}", flush=True)
        if child.returncode == 0 or not err:
            raise AssertionError(f"K9 {body} body with an index out of range:"
                                 f" exit {child.returncode}, stderr "
                                 f"{stderr[-2000:]}")
    g = torch.Generator(device="cuda").manual_seed(5)
    q, s = i4.quantize_int4(torch.randn(4, 2048, 768, device="cuda",
                                        generator=g) / 2048 ** 0.5)
    x = torch.randn(1, 2048, device="cuda", generator=g)
    idx = torch.tensor(3, device="cuda")
    before = i4.int4_matmul_mma_cuda.launches
    got = i4.int4_matmul(x, q, s, layer=idx)
    ref = i4.int4_matmul_plain(x, q, s, layer=idx)
    e = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[k9_trap] after the children: in-range K9 (index 3 of 4, "
          f"{i4.int4_matmul_mma_cuda.launches - before} launch of the "
          f"tensor-core body) max rel err {e:.3e} (tol "
          f"{TOL_INT4_F32:.0e})", flush=True)
    if not (e <= TOL_INT4_F32
            and i4.int4_matmul_mma_cuda.launches - before == 1):
        raise AssertionError(f"K9 after the trap children: {e:.3e}")


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
    """Every kernel of ``kernels`` launched, no plain version ran, no old
    K1 or K4 body (``OLD_MEL_BODIES``) unless ``kernels`` names it, no
    launch of K3's and K6's first body (``OLD_DECODE_BODIES``), and every
    K3/K6 launch on the sm90 body (its two arms' counts sum to the entry
    points')."""
    for name, c in counts.items():
        if (c["plain"] != 0 or (name in kernels and c["cuda"] <= 0)
                or (name in OLD_MEL_BODIES and name not in kernels
                    and c["cuda"])
                or (name in OLD_DECODE_BODIES and c["cuda"])):
            raise AssertionError(f"{name}: kernel launches {c['cuda']}, plain "
                                 f"{c['plain']} on the {path} path")
    entry = sum(counts[k]["cuda"] for k in DECODE_ENTRY)
    body = sum(counts[k]["cuda"] for k in DECODE_SM90)
    if entry != body:
        raise AssertionError(f"the {path} path made {entry} K3/K6 launches, "
                             f"{body} of them on the sm90 body")


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
    print(f"[main] K3 launches per request "
          f"{counts['decode_attention_stacked']['cuda'] / len(requests)}, on "
          f"the sm90 body {counts['decode_attention_sm90']['cuda']}, the "
          f"first body {counts['decode_attention_cuda_core']['cuda']}",
          flush=True)

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


def _forced_rows(torch, W, params, cfg, enc, tokens, p_len, suppress,
                 first_suppress):
    """Teacher-force ``tokens`` [L] through ``decode_step`` on ``enc``'s
    device: the constrained logits [L - p_len, V] that produced tokens
    p_len..L-1 (the suppressed ids, and the first-position ones, at
    ``NEG_INF``, as ``generate`` and ``beam_search`` apply them)."""
    from audax_torch.infer.decode import NEG_INF
    n = len(tokens)
    cache = W.init_kv_cache(cfg, 1, n, device=enc.device)
    xkv = W.precompute_cross_kv(params, cfg, enc)
    rows = []
    for pos in range(n - 1):
        lg, cache = W.decode_step(params, cfg, tokens[pos: pos + 1], pos,
                                  cache, xkv)
        if pos + 1 < p_len:
            continue
        lg = lg.float()
        lg[:, suppress] = NEG_INF
        if pos + 1 == p_len:
            lg[:, first_suppress] = NEG_INF
        rows.append(lg[0])
    return torch.stack(rows)


def _ws_connect(port, stream_id):
    """A WebSocket client: the RFC 6455 upgrade, checked."""
    import base64
    import os
    import socket

    from audax_torch.cli.stream_server import ws_handshake_accept
    sock = socket.create_connection(("127.0.0.1", port), timeout=300)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /ws?stream={stream_id} HTTP/1.1\r\n"
                  f"Host: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += sock.recv(4096)
    if (" 101 " not in resp.split(b"\r\n")[0].decode("latin-1") + " "
            or ws_handshake_accept(key).encode() not in resp):
        raise AssertionError(f"WebSocket upgrade refused: {resp[:200]!r}")
    return sock


def _ws_send(sock, opcode, payload):
    """One client frame, masked as RFC 6455 requires of clients."""
    import os
    import struct

    import numpy as np
    mask = os.urandom(4)
    data = np.frombuffer(payload, np.uint8)
    key = np.frombuffer((mask * (len(payload) // 4 + 1))[: len(payload)],
                        np.uint8)
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    sock.sendall(head + mask + (data ^ key).tobytes())


def decoders_phase(torch, rng, smi, device="cuda"):
    """The rest of Whisper decoding through ``Transcriber`` and the
    streaming surfaces at full width: beam search (float and int8 KV),
    best-of sampling, speculative decoding, word timestamps in the seek
    loop with the hallucination filter and energy VAD, language detection,
    ``StreamingTranscriber`` and ``serve_streaming``. Returns the launch
    counts summed over its paths. ``device`` is the card; a rehearsal on
    the CPU passes "cpu" with the configs cut down."""
    import socket
    import threading

    import numpy as np

    from audax_torch.cli.stream_server import (OP_BINARY, OP_CLOSE,
                                               OP_TEXT, read_frame,
                                               serve_streaming)
    from audax_torch.core.config import WhisperConfig
    from audax_torch.infer import align as A
    from audax_torch.infer.beam import beam_search
    from audax_torch.infer.decode import generate
    from audax_torch.infer.speculative import generate_speculative
    from audax_torch.infer.streaming import StreamingTranscriber
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches

    sr = 16000
    small, tiny = WhisperConfig.small(), WhisperConfig.tiny()
    p_small = W.init_whisper_params(small, torch.Generator().manual_seed(1),
                                    device=device)
    p_tiny = W.init_whisper_params(tiny, torch.Generator().manual_seed(2),
                                   device=device)
    cpu_small = W.tree_map(lambda t: t.cpu(), p_small)
    tok = _tokenizer()
    print(f"[decoders] {smi}: Whisper-small (d_model {small.d_model}, "
          f"{small.encoder_layers}+{small.decoder_layers} layers, vocab "
          f"{small.vocab_size}) and Whisper-tiny (d_model {tiny.d_model}) "
          f"random weights, max_new_tokens 64", flush=True)
    a30 = _speechlike(rng, 30.0)
    # a 47 s request whose last 10 s are silent
    a47 = np.concatenate([_speechlike(rng, 37.0, pitch=140.0),
                          np.zeros(10 * sr, np.float32)])
    total = {}

    def path(label, kernels, fn):
        """``fn()`` with every count set to 0 just before it and read just
        after: its kernels must launch, no plain version may."""
        sync()
        reset_launches()
        out = fn()
        sync()
        counts = launch_counts()
        print(f"[decoders] {label} launches: " + json.dumps(
            {k: c["cuda"] for k, c in counts.items() if c["cuda"]}),
            flush=True)
        _check_launches(counts, kernels, f"decoders: {label}")
        _no_core_flash(counts, f"decoders: {label}")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c["cuda"]
        return out, counts

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def request(tr, audio, label, kernels, **kw):
        res, counts = path(label, kernels,
                           lambda: tr.transcribe(audio, **kw))
        n_tok = sum(len(s.tokens or ()) for s in res.segments)
        print(f"[decoders] {label}: {len(audio) / sr:.0f} s request, "
              f"{len(res.segments)} segments, {n_tok} tokens, wall "
              f"{res.wall_seconds:.3f} s, RTF {res.rtf:.5f} ({smi})",
              flush=True)
        return res, counts

    common = dict(device=device, max_new_tokens=64,
                  temperature_fallback=False)
    # ---- beam search, float and int8 KV --------------------------------
    beam_tr = Transcriber(p_small, small, tok, beam_width=5, patience=2.0,
                          **common)
    beam_tr.warmup(batch_chunks=1)
    request(beam_tr, a30, "beam W=5 patience 2", TRANSCRIBE_KERNELS)
    q8_tr = Transcriber(p_small, small, tok, beam_width=5, patience=2.0,
                        kv_quant=True, **common)
    request(q8_tr, a30, "beam W=5 patience 2 int8 KV", DECODE_Q8_KERNELS)

    mel = beam_tr.frontend(a30[None, : beam_tr.chunk_samples])
    enc = W.encode(p_small, small, mel)
    prompt_np = beam_tr._prompt(1)
    p_len = prompt_np.shape[1]
    prompt = torch.from_numpy(prompt_np).to(device)
    kw = dict(max_len=p_len + 64, eos_id=tok.eot, suppress=beam_tr.suppress,
              first_suppress=beam_tr.first_suppress)
    greedy = generate(p_small, small, enc, prompt, **kw)
    one = beam_search(p_small, small, enc, prompt, beam_width=1, **kw)
    same = (torch.equal(one.tokens[:, 0], greedy.tokens)
            and torch.equal(one.lengths[:, 0], greedy.lengths))
    print(f"[decoders] beam_width=1 vs greedy generate on the card: "
          f"{'token for token equal' if same else 'DIFFER'} "
          f"({int(greedy.lengths[0]) - p_len} tokens)", flush=True)
    if not same:
        raise AssertionError("beam_width=1 differs from greedy generate")
    best = beam_search(p_small, small, enc, prompt, beam_width=5,
                       patience=2.0, **kw)
    n_best = int(best.lengths[0, 0])
    rows = _forced_rows(torch, W, cpu_small, small, enc.cpu(),
                        best.tokens[0, 0, :n_best].cpu(), p_len,
                        beam_tr.suppress.cpu(),
                        beam_tr.first_suppress.cpu())
    forced = float(torch.log_softmax(rows, -1).gather(
        1, best.tokens[0, 0, p_len:n_best].cpu()[:, None]).sum())
    err = abs(forced - float(best.sum_logprob[0, 0]))
    tol = 1e-3 * (n_best - p_len)
    print(f"[decoders] beam best hypothesis ({n_best - p_len} tokens) "
          f"teacher-forced on the CPU: sum_logprob "
          f"{float(best.sum_logprob[0, 0]):.5f} (card) vs {forced:.5f} "
          f"(CPU), |err| {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"beam sum_logprob off by {err:.3e}")

    # ---- best-of at t = 0.4 --------------------------------------------
    bo_tr = Transcriber(p_small, small, tok, best_of=5, temperatures=(0.4,),
                        **common)
    request(bo_tr, a30, "best_of=5 at t=0.4", TRANSCRIBE_KERNELS)
    kept = bo_tr._decode_once(enc, prompt_np, 0.4)
    hand = generate(p_small, small, enc.repeat_interleave(5, 0),
                    prompt.repeat_interleave(5, 0), temperature=0.4, **kw)
    # the Transcriber's ranker: mean logprob in float64 on the host
    score = (hand.sum_logprob.cpu().numpy()
             / np.maximum(hand.gen_count.cpu().numpy(), 1))
    pick = int(score.argmax())
    if not torch.equal(kept.tokens[0], hand.tokens[pick]):
        raise AssertionError("best-of did not keep the ranker's best sample")
    print(f"[decoders] best-of: kept sample {pick} of 5, the ranker's "
          f"maximum (avg logprob {score[pick]:.4f}; the five: "
          f"{', '.join(f'{s:.4f}' for s in score)})", flush=True)

    # ---- speculative decoding ------------------------------------------
    denc = W.encode(p_tiny, tiny, mel)
    for label, dparams, dcfg, dstate, k in (
            ("tiny -> small", p_tiny, tiny, denc, 8),
            ("small -> small", p_small, small, enc, 9)):
        spec_tr = Transcriber(p_small, small, tok, draft=(dparams, dcfg),
                              spec_tokens=k, **common)
        request(spec_tr, a30, f"speculative {label} spec_tokens {k}",
                TRANSCRIBE_KERNELS, batch_chunks=1)
        skw = dict(kw, max_len=min(p_len + 64, small.n_text_ctx - k + 1))
        sync()
        t0 = time.perf_counter()
        g = generate(p_small, small, enc, prompt, **skw)
        sync()
        t_greedy = time.perf_counter() - t0
        acc = []
        t0 = time.perf_counter()
        s = generate_speculative(dparams, p_small, dcfg, small, dstate, enc,
                                 prompt, spec_tokens=k, accepted=acc, **skw)
        sync()
        t_spec = time.perf_counter() - t0
        gt, st = g.tokens[0].tolist(), s.tokens[0].tolist()
        gl, sl = int(g.lengths[0]), int(s.lengths[0])
        diff = next((i for i in range(p_len, min(gl, sl)) if gt[i] != st[i]),
                    None)
        if diff is None and gl != sl:
            raise AssertionError(f"speculative {label}: lengths {sl} vs "
                                 f"greedy {gl}")
        note = "token for token equal"
        if diff is not None:
            rows = _forced_rows(torch, W, p_small, small, enc,
                                g.tokens[0, :diff + 1], p_len,
                                beam_tr.suppress, beam_tr.first_suppress)
            top2 = rows[diff - p_len].topk(2).values
            margin = float(top2[0] - top2[1])
            note = (f"first differs at position {diff} (greedy's top two "
                    f"logits {margin:.3e} apart, tol {TOL_SPEC_TIE:.0e})")
            if not margin < TOL_SPEC_TIE:
                raise AssertionError(f"speculative {label}: {note}")
        print(f"[decoders] speculative {label}: {sl - p_len} tokens in "
              f"{len(acc)} passes, accepted per pass {np.mean(acc):.2f} "
              f"({acc}); wall {t_spec * 1e3:.1f} ms vs greedy generate "
              f"{t_greedy * 1e3:.1f} ms; vs greedy: {note} ({smi})",
              flush=True)

    # ---- words, the seek loop, hallucination filter, VAD, clips ----------
    words_tr = Transcriber(p_small, small, tok, timestamps=True,
                           word_timestamps=True,
                           hallucination_silence_threshold=2.0,
                           seek_by_timestamps=True, vad_threshold_db=-40.0,
                           clip_timestamps="0,37,37", **common)
    windows = []
    own_silent = words_tr._is_silent

    def k3():
        c = launch_counts()
        return sum(c[name]["cuda"] for name in DECODE_ENTRY)

    def judged(chunk):
        verdict = own_silent(chunk)
        windows.append((verdict, k3()))
        return verdict

    words_tr._is_silent = judged
    res, _ = request(words_tr, a47, "words + seek loop + VAD",
                     TRANSCRIBE_KERNELS)
    after = k3()
    spent = [(v, (windows[i + 1][1] if i + 1 < len(windows) else after) - c)
             for i, (v, c) in enumerate(windows)]
    n_words = sum(len(s.words or ()) for s in res.segments)
    print(f"[decoders] seek loop: {len(spent)} windows (silent: "
          f"{sum(v for v, _ in spent)}), K3 launches per window "
          f"{[n for _, n in spent]}, {n_words} words", flush=True)
    if not any(v for v, _ in spent) or any(n for v, n in spent if v):
        raise AssertionError(f"a silent window launched K3 (or none was "
                             f"silent): {spent}")
    # one window's alignment, card against CPU on the same encoder states
    # and tokens: a sentence of the tokenizer's corpus (the random model's
    # own tokens are fillers that merge into one word)
    enc0 = W.encode(p_small, small,
                    words_tr.frontend(a47[None, : words_tr.chunk_samples]))
    ids = tok.encode(" the quick brown fox jumps over the lazy dog hello "
                     "world how are you today")
    row = [int(t) for t in words_tr._prompt(1, None, "en")[0]]
    max_len = min(len(row) + 64, small.n_text_ctx)
    toks = (row + ids + [tok.eot] * max_len)[:max_len]
    t_card = torch.tensor([toks], device=device)
    w, mass = A.cross_attention_weights(p_small, small, t_card, enc0[:1])
    w_cpu, mass_cpu = A.cross_attention_weights(cpu_small, small,
                                                t_card.cpu(), enc0[:1].cpu())
    e_w = float((w.cpu() - w_cpu).abs().max())
    e_m = float((mass.cpu() - mass_cpu).abs().max())
    sl_ = slice(len(row), len(row) + len(ids))
    wt = A.word_timings(w[0, sl_].cpu().numpy(), ids, tok,
                        mass=mass[0, sl_].cpu().numpy())
    wt_cpu = A.word_timings(w_cpu[0, sl_].numpy(), ids, tok,
                            mass=mass_cpu[0, sl_].numpy())
    off = max((max(abs(a.start - b.start), abs(a.end - b.end))
               for a, b in zip(wt, wt_cpu)), default=0.0)
    print(f"[decoders] alignment of window 0 ({len(ids)} tokens x "
          f"{w.shape[-1]} frames) card vs CPU: matrix max_abs_err "
          f"{e_w:.3e}, mass {e_m:.3e} (tol {TOL_ALIGN:.0e}); {len(wt)} "
          f"words, timings at most {off:.3f} s apart (tol "
          f"{ALIGN_FRAME_S} s)", flush=True)
    if not (e_w <= TOL_ALIGN and e_m <= TOL_ALIGN and len(wt) == len(wt_cpu)
            and [a.word for a in wt] == [b.word for b in wt_cpu]
            and off <= ALIGN_FRAME_S + 1e-9):
        raise AssertionError("the alignment differs between card and CPU")

    # ---- language detection ----------------------------------------------
    auto_tr = Transcriber(p_small, small, tok, lang="auto", **common)
    res, _ = request(auto_tr, a30, "lang='auto'", TRANSCRIBE_KERNELS)
    best_lang, probs = auto_tr.detect(a30)
    print(f"[decoders] detected language {best_lang!r} "
          f"(p {probs[best_lang]:.4f} over {len(probs)} languages)",
          flush=True)

    # ---- streaming at Whisper-tiny: 8 slots, 6 streams ------------------
    st = StreamingTranscriber(p_tiny, tiny, tok, batch_slots=8,
                              max_new_tokens=64, vad_threshold_db=-40.0,
                              device=device)
    st.warmup()
    streams = {f"s{i}": (_speechlike(rng, 60.0, pitch=100.0 + 15 * i)
                         if i != 5 else
                         (1e-4 * rng.standard_normal(60 * sr))
                         .astype(np.float32))
               for i in range(6)}
    piece = sr // 2

    def stream_all():
        direct, lat = {}, []
        for r in range(60 * sr // piece):
            for sid, x in streams.items():
                st.feed(sid, x[r * piece: (r + 1) * piece])
            if st.pending_chunks():
                t0 = time.perf_counter()
                segs = st.drain()
                sync()
                lat.append((time.perf_counter() - t0, len(segs)))
                for s in segs:
                    direct.setdefault(s.stream_id, []).append(
                        (s.index, s.text, s.audio_seconds))
        return direct, lat

    (direct, lat), _ = path("streaming", TRANSCRIBE_KERNELS, stream_all)
    silent = [sid for sid, segs in direct.items() if not any(t for _, t, _ in
                                                              segs)]
    print(f"[decoders] streaming: 6 streams x 2 windows in 0.5 s pieces, "
          f"8 slots; a window's segment {', '.join(f'{t * 1e3:.1f} ms' for t, _ in lat)} "
          f"after its last piece ({[n for _, n in lat]} segments per "
          f"batch); VAD-silent streams {silent} ({smi})", flush=True)
    if (sorted(direct) != sorted(streams) or "s5" not in silent
            or any(len(v) != 2 for v in direct.values())):
        raise AssertionError(f"streaming segments wrong: {direct}")
    for sid in streams:
        st.remove(sid)

    def websocket():
        server = serve_streaming(st, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        got, errors = {}, []

        def client(sid):
            try:
                sock = _ws_connect(server.server_address[1], "ws-" + sid)
                x = streams[sid]
                for i in range(0, len(x), piece):
                    _ws_send(sock, OP_BINARY, x[i: i + piece].astype(
                        "<f4").tobytes())
                segs = []
                while len(segs) < 2:
                    op, payload = read_frame(sock)
                    if op != OP_TEXT:
                        raise AssertionError(f"opcode {op}")
                    seg = json.loads(payload)
                    segs.append((seg["index"], seg["text"],
                                 seg["audio_seconds"]))
                _ws_send(sock, OP_CLOSE, b"\x03\xe8")
                read_frame(sock)
                sock.close()
                got[sid] = segs
            except (AssertionError, OSError, socket.timeout) as exc:
                errors.append(f"{sid}: {exc!r}")

        clients = [threading.Thread(target=client, args=(sid,))
                   for sid in ("s0", "s1")]
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        server.shutdown()
        server.server_close()
        thread.join(60)
        if errors or any(c.is_alive() for c in clients) or thread.is_alive():
            raise AssertionError(f"WebSocket clients failed: {errors}")
        return got

    t0 = time.perf_counter()
    got, _ = path("WebSocket", TRANSCRIBE_KERNELS, websocket)
    same = all(got[sid] == direct[sid] for sid in ("s0", "s1"))
    print(f"[decoders] serve_streaming: 2 WebSocket clients x 2 windows in "
          f"{time.perf_counter() - t0:.2f} s; segments "
          f"{'equal to' if same else 'DIFFER from'} the direct calls",
          flush=True)
    if not same:
        raise AssertionError(f"WebSocket segments {got} vs direct {direct}")
    return {k: {"cuda": n, "plain": 0} for k, n in total.items()}


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
              ("K3/K6 decode_cluster (sm90 body)", ("decode_cluster",)),
              ("K3/K6 decode_attn (first body)", ("decode_attn",)),
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
    profiler's own host overhead lengthens, so the share is a lower bound).
    Returns (device ms, kernel launches) a call, None where the profiler saw
    no device time."""
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
        return None
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
    return total / n / 1e3, sum(e.count for e in kernels) // n


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
    k3 = counts["decode_attention_stacked_int8"]["cuda"]
    if k3 != 2 * cfg.decoder_layers * steps or k3 != counts[
            "decode_attention_sm90_int8"]["cuda"]:
        raise AssertionError(f"K3-int8 launches {k3} (sm90 body "
                             f"{counts['decode_attention_sm90_int8']['cuda']})"
                             f" over {steps} decode steps; want "
                             f"{2 * cfg.decoder_layers} a step on the sm90 "
                             "body")
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
          f"{k6_counts['decode_attention']['cuda']} (sm90 body "
          f"{k6_counts['decode_attention_sm90_int8']['cuda']})", flush=True)
    _check_launches(k6_counts, K6_KERNELS, "attention(kv_cached=)")
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
        ran = {k: counts[k]["cuda"] for k in OLD_TOOL_BODIES
               if counts[k]["cuda"]}
        if ran:
            raise AssertionError(f"the {name} tool launched the first "
                                 f"bodies {ran}")
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


#: the music two-tower's serving path: K1's tier on the FFT body (each
#: clip's log-mel), K2's 3xTF32 body (the Whisper encoder; the scoring
#: forward's adapter cross-attention and the LM's causal GQA) and K3 on its
#: sm90 body (the LM's decode steps over its layer-stacked cache)
MUSIC_KERNELS = TRANSCRIBE_KERNELS
#: the music phase's teacher-forced scoring forward: no decode step, so no K3
MUSIC_SCORE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3")
#: the 125 ABC symbols added to the LM's vocabulary after the three
#: specials (<abc_start>, <abc_end>, <abc_pad>): 128 rows in all, room the
#: reference's resize_token_embeddings made in Qwen's vocabulary
ABC_SYMBOLS = tuple(
    [n for c in "CDEFGAB" for n in (c + ",", c, c.lower(), c.lower() + "'")]
    + [a + n for c in "CDEFGAB" for n in (c, c.lower()) for a in "^_"]
    + ["2", "3", "4", "6", "8", "/2", "/4", "3/2"]
    + ["|", "||", "|:", ":|", "|]", "[|", "::"]
    + ["z", "z2", "z4", "z8"]
    + ["X:", "T:", "M:", "L:", "K:", "Q:", "V:", "P:", "N:", "R:", "w:"]
    + ["K:C", "K:G", "K:D", "K:A", "K:E", "K:F", "K:Bb", "K:Am", "K:Em",
       "K:Dm"]
    + ["M:4/4", "M:3/4", "M:6/8", "M:2/4", "M:C|"]
    + ["L:1/8", "L:1/4", "L:1/16"]
    + ['"C"', '"G"', '"D"', '"Am"', '"Em"', '"F"', '"Dm"', '"G7"']
    + ["(3", "-", "(", ")", "{", "}", ">", "<", "~", ".", "!trill!",
       "!fermata!", "%"])
#: the music phase's token hold: the card's greedy tokens must equal the
#: CPU's argmax, position by position, up to the first position where the
#: CPU's top two (constrained) logits are closer than this -- each side may
#: be off by TOL_LOGITS, so a flip needs a gap under twice it
TOL_MUSIC_TIE = 2 * TOL_LOGITS
#: the single-clip run's teacher-forced ABC header
MUSIC_PROMPT = "X:1\nK:D\n"
#: the LM preset of ``infer-music --lm-size``: Qwen3-0.6B's published config
MUSIC_LM = "qwen3-0.6b"
#: infer-music's --max-tokens in the music phase
MUSIC_MAX_TOKENS = 64
#: the requests whose card tokens the CPU holds at full width (the --wav
#: clip and the last --wav-dir ones, admitted into slots freed mid-flight;
#: each one teacher-forced forward on the chip machine's CPU)
MUSIC_HOLD_REQUESTS = 3


def _abc_tunes(rng, n):
    """Synthetic ABC tunes: a header and eight bars of random notes."""
    notes = list("CDEFGABcdefgab")
    tunes = []
    for i in range(n):
        bars = ["".join(str(rng.choice(notes)) + str(rng.choice(["", "2"]))
                        for _ in range(4)) for _ in range(8)]
        tunes.append(f"X:{i + 1}\nT:Tune {i + 1}\n"
                     f"M:{rng.choice(['4/4', '3/4', '6/8'])}\nL:1/8\n"
                     f"K:{rng.choice(['C', 'G', 'D', 'Am'])}\n"
                     + "|".join(bars) + "|]\n")
    return tunes


def _abc_tokenizer(rng, base_vocab, tunes=None):
    """Qwen3's vocabulary layout with ABC added: a BPE trained on ABC tunes
    (``tunes``, or 64 synthetic ones), padded with never-produced filler
    tokens to ``base_vocab`` (151,936), then the three ABC specials and the
    125 ABC symbols appended by ``add_tokens`` (the constrained decoding's
    allowed set)."""
    from audax_torch.symbolic.bpe import BPE, train_bpe

    bpe = train_bpe(tunes or _abc_tunes(rng, 64), vocab_size=600)
    vocab = dict(bpe.vocab)
    for i in range(len(vocab), base_vocab):
        vocab[f"<unused{i}>"] = i
    bpe = BPE(vocab, bpe.merges)
    added = bpe.add_tokens(["<abc_start>", "<abc_end>", "<abc_pad>"]
                           + [f"<abc {s}>" for s in ABC_SYMBOLS])
    if added != 128 or len(bpe) != base_vocab + 128:
        raise AssertionError(f"ABC tokenizer: {added} added, {len(bpe)} "
                             "tokens")
    return bpe


def _music_clip(rng, seconds, sr=16000):
    """Deterministic synthetic music: a random melody of quarter-second
    harmonic notes (MIDI 55-79) with decaying envelopes, plus noise."""
    import numpy as np
    t = np.arange(int(seconds * sr)) / sr
    x = np.zeros_like(t)
    for start in np.arange(0.0, seconds, 0.25):
        f = 440.0 * 2 ** ((int(rng.integers(55, 80)) - 69) / 12)
        m = (t >= start) & (t < start + 0.25)
        tt = t[m] - start
        x[m] = np.exp(-6 * tt) * sum(np.sin(2 * np.pi * k * f * tt) / k
                                     for k in range(1, 5))
    return (0.2 * x + 0.005 * rng.standard_normal(t.shape)).astype(np.float32)


def music_phase(torch, rng, smi):
    """The music two-tower's serving path at Qwen3-0.6B + Whisper-base
    width through ``infer-music``; returns the launch counts of its three
    runs (the scoring forward, ``--wav``, ``--wav-dir``)."""
    import os
    import tempfile

    import numpy as np

    from audax_torch.cli import main as cli
    from audax_torch.core.config import TwoTowerConfig
    from audax_torch.data.audio_io import read_wav, to_mono, write_wav
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.models.causal_lm import CausalLMConfig, init_lm_cache
    from audax_torch.models.two_tower import (adapter_cross_kv,
                                              build_two_tower, two_tower_step)
    from audax_torch.models.whisper import tree_leaves, tree_map
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.train.two_tower import (TwoTowerState,
                                             load_trainable_checkpoint,
                                             save_trainable_checkpoint)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    tt = TwoTowerConfig.from_env()
    audio_cfg = cli._whisper_preset(tt.whisper_size)
    lm_cfg = cli._lm_preset(MUSIC_LM, 2048)
    bpe = _abc_tokenizer(rng, CausalLMConfig.qwen3_0_6b().vocab_size)
    vocab = len(bpe)
    allowed = bpe.added_token_ids()
    start, end = bpe.vocab["<abc_start>"], bpe.vocab["<abc_end>"]

    # the model infer-music builds (the same config, seed and device), its
    # adapter gates opened as training would, so the audio reaches the LM
    t0 = time.perf_counter()
    model = build_two_tower(tt, audio_cfg, lm_cfg, vocab,
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    lm_cfg = model.lm_cfg
    g = torch.Generator(device=dev).manual_seed(1)
    for gate in ("out", "ffn_out"):
        k = model.params["adapter"][gate]["kernel"]
        model.params["adapter"][gate]["kernel"] = torch.randn(
            k.shape, generator=g, device=dev) / math.sqrt(k.shape[0])
    sync()
    n_lm = sum(t.numel() for t in tree_leaves(model.params["lm"]))
    n_ad = sum(t.numel() for t in tree_leaves(model.params["adapter"]))
    n_audio = sum(t.numel() for t in tree_leaves(model.audio_params))
    step_bytes = 4 * (n_lm + n_ad)
    print(f"[music] {smi}: LM {MUSIC_LM} (d_model {lm_cfg.d_model}, "
          f"{lm_cfg.layers} layers, {lm_cfg.heads}q/{lm_cfg.kv_heads}kv heads "
          f"of {lm_cfg.head_dim}, ffn {lm_cfg.ffn}, qk_norm {lm_cfg.qk_norm}, "
          f"vocab {vocab} = {vocab - 128} + 128 added ABC tokens), "
          f"Whisper-{tt.whisper_size} audio tower (d_model {audio_cfg.d_model},"
          f" {audio_cfg.encoder_layers} layers), adapter {tt.adapter_heads} "
          f"heads x ffn {tt.adapter_ffn_mult}; {n_lm / 1e6:.1f} M LM + "
          f"{n_ad / 1e6:.1f} M adapter + {n_audio / 1e6:.1f} M audio params, "
          f"float32, random from seed 0, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    counts_all = []
    with tempfile.TemporaryDirectory() as d:
        # ---- trainable-only checkpoint: save, reload, bit-equal ----------
        ck = os.path.join(d, "trainable")
        t0 = time.perf_counter()
        save_trainable_checkpoint(ck, TwoTowerState(step=0,
                                                    params=model.params),
                                  model)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_trainable_checkpoint(ck, model)
        sync()
        t_load = time.perf_counter() - t0
        leaves = list(zip(tree_leaves(back.params),
                          tree_leaves(model.params)))
        same = sum(bool(torch.equal(a, b)) for a, b in leaves)
        size = sum(os.path.getsize(os.path.join(ck, f))
                   for f in os.listdir(ck))
        print(f"[music] trainable checkpoint (adapter, top "
              f"{min(tt.top_k_unfrozen_layers, lm_cfg.layers)} layers, "
              f"embeddings, norm): {size / 1e6:.1f} MB, saved in "
              f"{t_save:.2f} s, merged back in {t_load:.2f} s; "
              f"{same}/{len(leaves)} leaves bit-equal", flush=True)
        if same != len(leaves):
            raise AssertionError("the trainable checkpoint did not restore "
                                 "bit-exactly")
        del back

        # ---- one teacher-forced 64-token sequence, card against CPU ------
        clip = _music_clip(rng, 10.0)
        fe = LogMelFrontend.whisper(audio_cfg.n_mels, device=dev)
        ids = torch.tensor([[start] + [int(i) for i in rng.choice(
            allowed, 63)]], device=dev)
        sync()
        reset_launches()
        mel = fe(clip[None])
        enc = model.encode_audio(mel)
        with torch.no_grad():
            logits = model.forward(model.params, enc, ids)
        sync()
        counts = launch_counts()
        counts_all.append(counts)
        _check_launches(counts, MUSIC_SCORE_KERNELS, "music scoring")
        _no_core_flash(counts, "music scoring")
        k2 = counts["flash_forward_tf32x3"]["cuda"]
        want_k2 = audio_cfg.encoder_layers + 1 + lm_cfg.layers
        if k2 != want_k2:
            raise AssertionError(f"music scoring: {k2} K2 launches, "
                                 f"{want_k2} expected (encoder, adapter "
                                 "cross, LM causal)")
        cpu = model._replace(audio_params=tree_map(lambda t: t.cpu(),
                                                   model.audio_params),
                             params=tree_map(lambda t: t.cpu(),
                                             model.params))
        mel_cpu = LogMelFrontend.whisper(audio_cfg.n_mels,
                                         device="cpu")(clip[None])
        with torch.no_grad():
            logits_cpu = cpu.forward(cpu.params, cpu.encode_audio(mel_cpu),
                                     ids.cpu())
        e_sc = float((logits.cpu() - logits_cpu).abs().max())
        print(f"[music] scoring forward [1, 64] -> logits [1, 64, {vocab}]: "
              f"K2 launches {k2} (encoder {audio_cfg.encoder_layers}, adapter "
              f"cross q 64 x kv {enc.shape[1]}, LM causal GQA "
              f"{lm_cfg.heads}q/{lm_cfg.kv_heads}kv x {lm_cfg.layers}); card "
              f"vs CPU max_abs_err {e_sc:.3e} (tol {TOL_LOGITS:.0e}), logit "
              f"scale {float(logits_cpu.abs().max()):.3f}", flush=True)
        if not e_sc <= TOL_LOGITS:
            raise AssertionError(f"music scoring logits differ by {e_sc:.3e}")

        # ---- one decode step of four slots: its time and its launches ------
        ck4, cv4 = adapter_cross_kv(model.params["adapter"],
                                    enc.repeat(4, 1, 1), tt.adapter_heads)
        cache = init_lm_cache(lm_cfg, 4, 256, device=dev)
        pos4 = torch.tensor([0, 85, 170, 255], device=dev)
        tok4 = torch.tensor(rng.choice(allowed, 4), device=dev)

        # the served step itself (``generate``'s and ``ContinuousGenerator``'s)
        @torch.inference_mode()
        def step():
            return two_tower_step(model.params, lm_cfg, tok4, ck4, cv4, pos4,
                                  cache)[0].argmax(-1)
        step_ms = _time_ms(torch, step, reps=10)
        bound = step_bytes / HBM_BPS * 1e3
        print(f"[music] decode step, 4 slots at pos [0, 85, 170, 255] "
              f"(adapter + LM + argmax; CUDA events, host issue included): "
              f"{step_ms:.3f} ms; the weights' bytes ({step_bytes / 1e9:.3f} "
              f"GB) over HBM bound it at {bound:.3f} ms "
              f"({step_ms / bound:.1f}x) ({smi})", flush=True)
        prof = _profile(torch, step, "music decode step (4 slots)", n=3)
        if prof is None:
            raise AssertionError("music decode step: the profiler saw no "
                                 "device time, so its launches a step are "
                                 "unknown")
        step_launches = prof[1]
        del cache

        # ---- infer-music through the command line ----------------------
        tok_dir = os.path.join(d, "tok")
        bpe.save(tok_dir)
        wav = os.path.join(d, "clip.wav")
        write_wav(wav, clip, 16000)
        wav_dir = os.path.join(d, "clips")
        os.makedirs(wav_dir)
        for i, sec in enumerate((10.0, 8.5, 10.0, 6.0, 9.5, 10.0)):
            write_wav(os.path.join(wav_dir, f"clip{i}.wav"),
                      _music_clip(rng, sec), 16000)
        common = ["--tokenizer-dir", tok_dir, "--ckpt", ck, "--lm-size",
                  MUSIC_LM, "--constrained", "--temperature", "0",
                  "--max-tokens", str(MUSIC_MAX_TOKENS), "--device", "cuda"]
        runs = {}
        for label, args in (("--wav", ["--wav", wav, "--prompt",
                                       MUSIC_PROMPT]),
                            ("--wav-dir", ["--wav-dir", wav_dir, "--slots",
                                           "4"])):
            out_json = os.path.join(d, label.strip("-") + ".json")
            sync()
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["infer-music"] + args + common
                          + ["--out", out_json])
            sync()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            counts_all.append(counts)
            if rc != 0:
                raise AssertionError(f"infer-music {label} returned {rc}")
            with open(out_json) as fh:
                rec = json.load(fh)
            _check_launches(counts, MUSIC_KERNELS, f"music {label}")
            _no_core_flash(counts, f"music {label}")
            steps = rec["decode_steps"]
            k3 = counts["decode_attention_stacked"]["cuda"]
            if k3 != lm_cfg.layers * steps:
                raise AssertionError(f"infer-music {label}: {k3} K3 launches "
                                     f"for {steps} decode steps of "
                                     f"{lm_cfg.layers} layers")
            n_gen = sum(len(r["tokens"]) for r in rec["requests"])
            print(f"[music] infer-music {label} ({len(rec['requests'])} "
                  f"clips, --constrained, t = 0, max {MUSIC_MAX_TOKENS} "
                  f"tokens): wall "
                  f"{wall:.2f} s (model build and checkpoint merge "
                  f"included), generation {rec['seconds']:.2f} s, "
                  f"{steps} decode steps, {rec['seconds'] / steps * 1e3:.2f} "
                  f"ms a step (encodes and admits included), {n_gen} tokens,"
                  f" {n_gen / rec['seconds']:.1f} tokens/s; kernel launches"
                  f" a decode step {step_launches} (profiled above), K3 "
                  f"{k3 / steps:.0f} of them (one a layer); K1 "
                  f"{counts['log_mel_overlap_fft']['cuda']}"
                  f", K2 {counts['flash_forward_tf32x3']['cuda']} ({smi})",
                  flush=True)
            runs[label] = rec

        # ---- the card's tokens against the CPU, up to the first near-tie ---
        mask = torch.zeros(vocab, dtype=torch.bool)
        mask[torch.tensor(allowed + [end])] = True
        p_len = len(bpe.encode(MUSIC_PROMPT))
        fe_cpu = LogMelFrontend.whisper(audio_cfg.n_mels, device="cpu")
        # the 16-bit audio as the command line read it back
        seqs = [("--wav clip.wav", wav,
                 runs["--wav"]["requests"][0]["all_tokens"][
                     : runs["--wav"]["decode_steps"] + 1], p_len)]
        # the clips are submitted in file order over four slots, so
        # the last ones are admitted into slots that others freed
        for r in runs["--wav-dir"]["requests"][1 - MUSIC_HOLD_REQUESTS:]:
            seq = [start] + r["tokens"]
            if len(r["tokens"]) < MUSIC_MAX_TOKENS - 1:     # ended itself
                seq.append(end)
            seqs.append((f"--wav-dir {r['id']}",
                         os.path.join(wav_dir, r["id"]), seq, 0))
        t0 = time.perf_counter()
        held, ties = 0, []
        for label, path, seq, forced in seqs:
            audio = to_mono(read_wav(path)[0])
            x = np.zeros(160000, np.float32)
            x[: len(audio)] = audio[:160000]
            with torch.no_grad():
                lg = cpu.forward(cpu.params,
                                 cpu.encode_audio(fe_cpu(x[None])),
                                 torch.tensor([seq[:-1]]))[0]
            top = lg.masked_fill(~mask, float("-inf")).topk(2)
            tie = None
            for i in range(forced, len(seq) - 1):
                margin = float(top.values[i, 0] - top.values[i, 1])
                if margin < TOL_MUSIC_TIE:
                    tie = (i, margin)
                    break
                if int(top.indices[i, 0]) != seq[i + 1]:
                    raise AssertionError(
                        f"infer-music {label}: position {i + 1} token "
                        f"{seq[i + 1]} on the card, {int(top.indices[i, 0])} "
                        f"on the CPU, their top two {margin:.3e} apart")
                held += 1
            ties.append(tie)
            print(f"[music] {label}: {len(seq)} tokens, {held} held so far; "
                  + (f"first near-tie at position {tie[0] + 1} (margin "
                     f"{tie[1]:.2e} < {TOL_MUSIC_TIE:.0e})" if tie else
                     "no near-tie"), flush=True)
        print(f"[music] card tokens vs the CPU's teacher-forced argmax: "
              f"{held} positions held over {len(seqs)} requests in "
              f"{time.perf_counter() - t0:.2f} s; near-ties "
              f"{sum(t is not None for t in ties)}", flush=True)
        if held == 0:
            raise AssertionError("infer-music: no token held against the "
                                 "CPU")
    print(f"[music] phase wall {time.perf_counter() - t_phase:.2f} s ({smi})",
          flush=True)
    return counts_all


#: the music training path's kernels: the two-tower step (float32: K1, K2
#: in the frozen encoder and the adapter, K7/K8 in the adapter's backward;
#: the LM's padded attention takes the materialised twin, no kernel), the
#: note-F1 eval (K1, K2, K3) and train-lm in float32 and bf16
MUSIC_TRAIN_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                       "flash_backward_dq_tf32x3", "flash_backward_dkv_tf32x3")
LM_TRAIN_KERNELS = {"float32": ("flash_forward_tf32x3",
                                "flash_backward_dq_tf32x3",
                                "flash_backward_dkv_tf32x3"),
                    "bfloat16": ("flash_forward_wgmma",
                                 "flash_backward_dq_wgmma",
                                 "flash_backward_dkv_wgmma")}
#: the music training phase's data: 24 examples of 10 s, melodies of 14
#: events (chords of up to 3 notes) cut to the window
MUSIC_TRAIN_ITEMS = 24
#: tokens of the music_train phase's card-vs-CPU steps (two-tower and LM)
HOLD_TOKENS = 32
MUSIC_TRAIN_EVENTS = 14


class _MemoryMusic:
    """``MusicDataset``'s interface over in-memory examples (the card
    machine has no pyarrow to read the Parquet)."""

    def __init__(self, examples, tokenizer):
        from audax_torch.data.music_dataset import ABC_SPECIALS
        self.items = examples
        self.tokenizer = tokenizer
        self.start_id, self.end_id, self.pad_id = (
            tokenizer.vocab[t] for t in ABC_SPECIALS)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _music_examples(np, bpe, mfs, abcs, waves, max_tokens):
    """MusicExample rows: <abc_start> + the ABC's ids + <abc_end>, cut and
    padded to ``max_tokens`` (``MusicDataset.__getitem__``)."""
    from audax_torch.data.music_dataset import ABC_SPECIALS, MusicExample
    start, end, pad = (bpe.vocab[t] for t in ABC_SPECIALS)
    out = []
    for i, (abc, wav) in enumerate(zip(abcs, waves)):
        ids = ([start] + bpe.encode(abc, with_specials=False)
               + [end])[:max_tokens]
        mask = np.zeros(max_tokens, np.int32)
        mask[: len(ids)] = 1
        padded = np.full(max_tokens, pad, np.int32)
        padded[: len(ids)] = ids
        out.append(MusicExample(wav, 16000, padded, mask, abc,
                                f"melody_{i:03d}"))
    return out


def _grads(torch, loss_fn, params):
    """(loss, {path: gradient}) of ``loss_fn(params)`` over every leaf."""
    from audax_torch.models.whisper import tree_leaves
    leaves = tree_leaves(params)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(_paths(params), grads))


#: gradients that are zero up to rounding: the adapter's key bias adds one
#: q.b to every score of a query row, which the softmax cancels. Each side
#: holds rounding noise there, so such a leaf is held at zero (its largest
#: value within TOL_STEP_GRAD of the step's largest gradient, on both
#: sides) instead of against the other side's noise
ZERO_GRAD_LEAVES = ("adapter/k/bias",)


def _hold_grads(torch, label, loss, grads, cpu_loss, cpu_grads, keys,
                tag="music_train"):
    """The card's loss within TOL_STEP_LOSS (relative) of the CPU's and each
    gradient of ``keys`` within TOL_STEP_GRAD of the CPU leaf's largest
    value (a ``ZERO_GRAD_LEAVES`` leaf at zero); prints the worst."""
    e_loss = abs(loss - cpu_loss) / abs(cpu_loss)
    top = max(float(cpu_grads[k].float().abs().max()) for k in keys)
    worst, zero = (0.0, ""), 0.0
    for k in keys:
        g, r = grads[k].float().cpu(), cpu_grads[k].float()
        if k in ZERO_GRAD_LEAVES:
            zero = max(zero, float(g.abs().max()) / top,
                       float(r.abs().max()) / top)
            continue
        e = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        worst = max(worst, (e, k))
    print(f"[{tag}] {label} card vs CPU: loss {loss:.6f} / "
          f"{cpu_loss:.6f} (rel {e_loss:.2e}, tol {TOL_STEP_LOSS:.0e}); "
          f"{len(keys)} gradients, worst {worst[0]:.2e} of the leaf's "
          f"largest at {worst[1]} (tol {TOL_STEP_GRAD:.0e}); zero-gradient "
          f"leaves at {zero:.2e} of the largest gradient", flush=True)
    if not (e_loss <= TOL_STEP_LOSS and worst[0] <= TOL_STEP_GRAD
            and zero <= TOL_STEP_GRAD):
        raise AssertionError(f"{tag} {label}: the card is off the CPU "
                             f"path (loss {e_loss:.2e}, gradient "
                             f"{worst[0]:.2e} at {worst[1]}, zero-gradient "
                             f"leaves {zero:.2e})")


def music_train_phase(torch, rng, smi):
    """The music training path at Qwen3-0.6B + Whisper-base width:
    ``fit_two_tower`` and ``train-lm``; returns the launch counts of its
    runs (the epoch, the note eval, train-lm in float32, bf16 and remat)."""
    import os
    import tempfile

    import numpy as np

    from audax_torch.cli import main as cli
    from audax_torch.core.config import TwoTowerConfig, replace
    from audax_torch.data.synth import _random_melody, render_midi
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.models.causal_lm import (CausalLMConfig, init_causal_lm,
                                              lm_forward)
    from audax_torch.models.two_tower import build_two_tower
    from audax_torch.models.whisper import tree_leaves, tree_map
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.symbolic.abc import midi_to_abc
    from audax_torch.symbolic.bpe import train_bpe
    from audax_torch.train.lm import LMTrainConfig, fit_lm
    from audax_torch.train.seq2seq import seq2seq_loss_sum
    from audax_torch.train.two_tower import (init_two_tower_state,
                                             make_two_tower_step)
    from audax_torch.train.two_tower_loop import (collate_music,
                                                  eval_note_f1,
                                                  fit_two_tower)

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    t_phase = time.perf_counter()
    counts_all = []
    n_layers = CausalLMConfig.qwen3_0_6b().layers

    # ---- data: the ported MIDI datagen, in memory --------------------------
    t0 = time.perf_counter()
    mfs = []
    for _ in range(MUSIC_TRAIN_ITEMS):
        mf, _ = _random_melody(rng, MUSIC_TRAIN_EVENTS, 100, low=48,
                               high=84, max_poly=3)
        mfs.append(mf.cut(10.0) if mf.duration_seconds > 10.0 else mf)
    abcs = [midi_to_abc(m, title=f"melody_{i:03d}") for i, m in
            enumerate(mfs)]
    waves = [render_midi(m, 16000) for m in mfs]
    bpe = _abc_tokenizer(rng, CausalLMConfig.qwen3_0_6b().vocab_size,
                         tunes=abcs)
    tt = replace(TwoTowerConfig(), epochs=1)
    ds = _MemoryMusic(_music_examples(np, bpe, mfs, abcs, waves,
                                      tt.max_target_tokens), bpe)
    n_tok = [int(ex.attention_mask.sum()) for ex in ds.items]
    print(f"[music_train] data: {len(ds)} melodies of {MUSIC_TRAIN_EVENTS} "
          f"events (chords up to 3 notes), {min(len(w) for w in waves)}-"
          f"{max(len(w) for w in waves)} samples at 16 kHz, ABC "
          f"{min(n_tok)}-{max(n_tok)} of {tt.max_target_tokens} target "
          f"tokens, BPE {len(bpe)} tokens, in {time.perf_counter() - t0:.2f} "
          "s", flush=True)

    # ---- the model: Qwen3-0.6B + Whisper-base + the adapter ---------------
    t0 = time.perf_counter()
    audio_cfg = cli._whisper_preset(tt.whisper_size)
    model = build_two_tower(tt, audio_cfg, cli._lm_preset(MUSIC_LM, 2048),
                            len(bpe),
                            torch.Generator(device=dev).manual_seed(20),
                            device=dev)
    lm_cfg = model.lm_cfg
    g = torch.Generator(device=dev).manual_seed(21)
    for gate in ("out", "ffn_out"):      # open the gates: audio reaches the LM
        k = model.params["adapter"][gate]["kernel"]
        model.params["adapter"][gate]["kernel"] = torch.randn(
            k.shape, generator=g, device=dev) / math.sqrt(k.shape[0])
    sync()
    top_k = min(tt.top_k_unfrozen_layers, lm_cfg.layers)
    print(f"[music_train] model: LM {MUSIC_LM} ({lm_cfg.layers} layers, "
          f"{lm_cfg.heads}q/{lm_cfg.kv_heads}kv of {lm_cfg.head_dim}, vocab "
          f"{lm_cfg.vocab_size}), Whisper-{tt.whisper_size} frozen, top "
          f"{top_k} layers unfrozen, adapter lr {tt.adapter_lr} / LM lr "
          f"{tt.lm_lr}, batch {tt.batch_size}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- fit_two_tower: one epoch ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = fit_two_tower(model, ds, chunk_seconds=10.0, device=dev)
    sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    counts_all.append(counts)
    peak = peak_gib()
    _check_launches(counts, MUSIC_TRAIN_KERNELS, "music_train epoch")
    _no_core_flash(counts, "music_train epoch")
    n_val = max(1, int(len(ds) * 0.1))
    steps = (len(ds) - n_val) // tt.batch_size
    batches = steps + 1                      # the train steps + one val batch
    want = {"log_mel_overlap_fft": batches,
            "flash_forward_tf32x3": batches * (audio_cfg.encoder_layers + 1),
            "flash_backward_dq_tf32x3": steps,
            "flash_backward_dkv_tf32x3": steps}
    got = {k: counts[k]["cuda"] for k in want}
    print(f"[music_train] fit_two_tower 1 epoch ({steps} train steps at "
          f"batch {tt.batch_size} x {tt.max_target_tokens}, 1 val batch of "
          f"{n_val}): wall {wall:.2f} s, peak memory {peak:.2f} "
          f"GiB, train loss {hist['train_loss']}, val loss "
          f"{hist['val_loss']}; launches {got} (expected {want}) ({smi})",
          flush=True)
    if got != want:
        raise AssertionError(f"music_train epoch: launches {got}, expected "
                             f"{want}")
    if not all(np.isfinite(hist["train_loss"] + hist["val_loss"])):
        raise AssertionError(f"music_train epoch: loss {hist}")
    frozen = lm_cfg.layers - top_k
    same = [bool(torch.equal(a[:frozen], b[:frozen])) for a, b in zip(
        tree_leaves(state.params["lm"]["layers"]),
        tree_leaves(model.params["lm"]["layers"]))]
    moved = [not torch.equal(a[frozen:], b[frozen:]) for a, b in zip(
        tree_leaves(state.params["lm"]["layers"]),
        tree_leaves(model.params["lm"]["layers"]))]
    print(f"[music_train] frozen layers 0-{frozen - 1}: {sum(same)}/"
          f"{len(same)} stacked leaves bit-identical after the epoch; the "
          f"top {top_k} moved in {sum(moved)}/{len(moved)}", flush=True)
    if not all(same) or not any(moved):
        raise AssertionError("music_train: a frozen layer moved, or no "
                             "trainable layer did")

    # ---- eval_note_f1 on 4 examples at max_len 64 --------------------------
    fe = LogMelFrontend.whisper(audio_cfg.n_mels, device=dev)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    nf = eval_note_f1(model, state, ds, np.arange(4), fe, 10.0, max_len=64,
                      generator=torch.Generator(device=dev).manual_seed(0))
    sync()
    counts = launch_counts()
    counts_all.append(counts)
    _check_launches(counts, MUSIC_KERNELS, "music_train note eval")
    _no_core_flash(counts, "music_train note eval")
    print(f"[music_train] eval_note_f1 (4 examples, t = 0.7, max_len 64): "
          f"{nf} in {time.perf_counter() - t0:.2f} s; K1 "
          f"{counts['log_mel_overlap_fft']["cuda"]}, K2 "
          f"{counts['flash_forward_tf32x3']["cuda"]}, K3 "
          f"{counts['decode_attention_stacked']["cuda"]}", flush=True)
    del state

    # ---- two more steps, timed ---------------------------------------------
    step, _ = make_two_tower_step(model)
    st = init_two_tower_state(model)
    batch = collate_music(ds.items[:tt.batch_size], fe, 10.0)
    tokens = int(batch["attention_mask"][:, 1:].sum())
    st, m = step(st, batch)                             # warm
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(2):
        st, m = step(st, batch)
        losses.append(m["loss"])
    sync()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    counts = launch_counts()
    per_step = {k: c["cuda"] / 2 for k, c in counts.items() if c["cuda"]}
    positions = batch["input_ids"].numel()
    print(f"[music_train] two-tower step (batch {tt.batch_size} x "
          f"{tt.max_target_tokens}, float32, host clock over 2 steps after a "
          f"warm one): {step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} "
          f"target tokens/s ({tokens} non-pad a step), "
          f"{positions / step_ms * 1e3:.0f} positions/s; peak memory "
          f"{peak_gib():.2f} GiB; losses "
          f"{[round(float(x), 4) for x in losses]}; launches a step "
          f"{per_step} ({smi})", flush=True)
    del st, step, batch

    # ---- one step at batch 1 x HOLD_TOKENS, card against the CPU ------------
    t0 = time.perf_counter()
    one = _music_examples(np, bpe, mfs[:1], abcs[:1], waves[:1], HOLD_TOKENS)
    cpu = model._replace(
        audio_params=tree_map(lambda t: t.cpu(), model.audio_params),
        params=tree_map(lambda t: t.cpu(), model.params))
    fe_cpu = LogMelFrontend.whisper(audio_cfg.n_mels, device="cpu")
    res = []
    for mdl, front in ((model, fe), (cpu, fe_cpu)):
        b = collate_music(one, front, 10.0)
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          mdl.params)
        enc = mdl.encode_audio(b["mel"])
        res.append(_grads(torch, lambda p: mdl.loss(
            p, enc, b["input_ids"], b["attention_mask"]), params))
    keys = [k for k in res[0][1] if k.startswith("adapter/")
            or k.startswith("lm/layers/")]
    top = {k: v[-1] for k, v in res[0][1].items() if k.startswith("lm/layers")}
    top_cpu = {k: v[-1] for k, v in res[1][1].items()
               if k.startswith("lm/layers")}
    grads = {**res[0][1], **top}
    cpu_grads = {**res[1][1], **top_cpu}
    _hold_grads(torch, f"two-tower step (batch 1 x {HOLD_TOKENS}, in "
                f"{time.perf_counter() - t0:.1f} s; adapter and top layer)",
                res[0][0], grads, res[1][0], cpu_grads, keys)
    del res, grads, cpu_grads, top, top_cpu, cpu, model
    torch.cuda.empty_cache()

    # ---- train-lm: Qwen3-0.6B pretraining on an ABC corpus -----------------
    with tempfile.TemporaryDirectory() as d:
        corpus = os.path.join(d, "abc")
        os.makedirs(corpus)
        for i in range(320):
            mf, _ = _random_melody(rng, MUSIC_TRAIN_EVENTS, 100, low=48,
                                   high=84, max_poly=3)
            with open(os.path.join(corpus, f"t{i:04d}.abc"), "w") as fh:
                fh.write(midi_to_abc(mf, title=f"t{i:04d}"))
        texts = []
        for name in sorted(os.listdir(corpus)):
            with open(os.path.join(corpus, name)) as fh:
                texts.append(fh.read())
        lm_bpe = train_bpe(texts, 600)
        lm_bpe.save(os.path.join(d, "bpe"))
        ids = []
        for t in texts:
            ids.extend(lm_bpe.encode(t))
            ids.extend(lm_bpe.encode("\n\n"))
        ids = np.asarray(ids, np.int32)
        out_json = os.path.join(d, "lm.json")
        old = os.getcwd()
        os.chdir(d)                     # the metrics sink writes under cwd
        try:
            sync()
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["train-lm", "--corpus", corpus, "--tokenizer-dir",
                           os.path.join(d, "bpe"), "--out-dir",
                           os.path.join(d, "lm"), "--lm-size", MUSIC_LM,
                           "--steps", "3", "--batch-size", "32",
                           "--seq-len", "256", "--eval-every", "3",
                           "--out", out_json, "--device", "cuda"])
            sync()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(old)
        counts = launch_counts()
        counts_all.append(counts)
        if rc != 0:
            raise AssertionError(f"train-lm returned {rc}")
        with open(out_json) as fh:
            rec = json.load(fh)
        _check_launches(counts, LM_TRAIN_KERNELS["float32"], "train-lm")
        _no_core_flash(counts, "train-lm")
        eval_fwd = int("eval_loss" in rec["history"][-1])
        want = {"flash_forward_tf32x3": n_layers * (3 + eval_fwd),
                "flash_backward_dq_tf32x3": n_layers * 3,
                "flash_backward_dkv_tf32x3": n_layers * 3}
        got = {k: counts[k]["cuda"] for k in want}
        print(f"[music_train] train-lm --lm-size {MUSIC_LM} (3 steps at "
              f"batch 32 x 256, float32, corpus {len(ids)} tokens, vocab "
              f"{len(lm_bpe)} in Qwen3's {CausalLMConfig.qwen3_0_6b().vocab_size}"
              f"-row embedding): wall {wall:.2f} s (init, corpus encoding, "
              f"eval and checkpoint writes included), fit {rec['seconds']:.2f}"
              f" s, {rec['seconds'] / 3 * 1e3:.0f} ms a step and "
              f"{3 * 32 * 256 / rec['seconds']:.0f} tokens/s over the fit; "
              f"history {rec['history']}; launches {got} (expected {want})"
              f" ({smi})", flush=True)
        if got != want:
            raise AssertionError(f"train-lm: launches {got}, expected {want}")
    torch.cuda.empty_cache()

    lm_params = None
    for label, dtype, remat in (("bfloat16", "bfloat16", ""),
                                ("remat full", "float32", "full")):
        cfg = LMTrainConfig(warmup_steps=1, max_steps=2, batch_size=32,
                            seq_len=256, eval_every=0, dtype=dtype,
                            remat=remat)
        if lm_params is None:
            lm_params = init_causal_lm(
                CausalLMConfig.qwen3_0_6b(),
                torch.Generator(device=dev).manual_seed(22), device=dev)
        torch.cuda.reset_peak_memory_stats()
        sync()
        reset_launches()
        t0 = time.perf_counter()
        _, h = fit_lm(lm_params, CausalLMConfig.qwen3_0_6b(), cfg, ids,
                      device=dev)
        sync()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
        counts_all.append(counts)
        kernels = LM_TRAIN_KERNELS[dtype]
        _check_launches(counts, kernels, f"fit_lm {label}")
        if dtype == "float32":
            _no_core_flash(counts, f"fit_lm {label}")
        # a forward a step, one more under remat (the backward's replay),
        # and the eval's forward after the last step
        fwd = 2 * (2 if remat else 1) + int("eval_loss" in h[-1])
        want = {kernels[0]: n_layers * fwd, kernels[1]: n_layers * 2,
                kernels[2]: n_layers * 2}
        got = {k: counts[k]["cuda"] for k in want}
        print(f"[music_train] fit_lm {label} (2 steps at batch 32 x 256): "
              f"{fit_s:.2f} s, {fit_s / 2 * 1e3:.0f} ms a step (the first "
              f"and the eval included), peak memory {peak_gib():.2f} GiB, "
              f"history {h}; launches {got} (expected {want}) ({smi})",
              flush=True)
        if got != want or not np.isfinite(h[-1]["loss"]):
            raise AssertionError(f"fit_lm {label}: launches {got} (expected "
                                 f"{want}), history {h}")

    # ---- the LM step timed: float32, bf16, remat "full" --------------------
    from audax_torch.train.lm import init_lm_state, make_lm_train_step
    from audax_torch.train.lm import pack_corpus
    windows = torch.from_numpy(pack_corpus(ids, 256)[:32]).to(dev)
    for label, dtype, remat in (("float32", "float32", ""),
                                ("bfloat16", "bfloat16", ""),
                                ("remat full", "float32", "full")):
        cfg = LMTrainConfig(warmup_steps=1, max_steps=4, batch_size=32,
                            seq_len=256, dtype=dtype, remat=remat)
        lm_step = make_lm_train_step(CausalLMConfig.qwen3_0_6b(), cfg)
        st = init_lm_state(tree_map(lambda t: t.detach().clone(),
                                    lm_params), cfg)
        st, m = lm_step(st, windows)                    # warm
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(2):
            st, m = lm_step(st, windows)
            losses.append(m["loss"])
        sync()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        counts = launch_counts()
        per_step = {k: c["cuda"] / 2 for k, c in counts.items() if c["cuda"]}
        print(f"[music_train] LM step {label} (batch 32 x 256, host clock "
              f"over 2 steps after a warm one): {ms:.1f} ms, "
              f"{32 * 256 / ms * 1e3:.0f} tokens/s; peak memory "
              f"{peak_gib():.2f} GiB; losses "
              f"{[round(float(x), 4) for x in losses]}; launches a step "
              f"{per_step} ({smi})", flush=True)
        del st, lm_step
        torch.cuda.empty_cache()

    # ---- one float32 LM step at batch 1 x HOLD_TOKENS, card against the CPU
    t0 = time.perf_counter()
    w = torch.from_numpy(ids[: HOLD_TOKENS + 1][None].astype(np.int64))
    cfg = CausalLMConfig.qwen3_0_6b()
    res = []
    for params in (lm_params, tree_map(lambda t: t.cpu(), lm_params)):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        ww = w.to(next(iter(tree_leaves(p))).device)

        def loss_fn(q, ww=ww):
            total, count = seq2seq_loss_sum(
                lm_forward(q, cfg, ww[:, :-1]).float(), ww[:, 1:])
            return total / count
        res.append(_grads(torch, loss_fn, p))
    _hold_grads(torch, f"LM step (batch 1 x {HOLD_TOKENS}, in "
                f"{time.perf_counter() - t0:.1f} s; every gradient)",
                res[0][0], res[0][1], res[1][0], res[1][1], list(res[0][1]))
    del res, lm_params
    torch.cuda.empty_cache()
    print(f"[music_train] phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return counts_all


#: the MoE phases' model: Qwen3-30B-A3B's published widths, its depth cut
#: (48 layers) to fit the run's time: 4 layers served, 2 trained
MOE_SERVE_LAYERS = 4
MOE_TRAIN_LAYERS = 2
MOE_SLOTS = 4
MOE_CLIPS = 6
MOE_TOKENS = 64
#: the MoE serving path's kernels: K1 (FFT body) and K2 (3xTF32) at admit,
#: K3 (sm90 body) and K9 (tensor-core body: q/k/v/o, the selected experts,
#: the untied lm_head) every decode step
MOE_SERVE_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                     "decode_attention_stacked", "decode_attention_sm90",
                     "int4_matmul_mma")


def moe_serve_phase(torch, rng, smi):
    """The two-tower with an MoE decoder at Qwen3-30B-A3B's widths (4 of 48
    layers, int4 LM) served by ``ContinuousGenerator``; returns the launch
    counts of the run."""
    import dataclasses

    from audax_torch.cli import main as cli
    from audax_torch.core.config import TwoTowerConfig
    from audax_torch.infer.continuous import ContinuousGenerator
    from audax_torch.models import causal_lm as CL
    from audax_torch.models.quantize import quantize_tree, tree_bytes
    from audax_torch.models.two_tower import (adapter_cross_kv,
                                              build_two_tower,
                                              two_tower_step)
    from audax_torch.models.whisper import layer_params, tree_map
    from audax_torch.ops import launch_counts, reset_launches

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    tt = TwoTowerConfig()
    audio_cfg = cli._whisper_preset(tt.whisper_size)
    base = CL.CausalLMConfig.qwen3_30b_a3b()
    vocab = base.vocab_size + 128
    t0 = time.perf_counter()
    model = build_two_tower(tt, audio_cfg, dataclasses.replace(
        base, layers=MOE_SERVE_LAYERS), vocab,
        torch.Generator(device=dev).manual_seed(30), device=dev)
    lm_cfg = model.lm_cfg
    g = torch.Generator(device=dev).manual_seed(31)
    for gate in ("out", "ffn_out"):      # open the gates: audio reaches the LM
        k = model.params["adapter"][gate]["kernel"]
        model.params["adapter"][gate]["kernel"] = torch.randn(
            k.shape, generator=g, device=dev) / math.sqrt(k.shape[0])
    f32_bytes = tree_bytes(model.params["lm"])
    q_lm = quantize_tree(model.params["lm"], bits=4)
    model = model._replace(params={"adapter": model.params["adapter"],
                                   "lm": q_lm})
    torch.cuda.empty_cache()
    sync()
    ex = q_lm["layers"]["experts"]
    print(f"[moe] {smi}: LM Qwen3-30B-A3B widths (d_model {lm_cfg.d_model}, "
          f"{lm_cfg.layers} of {base.layers} layers, {lm_cfg.heads}q/"
          f"{lm_cfg.kv_heads}kv of {lm_cfg.head_dim}, {lm_cfg.num_experts} "
          f"experts of {lm_cfg.moe_ffn}, top {lm_cfg.experts_per_tok} "
          f"renormalised, untied head, vocab {vocab} = {base.vocab_size} + "
          f"128), int4 by quantize_tree (experts {tuple(ex['gate']['kernel_q4'].shape)}"
          f" packed, the router float): {f32_bytes / 1e9:.2f} GB float32 -> "
          f"{tree_bytes(q_lm) / 1e9:.2f} GB; Whisper-{tt.whisper_size} tower,"
          f" adapter {tt.adapter_heads} heads; built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- (a) the MoE blocks of a decode step: no host synchronisation ------
    x = torch.randn(MOE_SLOTS, 1, lm_cfg.d_model, device=dev, generator=g)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for li in range(lm_cfg.layers):
            CL._moe_block(layer_params(q_lm["layers"], li), lm_cfg, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    print(f"[moe] the MoE blocks of a {MOE_SLOTS}-slot decode step ("
          f"{lm_cfg.layers} layers x {MOE_SLOTS * lm_cfg.experts_per_tok} "
          "selected slots, K9 with device expert ids) ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host read", flush=True)

    # ---- (b) one decode step: K9's launches, time and profile --------------
    enc = model.encode_audio(torch.randn(1, 1000, audio_cfg.n_mels,
                                         device=dev, generator=g))
    ck4, cv4 = adapter_cross_kv(model.params["adapter"],
                                enc.repeat(MOE_SLOTS, 1, 1), tt.adapter_heads)
    cache = CL.init_lm_cache(lm_cfg, MOE_SLOTS, MOE_TOKENS + 1, device=dev)
    pos4 = torch.tensor([0, 9, 30, 63], device=dev)
    tok4 = torch.tensor([base.vocab_size + 3 * i for i in range(4)],
                        device=dev)

    @torch.inference_mode()
    def step():
        return two_tower_step(model.params, lm_cfg, tok4, ck4, cv4, pos4,
                              cache)[0].argmax(-1)
    sync()
    reset_launches()
    step()
    sync()
    counts = launch_counts()
    k9 = counts["int4_matmul_mma"]["cuda"]
    # the selected scan's gate, up and down for each of a layer's slots x
    # top-k, the four attention projections a layer, the untied lm_head
    want = (lm_cfg.layers * MOE_SLOTS * lm_cfg.experts_per_tok * 3
            + lm_cfg.layers * 4 + 1)
    if k9 != want or counts["int4_matmul"]["cuda"]:
        raise AssertionError(f"moe decode step: {k9} K9 launches (split-half"
                             f" {counts['int4_matmul']['cuda']}), {want} "
                             "predicted")
    step_ms = _time_ms(torch, step, reps=5)
    prof = _profile(torch, step, f"moe decode step ({MOE_SLOTS} slots)", n=3)
    if prof is None:
        raise AssertionError("moe decode step: the profiler saw no device "
                             "time")
    print(f"[moe] decode step, {MOE_SLOTS} slots (adapter + LM + argmax): "
          f"host {step_ms:.3f} ms (CUDA events, host issue included), device"
          f" {prof[0]:.3f} ms, {prof[1]} kernel launches; K9 {k9} (predicted"
          f" {lm_cfg.layers} x {MOE_SLOTS} x {lm_cfg.experts_per_tok} x 3 + "
          f"{lm_cfg.layers} x 4 + 1 = {want}), K3 "
          f"{counts['decode_attention_stacked']['cuda']} ({smi})", flush=True)
    del cache, ck4, cv4

    # ---- (c) a 1-layer copy: one decode step, card against the CPU ---------
    cfg1 = dataclasses.replace(lm_cfg, layers=1)
    one = dict(q_lm)
    one["layers"] = tree_map(lambda t: t[:1], q_lm["layers"])
    emb = torch.randn(MOE_SLOTS, lm_cfg.d_model, device=dev, generator=g)
    pos = torch.tensor([0, 5, 17, 40], device=dev)
    cache = CL.init_lm_cache(cfg1, MOE_SLOTS, 48, device=dev)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    one_cpu = tree_map(lambda t: t.cpu(), one)
    cache_cpu = CL.LMKVCache(cache.k.cpu(), cache.v.cpu())
    routed = []
    orig = CL._moe_router

    def recording(*a, **kw):
        out = orig(*a, **kw)
        routed.append(out)
        return out
    CL._moe_router = recording
    try:
        t0 = time.perf_counter()
        logits, _ = CL.lm_decode_step(one, cfg1, emb, pos, cache)
        logits_cpu, _ = CL.lm_decode_step(one_cpu, cfg1, emb.cpu(),
                                          pos.cpu(), cache_cpu)
        t_cpu = time.perf_counter() - t0
    finally:
        CL._moe_router = orig
    (_, ids, _), (_, ids_cpu, rl_cpu) = routed
    probs = torch.softmax(rl_cpu.float(), -1)
    top = probs.topk(cfg1.experts_per_tok + 1, -1).values
    margin = float((top[:, -2] - top[:, -1]).min())
    e = float((logits.cpu() - logits_cpu).abs().max()) / float(
        logits_cpu.abs().max())
    same = bool(torch.equal(ids.cpu(), ids_cpu))
    print(f"[moe] 1-layer copy, one decode step at pos [0, 5, 17, 40], card "
          f"vs CPU ({t_cpu:.1f} s): selected experts equal {same} (smallest "
          f"k-th to (k+1)-th router probability gap {margin:.3e}); logits "
          f"max rel err {e:.3e} (tol {TOL_INT4_F32:.0e})", flush=True)
    if not (same and e <= TOL_INT4_F32):
        raise AssertionError(f"moe 1-layer step: experts equal {same}, "
                             f"logits {e:.3e} off the CPU")
    del one, one_cpu, cache, cache_cpu, routed

    # ---- ContinuousGenerator: six 10 s clips over four slots ---------------
    clips = {f"clip{i}": _music_clip(rng, 10.0) for i in range(MOE_CLIPS)}
    gen = ContinuousGenerator(model, start_id=base.vocab_size,
                              end_id=base.vocab_size + 1, slots=MOE_SLOTS,
                              window_seconds=10.0,
                              max_new_tokens=MOE_TOKENS, temperature=0.0,
                              device=dev)
    for rid, clip in clips.items():
        gen.submit(rid, clip)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    results = gen.run()
    sync()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    _check_launches(counts, MOE_SERVE_KERNELS, "moe serving")
    _no_core_flash(counts, "moe serving")
    steps = gen.decode_steps
    k9 = counts["int4_matmul_mma"]["cuda"]
    k3 = counts["decode_attention_stacked"]["cuda"]
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[moe] ContinuousGenerator ({MOE_CLIPS} clips of 10 s, "
          f"{MOE_SLOTS} slots, t = 0, {MOE_TOKENS} tokens): wall "
          f"{wall:.2f} s, {steps} decode steps, {wall / steps * 1e3:.2f} ms a"
          f" step (admits included), {n_tok} tokens, {n_tok / wall:.1f} "
          f"tokens/s; K9 {k9} = {k9 / steps:.1f} a step, K3 {k3}, K1 "
          f"{counts['log_mel_overlap_fft']['cuda']}, K2 "
          f"{counts['flash_forward_tf32x3']['cuda']} ({smi})", flush=True)
    if (len(results) != MOE_CLIPS or k9 != want * steps
            or k3 != lm_cfg.layers * steps):
        raise AssertionError(f"moe serving: {len(results)} results, K9 "
                             f"{k9} for {steps} steps (want {want} a step), "
                             f"K3 {k3}")
    del gen, model, q_lm
    torch.cuda.empty_cache()
    print(f"[moe] serving phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return [counts]


def moe_train_phase(torch, rng, smi):
    """``fit_lm`` at Qwen3-30B-A3B's widths (2 of 48 layers) with the aux
    loss, a 1-layer step against the CPU, and ``dense`` against ``ragged``;
    returns the launch counts of the fit."""
    import dataclasses

    import numpy as np

    from audax_torch.models import causal_lm as CL
    from audax_torch.models.whisper import layer_params, tree_map
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.train.lm import LMTrainConfig, fit_lm
    from audax_torch.train.seq2seq import seq2seq_loss_sum

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CL.CausalLMConfig.qwen3_30b_a3b(),
                              layers=MOE_TRAIN_LAYERS)
    params = CL.init_causal_lm(cfg, torch.Generator(device=dev).manual_seed(
        32), device=dev)
    ids = rng.integers(0, cfg.vocab_size, 4 * 256 * 2 + 1).astype(np.int32)
    tc = LMTrainConfig(warmup_steps=1, max_steps=2, batch_size=4,
                       seq_len=256, eval_every=0, eval_windows=0,
                       dtype="bfloat16", aux_loss_coef=0.001,
                       moment_dtype="float32")

    # ---- dense against ragged: one layer's forward on the card -------------
    layer0 = layer_params(params["layers"], 0)
    x = torch.randn(1, 64, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(33))
    with torch.no_grad():
        ragged = CL._moe_block(layer0, cfg, x)
        dense = CL._moe_block(layer0, dataclasses.replace(
            cfg, moe_impl="dense"), x)
    e = float((ragged - dense).abs().max())
    print(f"[moe] one MoE layer [1, 64, {cfg.d_model}] f32, dense vs ragged "
          f"on the card: max_abs_err {e:.3e} (tol {TOL_F32:.0e}), output "
          f"scale {float(ragged.abs().max()):.3f}", flush=True)
    if not e <= TOL_F32:
        raise AssertionError(f"moe dense vs ragged: {e:.3e}")

    # ---- a float32 step of a 1-layer copy at batch 1 x 64, card vs CPU -----
    t0 = time.perf_counter()
    cfg1 = dataclasses.replace(cfg, layers=1)
    one = dict(params)
    one["layers"] = tree_map(lambda t: t[:1], params["layers"])
    w = torch.from_numpy(ids[:65][None].astype(np.int64))
    res, aux = [], []
    for p0 in (one, tree_map(lambda t: t.cpu(), one)):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
        ww = w.to(p["embed"].device)

        def loss_fn(q, ww=ww):
            logits, rl = CL.lm_forward(q, cfg1, ww[:, :-1],
                                       return_router_logits=True)
            total, count = seq2seq_loss_sum(logits.float(), ww[:, 1:])
            a = CL.load_balance_loss(rl, cfg1.num_experts,
                                     cfg1.experts_per_tok)
            aux.append(float(a.detach()))
            return total / count + tc.aux_loss_coef * a
        res.append(_grads(torch, loss_fn, p))
        del p
    router = float(res[0][1]["layers/router/kernel"].abs().max())
    print(f"[moe] aux term {aux[0]:.6f} (card) / {aux[1]:.6f} (CPU); the "
          f"router's largest gradient {router:.3e}", flush=True)
    if not (np.isfinite(aux).all() and router > 0):
        raise AssertionError(f"moe step: aux {aux}, router gradient {router}")
    _hold_grads(torch, f"MoE LM step (1 layer, batch 1 x 64, float32, in "
                f"{time.perf_counter() - t0:.1f} s; every gradient)",
                res[0][0], res[0][1], res[1][0], res[1][1], list(res[0][1]),
                tag="moe")
    del res, one, layer0, ragged, dense, x

    # ---- fit_lm: the originals and the trained copy on the card, float32
    # Adam moments (the update works leaf by leaf, in place) -------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    t0 = time.perf_counter()
    _, hist = fit_lm(params, cfg, tc, ids, device=dev)
    sync()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    kernels = LM_TRAIN_KERNELS["bfloat16"]
    _check_launches(counts, kernels, "moe fit_lm")
    want = {k: cfg.layers * 2 for k in kernels}
    got = {k: counts[k]["cuda"] for k in kernels}
    print(f"[moe] fit_lm Qwen3-30B-A3B widths ({cfg.layers} of 48 layers, "
          f"ragged, aux 0.001; 2 steps at batch 4 x 256, bf16 over float32 "
          f"masters, float32 Adam moments, the originals on the card): "
          f"{fit_s:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, history "
          f"{hist}; launches {got} (expected {want}) ({smi})", flush=True)
    if got != want or not np.isfinite(hist[-1]["loss"]):
        raise AssertionError(f"moe fit_lm: launches {got} (expected {want}),"
                             f" history {hist}")

    del params
    torch.cuda.empty_cache()
    print(f"[moe] training phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return [counts]


def moe_probe_phase(torch):
    """``audax_torch.tools.moe_decode_probe`` on the card: every arm at n
    1 and 4 beside its floor; K9's tensor-core body must serve the int4 arm
    and no plain version may run."""
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.tools import moe_decode_probe as MP

    t0 = time.perf_counter()
    reset_launches()
    rep = MP.main(device="cuda")
    counts = launch_counts()
    plain = {k: c["plain"] for k, c in counts.items() if c["plain"]}
    k9 = counts["int4_matmul_mma"]["cuda"]
    rows = "; ".join(f"{r['arm']} n={r['n']} {r['us']:.1f} us (floor "
                     f"{r['floor_us']:.1f})" for r in rep["rows"])
    print(f"[moe_probe] {rep['device']}: {rows}; {rep['verdict']}; K9 "
          f"launches {k9}, in {time.perf_counter() - t0:.1f} s", flush=True)
    if plain or not k9 or counts["int4_matmul"]["cuda"]:
        raise AssertionError(f"moe probe: K9 {k9}, split-half "
                             f"{counts['int4_matmul']['cuda']}, plain {plain}")
    return rep


#: the cli phase's commands and the kernels each must launch
CLI_TRANSCRIBE_KERNELS = TRANSCRIBE_KERNELS + ("int4_matmul_mma",)
CLI_TRAIN_KERNELS = ("log_mel_overlap_fft", "flash_forward_tf32x3",
                     "flash_backward_dq_tf32x3", "flash_backward_dkv_tf32x3")
CLI_STREAM_KERNELS = ("log_mel_overlap_fft", "flash_forward_wgmma",
                      "decode_attention_stacked", "decode_attention_sm90")
#: synthetic UrbanSound clips a fold for the classifier commands (cut from
#: UrbanSound8K's ~873) and their epochs (cut from 20)
CLI_PER_FOLD = 20
CLI_EPOCHS = "2"


def _same_tree(torch, label, got, want):
    from audax_torch.models.whisper import tree_leaves
    g, w = (dict(zip(_paths(t), tree_leaves(t))) for t in (got, want))
    bad = sorted(set(g) ^ set(w)) or [
        k for k in w if not (g[k].dtype == w[k].dtype
                             and torch.equal(g[k], w[k].to(g[k].device)))]
    print(f"[cli] {label}: {len(w)} tensors, "
          f"{'bit-equal' if not bad else 'DIFFER at ' + ', '.join(bad[:5])}",
          flush=True)
    if bad:
        raise AssertionError(f"{label}: {bad[:10]}")


def _run_cli(torch, argv, kernels, label):
    """``cli.main(argv)`` with the counts set to 0 just before it and read
    just after; (seconds, counts). Fails on a non-zero exit or where a
    kernel of ``kernels`` did not launch or a plain version ran."""
    from audax_torch.cli import main as cli
    from audax_torch.ops import launch_counts, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if rc != 0:
        raise AssertionError(f"{label}: exit {rc}")
    _check_launches(counts, kernels, label)
    _no_core_flash(counts, label)
    ran = {k: c["cuda"] for k, c in counts.items() if c["cuda"]}
    print(f"[cli] {label}: {seconds:.2f} s; launches {ran}", flush=True)
    return seconds, counts


def _serve_cli(torch, module, attr, argv, label, client, kernels):
    """A server command on a thread (its server taken from ``module.attr``
    as it is made), ``client(server)`` against it, then shut down; the
    counts of the run from 0, and what ``client`` returned."""
    import threading

    from audax_torch.cli import main as cli
    from audax_torch.ops import launch_counts, reset_launches

    box, real = {}, getattr(module, attr)

    def capture(*a, **k):
        box["server"] = real(*a, **k)
        return box["server"]
    setattr(module, attr, capture)
    torch.cuda.synchronize()
    reset_launches()
    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", cli.main(argv)), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        while "server" not in box:
            if not thread.is_alive() or time.perf_counter() - t0 > 600:
                raise AssertionError(f"{label}: the server did not start "
                                     f"({box})")
            time.sleep(0.05)
        up = time.perf_counter() - t0
        out = client(box["server"])
    finally:
        setattr(module, attr, real)
        if "server" in box:
            box["server"].shutdown()
        thread.join(timeout=120)
    torch.cuda.synchronize()
    counts = launch_counts()
    if thread.is_alive() or box.get("rc") != 0:
        raise AssertionError(f"{label}: exit {box.get('rc')}, thread alive "
                             f"{thread.is_alive()}")
    _check_launches(counts, kernels, label)
    ran = {k: c["cuda"] for k, c in counts.items() if c["cuda"]}
    print(f"[cli] {label}: up (model load + warmup) in {up:.2f} s; "
          f"launches {ran}", flush=True)
    return counts, out


def cli_phase(torch, rng, smi):
    """The Whisper and classifier commands through
    ``audax_torch.cli.main.main([...])`` in-process, on the card (a
    temporary working directory): ``export-hf`` -> ``convert-hf`` round
    trips at Whisper-large-v3-turbo and Qwen3-0.6B width (bit-exact; with
    ``--quantize int4`` equal to ``quantize_tree``), ``transcribe`` and
    ``serve --kv-quant`` on the int4 checkpoint (held against in-process
    Transcribers), ``finetune`` (full and LoRA) at Whisper-base read back
    by ``export-hf`` (and the full one by ``transcribe --ckpt``),
    ``detect-language`` and ``stream-serve`` at Whisper-base, and the
    classifier commands on a
    synthetic UrbanSound stand-in (no PNG: the card machine has no
    matplotlib). Returns the launch counts of every command."""
    import csv
    import dataclasses
    import os
    import tempfile
    import threading

    import numpy as np

    from audax_torch.cli import http_server, stream_server
    from audax_torch.core.config import WhisperConfig
    from audax_torch.data.audio_io import read_wav, write_wav
    from audax_torch.data.synth import make_synthetic_urbansound
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.models import causal_lm as CL
    from audax_torch.models import whisper as W
    from audax_torch.models.quantize import quantize_tree
    from audax_torch.symbolic.bpe import BPE
    from audax_torch.symbolic.tokenizer import WhisperTokenizer
    from audax_torch.train.checkpoints import load_pytree, save_pytree

    t_phase = time.perf_counter()
    all_counts = []
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            all_counts += _cli_round_trips(torch, d, smi, W, CL, WhisperConfig,
                                           save_pytree, load_pytree,
                                           quantize_tree, dataclasses)
            tokdir = os.path.join(d, "tok")
            _tokenizer(51866).bpe.save(tokdir)
            wavs = []
            for i in range(2):
                wavs.append(os.path.join(d, f"clip{i}.wav"))
                write_wav(wavs[-1], _speechlike(rng, 30.0,
                                                pitch=110.0 + 20 * i), 16000)
            cfg = WhisperConfig.large_v3_turbo()
            q4 = os.path.join(d, "turbo_int4")
            tok = WhisperTokenizer.for_vocab_size(BPE.load(tokdir),
                                                  cfg.vocab_size)
            qparams = W.tree_map(lambda t: t.cuda(), load_pytree(q4))

            # ---- transcribe, against an in-process Transcriber -----------
            out_csv = os.path.join(d, "turbo.csv")
            secs, counts = _run_cli(
                torch, ["transcribe", wavs[0], "--size", "large-v3-turbo",
                        "--ckpt", q4, "--tokenizer-dir", tokdir,
                        "--csv", out_csv], CLI_TRANSCRIBE_KERNELS,
                "transcribe --size large-v3-turbo --ckpt <int4> (one 30 s "
                "WAV)")
            all_counts.append(counts)
            with open(out_csv, newline="") as fh:
                rows = {r["file"]: r for r in csv.DictReader(fh)}
            tr = Transcriber(qparams, cfg, tok, best_of=5, device="cuda")
            for w in wavs[:1]:
                res = tr.transcribe(read_wav(w)[0])
                row = rows[os.path.basename(w)]
                print(f"[cli] transcribe {os.path.basename(w)}: CLI RTF "
                      f"{row['rtf']}, in-process RTF {res.rtf:.5f}, "
                      f"{len(res.text)} characters, temperatures "
                      f"{[s.temperature for s in res.segments]}, equal text "
                      f"{row['text'] == res.text} ({smi})", flush=True)
                if "error" in row and row["error"] or row["text"] != res.text:
                    raise AssertionError(f"transcribe {w}: CSV {row!r} vs "
                                         f"{res.text!r}")
            print(f"[cli] transcribe: {secs:.2f} s for 30 s of audio, RTF "
                  f"{secs / 30.0:.5f} with model load ({smi})", flush=True)

            # ---- serve --kv-quant, against a Transcriber at t = 0 --------
            bodies = []
            for w in wavs:
                with open(w, "rb") as fh:
                    bodies.append(fh.read())

            def clients(server):
                port = server.server_address[1]
                res, lock = {}, threading.Lock()

                def one(i):
                    r = _post_wav(port, bodies[i])
                    with lock:
                        res[i] = r
                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(len(bodies))]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                return res, time.perf_counter() - t0

            counts, (answers, wall) = _serve_cli(
                torch, http_server, "serve_http",
                ["serve", "--size", "large-v3-turbo", "--ckpt", q4,
                 "--tokenizer-dir", tokdir, "--kv-quant", "--port", "0",
                 "--slots", "4", "--dtype", "float32", "--suppress-blank"],
                "serve --kv-quant --ckpt <int4>", clients, SERVE_KERNELS)
            all_counts.append(counts)
            ref = Transcriber(qparams, cfg, tok, kv_quant=True,
                              temperature_fallback=False,
                              no_speech_threshold=None, device="cuda")
            for i, w in enumerate(wavs):
                code, body, sec = answers.get(i, (None, {}, 0.0))
                want = ref.transcribe(read_wav(w)[0]).text
                print(f"[cli] serve request {i}: HTTP {code} in {sec:.2f} s "
                      f"({len(body.get('tokens', []))} tokens), equal to "
                      f"the t = 0 Transcriber {body.get('text') == want} "
                      f"({smi})", flush=True)
                if code != 200 or body.get("text") != want:
                    raise AssertionError(f"serve request {i}: {code} "
                                         f"{body!r} vs {want!r}")
            print(f"[cli] serve: two concurrent 30 s requests answered in "
                  f"{wall:.2f} s ({smi})", flush=True)
            del qparams, tr, ref
            torch.cuda.empty_cache()
            all_counts += _cli_base(torch, d, rng, wavs, tokdir, smi,
                                    stream_server)
            all_counts += _cli_classifiers(torch, d, smi,
                                           make_synthetic_urbansound)
        finally:
            os.chdir(home)
    print(f"[cli] phase wall {time.perf_counter() - t_phase:.2f} s ({smi})",
          flush=True)
    return all_counts


def _cli_round_trips(torch, d, smi, W, CL, WhisperConfig, save_pytree,
                     load_pytree, quantize_tree, dataclasses):
    """``export-hf`` -> ``convert-hf`` at Whisper-large-v3-turbo (float and
    ``--quantize int4``) and Qwen3-0.6B (``--kind causal-lm``), host I/O
    only; the int4 checkpoint stays in ``d`` for the commands after."""
    import os

    from audax_torch.cli import main as cli

    def gb(path):
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(path) for f in fs) / 1e9

    for kind, make in (
            ("whisper", lambda: (WhisperConfig.large_v3_turbo(), lambda c: (
                W.init_whisper_params(c, torch.Generator().manual_seed(22),
                                      device="cpu")))),
            ("causal-lm", lambda: (CL.CausalLMConfig.qwen3_0_6b(), lambda c: (
                CL.init_causal_lm(c, torch.Generator().manual_seed(23),
                                  device="cpu"))))):
        cfg, init = make()
        t0 = time.perf_counter()
        params = init(cfg)
        name = "turbo" if kind == "whisper" else "qwen3"
        ckpt, hf = os.path.join(d, name), os.path.join(d, name + "_hf")
        save_pytree(ckpt, params)
        with open(ckpt + ".config.json", "w") as fh:
            json.dump(dataclasses.asdict(cfg), fh)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cli.main(["export-hf", "--ckpt", ckpt, "--out", hf,
                     "--kind", kind]) != 0:
            raise AssertionError(f"export-hf {kind}")
        t_exp = time.perf_counter() - t0
        back = os.path.join(d, name + "_back")
        t0 = time.perf_counter()
        if cli.main(["convert-hf", "--hf-dir", hf, "--out", back,
                     "--kind", kind]) != 0:
            raise AssertionError(f"convert-hf {kind}")
        t_conv = time.perf_counter() - t0
        size = gb(hf)
        n = sum(t.numel() for t in W.tree_leaves(params))
        print(f"[cli] {kind} {name} ({n / 1e6:.1f} M params): checkpoint "
              f"made in {setup:.2f} s; export-hf {t_exp:.2f} s "
              f"({gb(ckpt):.3f} GB read, {size:.3f} GB of "
              f"safetensors written, {size / t_exp:.3f} GB/s); convert-hf "
              f"{t_conv:.2f} s ({size / t_conv:.3f} GB/s of safetensors read)"
              f" ({smi})", flush=True)
        _same_tree(torch, f"{kind} export-hf -> convert-hf round trip",
                   load_pytree(back), params)
        if kind == "whisper":
            q4 = os.path.join(d, "turbo_int4")
            t0 = time.perf_counter()
            if cli.main(["convert-hf", "--hf-dir", hf, "--out", q4,
                         "--quantize", "int4"]) != 0:
                raise AssertionError("convert-hf --quantize int4")
            print(f"[cli] convert-hf --quantize int4: "
                  f"{time.perf_counter() - t0:.2f} s, {gb(q4):.3f} GB "
                  f"({smi})", flush=True)
            _same_tree(torch, "convert-hf --quantize int4 vs quantize_tree",
                       load_pytree(q4), quantize_tree(params, bits=4))
        del params
    return []


def _cli_base(torch, d, rng, wavs, tokdir, smi, stream_server):
    """``finetune`` (full and LoRA), ``transcribe --ckpt``, ``export-hf``,
    ``detect-language`` and ``stream-serve`` at Whisper-base."""
    import os
    import struct

    from audax_torch.cli.stream_server import OP_TEXT, read_frame
    from audax_torch.data.audio_io import read_wav, write_wav

    out = []
    ftdir = os.path.join(d, "ft_audio")
    os.makedirs(ftdir)
    for i in range(4):
        write_wav(os.path.join(ftdir, f"u{i}.wav"),
                  _speechlike(rng, 8.0, pitch=100.0 + 15 * i), 16000)
    for rank in ("0", "8"):
        ck = os.path.join(d, f"base_ft_r{rank}")
        label = f"finetune --size base --lora-rank {rank} (3 steps, B 4)"
        _, counts = _run_cli(torch, [
            "finetune", "--audio-dir", ftdir, "--transcript",
            "hello world how are you", "--size", "base", "--tokenizer-dir",
            tokdir, "--out", ck, "--steps", "3", "--batch-size", "4",
            "--lora-rank", rank], CLI_TRAIN_KERNELS, label)
        out.append(counts)
        if rank == "0":
            csv_path = os.path.join(d, "back.csv")
            _, counts = _run_cli(torch, [
                "transcribe", os.path.join(ftdir, "u0.wav"), "--size",
                "base", "--ckpt", ck, "--tokenizer-dir", tokdir, "--csv",
                csv_path], TRANSCRIBE_KERNELS,
                "transcribe --ckpt <full finetune>")
            out.append(counts)
            with open(csv_path) as fh:
                if "error" in fh.readline():
                    raise AssertionError(f"transcribe --ckpt {ck}: error "
                                         "row")
        _, counts = _run_cli(torch, ["export-hf", "--ckpt", ck, "--out",
                                     ck + "_hf"], (),
                             f"export-hf --ckpt <finetune r{rank}>")
        out.append(counts)
    _, counts = _run_cli(torch, ["detect-language", wavs[0], "--size",
                                 "base", "--tokenizer-dir", tokdir],
                         TRANSCRIBE_KERNELS, "detect-language --size base")
    out.append(counts)

    audio = read_wav(wavs[1])[0].astype("<f4")

    def client(server):
        sock = _ws_connect(server.server_address[1], "cli")
        t0 = time.perf_counter()
        _ws_send(sock, 0x2, audio.tobytes())
        _ws_send(sock, OP_TEXT, b"flush")
        op, payload = read_frame(sock)
        seg = json.loads(payload)
        _ws_send(sock, 0x8, struct.pack(">H", 1000))
        sock.close()
        return op, seg, time.perf_counter() - t0

    counts, (op, seg, sec) = _serve_cli(
        torch, stream_server, "serve_streaming",
        ["stream-serve", "--size", "base", "--tokenizer-dir", tokdir,
         "--port", "0", "--batch-slots", "2"], "stream-serve --size base",
        client, CLI_STREAM_KERNELS)
    out.append(counts)
    print(f"[cli] stream-serve: one 30 s window answered in {sec:.2f} s: "
          f"{ {k: seg.get(k) for k in ('stream', 'index', 'audio_seconds')} }"
          f" ({smi})", flush=True)
    if op != OP_TEXT or seg.get("stream") != "cli" or seg.get("index") != 0:
        raise AssertionError(f"stream-serve: {op} {seg}")
    return out


def _cli_classifiers(torch, d, smi, make_synthetic_urbansound):
    """``preprocess``, ``train-*``/``test-*`` (``--no-plot``),
    ``classifier-proof --no-plot`` and ``verify-parity --kind classifier``
    on a synthetic UrbanSound stand-in at the reference widths."""
    import os

    out = []
    root = make_synthetic_urbansound(os.path.join(d, "us8k"),
                                     per_fold=CLI_PER_FOLD)
    pq = os.path.join(d, "us8k.parquet")
    _, counts = _run_cli(torch, ["preprocess", "--dataset-root", root,
                                 "--out", pq], ("log_mel_overlap_fft",),
                         f"preprocess ({10 * CLI_PER_FOLD} clips, "
                         "UrbanSound v2)")
    out.append(counts)
    # the classifiers' attention is plain products (as flax's): no kernel
    for kind in ("cnn", "transformer"):
        ck = os.path.join(d, f"ck_{kind}")
        _, counts = _run_cli(torch, [f"train-{kind}", "--parquet", pq,
                                     "--ckpt-dir", ck, "--run-name", kind,
                                     "--epochs", CLI_EPOCHS], (),
                             f"train-{kind} ({CLI_EPOCHS} epochs)")
        out.append(counts)
        _, counts = _run_cli(torch, [f"test-{kind}", "--parquet", pq,
                                     "--ckpt-dir", ck, "--run-name", kind,
                                     "--no-plot"], (),
                             f"test-{kind} --no-plot")
        out.append(counts)
    _, counts = _run_cli(torch, ["classifier-proof", "--out",
                                 os.path.join(d, "proof"), "--work-dir",
                                 os.path.join(d, "proof_work"), "--no-plot"],
                         ("log_mel_overlap_fft",),
                         "classifier-proof --no-plot (200 clips, 12 epochs)")
    out.append(counts)
    with open(os.path.join(d, "proof",
                           "synthetic_urbansound_metrics.json")) as fh:
        print(f"[cli] classifier-proof: {json.load(fh)}", flush=True)
    report = os.path.join(d, "parity.json")
    _, counts = _run_cli(torch, ["verify-parity", "--hf-dir", "unused",
                                 "--kind", "classifier", "--data-dir", root,
                                 "--model", "cnn", "--epochs", CLI_EPOCHS,
                                 "--report", report],
                         ("log_mel_overlap_fft",),
                         "verify-parity --kind classifier")
    out.append(counts)
    with open(report) as fh:
        print(f"[cli] verify-parity --kind classifier: {json.load(fh)} "
              f"({smi})", flush=True)
    return out


#: the keys each bench prints (the JAX command line's, which the port keeps)
BENCH_KEYS = {
    "bench-rtf": ("metric", "size", "dtype", "fallback_ladder", "seconds",
                  "value", "target", "achieved_tflops", "mfu_pct"),
    "bench-streaming": ("metric", "size", "dtype", "batch_slots", "streams",
                        "value", "audio_seconds", "wall_seconds"),
    "bench-continuous": ("metric", "engine", "size", "slots", "requests",
                         "budget_range", "dtype", "value", "continuous",
                         "convoy"),
    "bench-speculative": ("metric", "size", "draft", "dtype", "spec_tokens",
                          "tokens", "plain", "draft_alone",
                          "floor_random_draft", "ceiling_full_acceptance",
                          "ceiling_speedup", "greedy_agreement"),
    "bench-train": ("metric", "size", "lora_rank", "batch_size", "dtype",
                    "value", "sec_per_step", "audio_seconds_per_sec", "mesh",
                    "fsdp", "achieved_tflops", "mfu_pct",
                    "xla_counted_tflops"),
}
SCHEDULE_KEYS = ("wall_s", "tokens_per_s", "decode_steps", "slot_efficiency")
#: the kernels of the bf16 Whisper paths (encoder on K2's wgmma body) and
#: of their int4 + int8-KV twin (K3's int8 arm, K9's tensor-core body)
BENCH_BF16_KERNELS = CLI_STREAM_KERNELS
BENCH_Q4_KERNELS = ("log_mel_overlap_fft", "flash_forward_wgmma",
                    "decode_attention_stacked_int8",
                    "decode_attention_sm90_int8", "int4_matmul_mma")
BENCH_TRAIN_KERNELS = {"float32": CLI_TRAIN_KERNELS[1:],
                       "bfloat16": WGMMA}
#: the bench phase's runs: (label, argv, the kernels it must launch, the
#: launches predicted for it where the run fixes them). Widths are the
#: published ones; only run lengths are cut (--seconds, --runs,
#: --requests, --streams, --windows, --steps, --max-new-tokens).
#: bench-train's predictions: K2 twice a site a step under full remat,
#: K7 and K8 once, over 1 + --steps steps (Whisper-tiny 12 sites,
#: Whisper-base 18)
BENCH_RUNS = (
    ("bench-rtf base bf16 (full ladder)",
     ["bench-rtf", "--size", "base", "--seconds", "30", "--runs", "1",
      "--max-new-tokens", "64"],
     BENCH_BF16_KERNELS, {}),
    ("bench-rtf large-v3-turbo int4 + int8 KV",
     ["bench-rtf", "--size", "large-v3-turbo", "--quantize", "int4",
      "--kv-quant", "--no-fallback", "--seconds", "30", "--runs", "1"],
     BENCH_Q4_KERNELS, {}),
    ("bench-streaming base", ["bench-streaming", "--size", "base",
                              "--streams", "8", "--windows", "1"],
     BENCH_BF16_KERNELS, {}),
    ("bench-continuous asr base",
     ["bench-continuous", "--engine", "asr", "--size", "base",
      "--requests", "8", "--max-new-tokens", "112"], BENCH_BF16_KERNELS,
     {}),
    ("bench-continuous music qwen3-0.6b",
     ["bench-continuous", "--engine", "music", "--lm-preset", "qwen3-0.6b",
      "--requests", "8", "--max-new-tokens", "112"], BENCH_BF16_KERNELS,
     {}),
    ("bench-speculative base / tiny",
     ["bench-speculative", "--size", "base", "--draft-size", "tiny",
      "--max-new-tokens", "16"], BENCH_BF16_KERNELS, {}),
    ("bench-train tiny f32 LoRA 8 (default)",
     ["bench-train", "--steps", "5"], BENCH_TRAIN_KERNELS["float32"],
     {"flash_forward_tf32x3": 144, "flash_backward_dq_tf32x3": 72,
      "flash_backward_dkv_tf32x3": 72}),
    ("bench-train base bf16 full",
     ["bench-train", "--size", "base", "--dtype", "bfloat16", "--lora-rank",
      "0", "--steps", "5"], BENCH_TRAIN_KERNELS["bfloat16"],
     {"flash_forward_wgmma": 216, "flash_backward_dq_wgmma": 108,
      "flash_backward_dkv_wgmma": 108}),
)


def _finite_numbers(obj, where):
    """Raise unless every number in ``obj`` (a JSON value) is finite."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite_numbers(v, f"{where}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _finite_numbers(v, f"{where}[{i}]")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if not math.isfinite(obj):
            raise AssertionError(f"{where} = {obj}")


def _run_bench(torch, argv, kernels, label, tokdir):
    """One bench through ``cli.main`` on the card, its counts from 0: the
    JSON line it prints (every key the JAX command prints, finite numbers),
    its exit code by the command's own rule, its kernels and no plain
    version. Returns (record, seconds, counts)."""
    import contextlib
    import io

    from audax_torch.cli import main as cli
    from audax_torch.ops import launch_counts, reset_launches

    if argv[0] != "bench-continuous" or "music" not in argv:
        argv = argv + ["--tokenizer-dir", tokdir]
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    text = out.getvalue()
    sys.stdout.write(text)
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"{label}: exit {rc}, no JSON line")
    rec = json.loads(lines[-1])
    missing = set(BENCH_KEYS[argv[0]]) - set(rec)
    if missing:
        raise AssertionError(f"{label}: keys {sorted(missing)} missing")
    _finite_numbers(rec, label)
    # bench-rtf's own contract: exit 1 exactly when the RTF is above its
    # 0.05 target; every other bench exits 0
    want = (int(rec["value"] > rec["target"]) if argv[0] == "bench-rtf"
            else 0)
    if rc != want:
        raise AssertionError(f"{label}: exit {rc}, expected {want} for "
                             f"{rec}")
    _check_launches(counts, kernels, label)
    _no_core_flash(counts, label)
    ran = {k: c["cuda"] for k, c in counts.items() if c["cuda"]}
    print(f"[bench] {label}: exit {rc}, {seconds:.2f} s; launches {ran}",
          flush=True)
    return rec, seconds, counts


def write_minimal_sf2(path, sample_rate=16000):
    """A minimal soundfont: one preset (bank 0, program 0) of one looped
    440 Hz sine zone over every key, root key 69, with attack, decay,
    sustain and release generators."""
    import struct

    import numpy as np
    n = sample_rate // 4
    smp = np.round(12000 * np.sin(2 * np.pi * 440 * np.arange(n)
                                  / sample_rate)).astype("<i2")

    def chunk(cid, body):
        return cid + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    def name(s):
        return s.encode().ljust(20, b"\0")

    def gens(pairs):
        return b"".join(struct.pack("<Hh", op, amt) for op, amt in pairs)

    pdta = b"pdta" + b"".join(chunk(c, b) for c, b in (
        (b"phdr", name("Sine") + struct.pack("<HHHIII", 0, 0, 0, 0, 0, 0)
         + name("EOP") + struct.pack("<HHHIII", 0, 0, 1, 0, 0, 0)),
        (b"pbag", struct.pack("<HHHH", 0, 0, 1, 0)),
        (b"pmod", bytes(10)), (b"pgen", gens([(41, 0), (0, 0)])),
        (b"inst", name("SineInst") + struct.pack("<H", 0) + name("EOI")
         + struct.pack("<H", 1)),
        (b"ibag", struct.pack("<HHHH", 0, 0, 7, 0)), (b"imod", bytes(10)),
        (b"igen", gens([(43, 127 << 8), (34, -7200), (36, -1200), (37, 60),
                        (38, -2400), (54, 1), (53, 0), (0, 0)])),
        (b"shdr", name("sine") + struct.pack(
            "<IIIIIBbHH", 0, n, 400, n - 400, sample_rate, 69, 0, 0, 1)
         + name("EOS") + struct.pack("<IIIIIBbHH", *([0] * 9)))))
    body = (b"sfbk" + chunk(b"LIST", b"INFO" + chunk(
        b"ifil", struct.pack("<HH", 2, 1)))
            + chunk(b"LIST", b"sdta" + chunk(b"smpl", smp.tobytes()
                                             + bytes(92)))
            + chunk(b"LIST", pdta))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _host_libraries(d, rng, smi):
    """The host toolchain the native code needs (printed, not branched on),
    then the SF2 synth built by g++ and rendered twice."""
    import ctypes.util
    import os

    import numpy as np

    from audax_torch.native.bindings import Sf2Synth
    from audax_torch.symbolic.midi import MidiFile, Note, Tempo

    gxx = _run(["g++", "--version"]).splitlines()[0]
    libs = {lib: ctypes.util.find_library(lib)
            for lib in ("avformat", "avcodec", "avutil")}
    print(f"[bench] host: {gxx}; find_library {libs}", flush=True)
    mf = MidiFile(ticks_per_beat=480)
    mf.tempos.append(Tempo(0, 500000))
    tick = 0
    for pitch in rng.integers(48, 84, 24):
        mf.notes.append(Note(tick, 240, int(pitch), 96))
        tick += 240
    t0 = time.perf_counter()
    synth = Sf2Synth(write_minimal_sf2(os.path.join(d, "sine.sf2")))
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = synth.render(mf, 16000)
    render = time.perf_counter() - t0
    b = synth.render(mf, 16000)
    synth.close()
    peak = float(np.abs(a).max())
    print(f"[bench] SF2 synth: built and opened in {built:.2f} s, "
          f"{mf.duration_seconds:.2f} s of audio rendered in {render:.4f} s, "
          f"peak {peak:.4f}, two renders bit-equal {np.array_equal(a, b)} "
          f"({smi})", flush=True)
    if not (np.isfinite(a).all() and peak > 0.05 and np.array_equal(a, b)):
        raise AssertionError(f"SF2 render: peak {peak}, finite "
                             f"{np.isfinite(a).all()}")


def _demo_round_trip(torch, rng, d, smi):
    """``demo`` (Whisper-tiny, its defaults) on a thread: a WAV through
    ``/transcribe`` against an in-process Transcriber built the same way,
    ``/add`` of three labelled WAVs, a 5-step ``/finetune`` polled on
    ``/status`` to ``done``, ``/swap`` and ``/transcribe?model=finetuned``.
    Returns the run's counts."""
    import os
    import urllib.request

    from audax_torch.cli import demo_ui
    from audax_torch.cli import main as cli
    from audax_torch.data.audio_io import read_wav, write_wav
    from audax_torch.infer.transcribe import Transcriber

    clips = []                          # (samples as read back, WAV bytes)
    for i in range(4):
        path = os.path.join(d, f"demo{i}.wav")
        write_wav(path, _speechlike(rng, 5.0, pitch=100.0 + 20 * i), 16000)
        with open(path, "rb") as fh:
            clips.append((read_wav(path)[0][:, 0], fh.read()))

    def call(port, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=body,
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def client(server):
        port = server.server_address[1]
        t0 = time.perf_counter()
        first = call(port, "/transcribe?model=original", clips[0][1])
        t_tr = time.perf_counter() - t0
        for i, text in enumerate(("hello world", "the quick brown fox",
                                  "how are you today")):
            call(port, f"/add?text={urllib.request.quote(text)}",
                 clips[1 + i][1])
        t0 = time.perf_counter()
        call(port, "/finetune", b"")
        while True:
            status = call(port, "/status")
            if status["state"] != "running":
                break
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"demo fine-tune still running: "
                                     f"{status}")
            time.sleep(0.2)
        t_ft = time.perf_counter() - t0
        if status["state"] != "done":
            raise AssertionError(f"demo fine-tune: {status}")
        swapped = call(port, "/swap", b"")
        tuned = call(port, "/transcribe?model=finetuned", clips[0][1])
        return first, t_tr, status, t_ft, swapped, tuned

    cwd = os.getcwd()
    os.chdir(d)                     # the demo's dataset dir is relative
    try:
        counts, (first, t_tr, status, t_ft, swapped, tuned) = _serve_cli(
            torch, demo_ui, "serve",
            ["demo", "--port", "0", "--ft-steps", "5"], "demo (Whisper-tiny)",
            client, FINETUNE_KERNELS)
    finally:
        os.chdir(cwd)
    params, cfg, tok = cli._load_whisper("tiny", "", "", "cuda")
    want = Transcriber(params, cfg, tok, device="cuda").transcribe(
        clips[0][0]).text
    print(f"[bench] demo: /transcribe in {t_tr:.2f} s (RTF {first['rtf']}), "
          f"equal to the in-process Transcriber {first['text'] == want}; "
          f"5-step /finetune {status['state']} in {t_ft:.2f} s (loss "
          f"{status['loss']}); /swap {swapped}; finetuned text "
          f"{len(tuned['text'])} characters ({smi})", flush=True)
    if first["text"] != want or swapped != {"serving": "finetuned"} \
            or not math.isfinite(status["loss"]):
        raise AssertionError(f"demo: {first!r} vs {want!r}; {status}; "
                             f"{swapped}")
    return counts


def bench_phase(torch, rng, smi):
    """The five ``bench-*`` commands through ``cli.main`` at their models'
    published widths (random weights from seeds; the Whisper benches with a
    tokenizer of the published 51,865/51,866-token layout), the ``demo``
    round trip at Whisper-tiny, and the host libraries (a g++ and libav
    probe, the SF2 synth). Returns the launch counts of every run, and each
    bench's (JSON line, counts) by its ``BENCH_RUNS`` label."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    all_counts = []
    with tempfile.TemporaryDirectory() as d:
        _host_libraries(d, rng, smi)
        tokdir = os.path.join(d, "tok")
        _tokenizer(51866).bpe.save(tokdir)
        records = {}
        for label, argv, kernels, predicted in BENCH_RUNS:
            rec, secs, counts = _run_bench(torch, argv, kernels, label,
                                           tokdir)
            all_counts.append(counts)
            records[label] = (rec, counts)
            print(f"[bench] {label}: {secs:.2f} s ({smi})", flush=True)
            off = {k: (counts[k]["cuda"], n) for k, n in predicted.items()
                   if counts[k]["cuda"] != n}
            if off:
                raise AssertionError(f"{label}: launches (counted, "
                                     f"predicted) {off}")
            if argv[0] == "bench-continuous":
                c, v = rec["continuous"], rec["convoy"]
                if set(c) != set(SCHEDULE_KEYS) or set(v) != set(
                        SCHEDULE_KEYS) or c["decode_steps"] > v[
                        "decode_steps"]:
                    raise AssertionError(f"{label}: {rec}")
            if argv[0] == "bench-train":
                from audax_torch.utils.profiling import (H100_BF16_FLOPS,
                                                         H100_F32_FLOPS)
                peak = (H100_BF16_FLOPS if rec["dtype"] == "bfloat16"
                        else H100_F32_FLOPS)
                share = 100.0 * rec["achieved_tflops"] * 1e12 / peak
                print(f"[bench] {label}: {rec['value']} examples/s, "
                      f"{rec['achieved_tflops']} TFLOP/s = {share:.2f}% of "
                      f"the {rec['dtype']} peak {peak / 1e12:.0f} TFLOP/s "
                      f"(mfu_pct {rec['mfu_pct']}) ({smi})", flush=True)
                if abs(share - rec["mfu_pct"]) > 0.02 + 0.01 * share:
                    raise AssertionError(f"{label}: mfu_pct {rec}")
        all_counts.append(_demo_round_trip(torch, rng, d, smi))
    print(f"[bench] phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return all_counts, records


#: the parallel phase's fine-tune and LM runs: steps, the LM's depth
PARALLEL_STEPS = 3
PARALLEL_LM_LAYERS = 2
#: the float32 flash bodies a mesh step must launch exactly as often as the
#: step without one
PARALLEL_FLASH = ("flash_forward_tf32x3", "flash_backward_dq_tf32x3",
                  "flash_backward_dkv_tf32x3")
#: TP decoding at Whisper-large-v3-turbo width: tokens after the prompt
PARALLEL_TOKENS = 12
#: the world of two's FSDP (data 2) Whisper-base run: steps, and the
#: bounds on its gathered first moments and updates (each leaf's norm of
#: the difference over the whole run's; a sign flipped by rounding where a
#: gradient is ~0 moves an update by 2 lr, hence the looser one) and, with
#: int8 moments, on the share of the last step's codes that rounding
#: moved (``mesh_world.hold_int8_tree``'s 1 in 1,000)
PARALLEL_FSDP_STEPS = 2
PARALLEL_FSDP_TOL = {"mu": 1e-4, "update": 1e-2, "codes": 1e-3}
#: the collectives the world of two probes on CUDA tensors over gloo
GLOO_PROBES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")
#: the world of two's sequence- and pipeline-parallel cases: the SP and PP
#: encoders and the SP fine-tune's losses against the world of one's
#: (relative), the SP fine-tune's steps; the PP causal-LM step's depth,
#: batch (rows, tokens), steps, its losses' relative bound and its stage
#: slices' (JAX's ``tests/test_pp.py`` bounds)
SP_TOL = 1e-4
SP_FT_STEPS = 2
PP_LM_LAYERS = 4
PP_LM_BATCH = (4, 128)
PP_LM_STEPS = 2
PP_LM_TOL = {"loss": 1e-5, "atol": 5e-5, "rtol": 1e-3}
#: C8: bench-train over a mesh. The world of one's run is the
#: ``BENCH_RUNS`` base bf16 line's (full fine-tune, B 16, 5 steps) with
#: ``--dp 1 --fsdp``; each child of the world of two runs Whisper-tiny LoRA
#: 8 in float32 over ``--dp 2``, its launches a rank (K2 twice a site a step
#: under full remat, K7 and K8 once; 12 sites, 1 + 2 steps)
PARALLEL_BENCH_ARGV = ["bench-train", "--size", "base", "--dtype",
                       "bfloat16", "--lora-rank", "0", "--dp", "1", "--fsdp",
                       "--batch-size", "16", "--steps", "5"]
PARALLEL_BENCH_LINE = "bench-train base bf16 full"
CHILD_BENCH_ARGV = ["bench-train", "--dp", "2", "--size", "tiny",
                    "--lora-rank", "8", "--steps", "2"]
CHILD_BENCH_LAUNCHES = {"flash_forward_tf32x3": 72,
                        "flash_backward_dq_tf32x3": 36,
                        "flash_backward_dkv_tf32x3": 36}
#: C9: the turbo TP 2 clip's word times against the run without a mesh
#: (one encoder frame)
WORD_TIME_TOL = 0.02
#: the point-to-point operations probed on CUDA tensors over gloo, each in
#: a world of two of its own (gloo may abort the process)
P2P_PROBES = ("send_recv", "batch_isend_irecv")
P2P_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
name, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=2)
x = torch.full((1024,), float(rank + 1), device="cuda")
y = torch.zeros_like(x)
if name == "send_recv":
    if rank == 0:
        dist.send(x, 1)
        dist.recv(y, 1)
    else:
        dist.recv(y, 0)
        dist.send(x, 0)
else:
    ops = [dist.P2POp(dist.isend, x, 1 - rank),
           dist.P2POp(dist.irecv, y, 1 - rank)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
torch.cuda.synchronize()
print(json.dumps({"ok": bool((y == float(2 - rank)).all())}), flush=True)
dist.destroy_process_group()
"""
PARALLEL_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.parallel_child(int(sys.argv[2]), sys.argv[3]))
"""


def _turbo_request(np):
    """The TP decode case's input: one 30 s speechlike clip from its own
    seed, the same in the parent and in both children."""
    return _speechlike(np.random.default_rng(34), 30.0, pitch=140.0)


def _turbo_params(torch):
    """Whisper-large-v3-turbo's config and its random float32 weights from
    seed 32, drawn on the card."""
    from audax_torch.core.config import WhisperConfig
    from audax_torch.models import whisper as W

    cfg = WhisperConfig.large_v3_turbo()
    return cfg, W.init_whisper_params(
        cfg, torch.Generator(device="cuda").manual_seed(32), device="cuda")


def _turbo_tp_tokens(torch, mesh, params=None):
    """Greedy TP decoding of ``_turbo_request`` at Whisper-large-v3-turbo
    width over ``mesh``'s model axis (``_turbo_params``' weights, or
    ``params``, which stay whole): (tokens [1, L] as a list, seconds,
    launch counts of the encode and decode, counted from 0)."""
    import numpy as np

    from audax_torch.core.config import WhisperConfig
    from audax_torch.frontend.features import LogMelFrontend, pad_or_trim
    from audax_torch.infer.decode import generate
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.parallel.mesh import use_mesh
    from audax_torch.parallel.sharding import shard_params

    if params is None:
        cfg, params = _turbo_params(torch)
    else:
        cfg = WhisperConfig.large_v3_turbo()
    tok = _tokenizer(cfg.vocab_size)
    local = shard_params(params, mesh, heads=cfg.heads)
    del params
    fe = LogMelFrontend.whisper(cfg.n_mels, device="cuda")
    x = torch.from_numpy(_turbo_request(np)).cuda()
    prompt = torch.tensor([tok.sot_sequence(lang="en")], device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with use_mesh(mesh), torch.no_grad():
        enc = W.encode(local, cfg, fe(pad_or_trim(x, 480000)[None]))
    res = generate(local, cfg, enc, prompt, eos_id=tok.eot, mesh=mesh,
                   max_len=prompt.shape[1] + PARALLEL_TOKENS)
    torch.cuda.synchronize()
    return (res.tokens[0].tolist(), time.perf_counter() - t0,
            launch_counts())


def _turbo_words(torch, mesh, params):
    """Word timestamps of ``_turbo_request`` at Whisper-large-v3-turbo width
    through ``Transcriber(word_timestamps=True, mesh=)`` (``params`` whole;
    the Transcriber cuts them over ``mesh``'s model axis), greedy,
    ``PARALLEL_TOKENS`` tokens: ([(word, start, end)], seconds, launch
    counts of the call, counted from 0)."""
    import numpy as np

    from audax_torch.core.config import WhisperConfig
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.ops import launch_counts, reset_launches

    cfg = WhisperConfig.large_v3_turbo()
    tr = Transcriber(params, cfg, _tokenizer(cfg.vocab_size),
                     word_timestamps=True, mesh=mesh,
                     max_new_tokens=PARALLEL_TOKENS,
                     temperature_fallback=False, device="cuda")
    x = _turbo_request(np)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = tr.transcribe(x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del tr
    return ([(w.word, w.start, w.end) for seg in res.segments
             for w in (seg.words or [])], secs, launch_counts())


def _bench_child(torch, tokdir):
    """``CHILD_BENCH_ARGV`` through ``cli.main`` on this rank: its exit
    code, JSON line, seconds (host clock ending in a synchronize) and
    launch counts, counted from 0."""
    import contextlib
    import io

    from audax_torch.cli import main as cli
    from audax_torch.ops import launch_counts, reset_launches

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(CHILD_BENCH_ARGV + ["--tokenizer-dir", tokdir])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return {"rc": rc, "rec": json.loads(lines[-1]) if lines else None,
            "seconds": secs,
            "counts": {k: c["cuda"] for k, c in launch_counts().items()},
            "plain": {k: c["plain"] for k, c in launch_counts().items()
                      if c["plain"]}}


def _fsdp_case(torch, params, cfg, batch, moments):
    """``PARALLEL_FSDP_STEPS`` Whisper-base steps whole and in the ZeRO-3
    layout over (data 2) with ``moments``: the losses, seconds and launches
    of the FSDP run, its first moments and updates against the whole run's
    (each leaf's norm of the difference over the whole run's; int8 first
    moments, whole on every rank: their scales so, and their codes by how
    many moved and how far) and the bytes of each moment tree a rank."""
    from audax_torch.core.config import FineTuneConfig, MeshConfig
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.parallel.fsdp import fsdp_shard_state
    from audax_torch.parallel.mesh import make_mesh, shard_batch
    from audax_torch.train.seq2seq import init_finetune, make_finetune_step

    ft = FineTuneConfig(lora_rank=0, moment_dtype=moments,
                        learning_rate=1e-4, warmup_steps=0)
    step = make_finetune_step(cfg, remat=True)
    int8 = moments == "int8"

    def codes(state):
        """The int8 first moments after a step: (codes, scales) a leaf."""
        mu = state.opt_state.mu
        return [(q.clone(), s.clone()) for q, s in zip(
            W.tree_leaves(mu["q"]), W.tree_leaves(mu["s"]))]

    whole, wl, wsnap = init_finetune(params, ft), [], []
    for _ in range(PARALLEL_FSDP_STEPS):
        whole, m = step(whole, batch)
        wl.append(float(m["loss"]))
        if int8:
            wsnap.append(codes(whole))
    dmesh = make_mesh(MeshConfig(data=2), device="cuda")
    st, fl, fsnap = fsdp_shard_state(init_finetune(params, ft), dmesh), [], []
    local = shard_batch(dmesh, batch)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(PARALLEL_FSDP_STEPS):
        st, m = step(st, local)
        fl.append(float(m["loss"]))
        if int8:
            fsnap.append(codes(st))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: c["cuda"] for k, c in launch_counts().items()}
    plain = {k: c["plain"] for k, c in launch_counts().items() if c["plain"]}
    # the trained tree and the first moments (the averaged, clipped
    # gradients: Adam's direction is blind to their scale), gathered
    # whole, against the whole run's; each leaf's update p - p0 and
    # moment by the norm of its difference over the whole run's
    cut = sum(any(a is not None for a in s) for s in st.layout.spec_list)
    leaves = W.tree_leaves

    @torch.no_grad()
    def rel(a, b):
        return max(float((x.float() - y.float()).norm()
                         / y.float().norm().clamp_min(1e-30))
                   for x, y in zip(a, b))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    out = {"losses": fl, "whole": wl, "seconds": secs, "cut": cut,
           "leaves": len(st.layout.spec_list), "counts": counts,
           "plain": plain,
           "mu_bytes": nbytes(st.opt_state.mu),
           "nu_bytes": nbytes(st.opt_state.nu),
           "params": sum(t.numel() for t in leaves(params))}
    with torch.no_grad():
        p0 = leaves(params)
        upd = [x - y for x, y in zip(leaves(st.layout.full(st.trainable)),
                                     p0)]
        upd_whole = [x - y for x, y in zip(leaves(whole.trainable), p0)]
        out["update_rel"] = rel(upd, upd_whole)
        if int8:
            out.update(_int8_moments(torch, fsnap, wsnap))
        else:
            out["mu_rel"] = rel(leaves(st.layout.full(st.opt_state.mu)),
                                leaves(whole.opt_state.mu))
    del whole, st, upd, upd_whole
    torch.cuda.empty_cache()
    return out


def _int8_moments(torch, fsnap, wsnap, b1=0.9):
    """The int8 first moments of the FSDP run against the whole run's,
    step by step (``fsnap``/``wsnap``: each step's (codes, scales) a leaf,
    both whole). A code is 1/127 of its block's max, so rounding in the
    gradient's sum can move one by a step, and the next step carries the
    move (m = b1 dec(q) + (1 - b1) g): where a block's m nearly cancels,
    one step of the earlier, larger scale is many of the new one. So each
    step's decoded difference is held after taking out both runs' own
    rounding (half a step each) and b1 times the previous step's decoded
    difference: what is left is the gradients' float difference, held by
    the float32 case's bound (``PARALLEL_FSDP_TOL["mu"]``, each leaf's
    norm over the whole run's) as "mu_excess_rel". Also: the last step's
    codes moved (their share held by ``PARALLEL_FSDP_TOL["codes"]``) and
    by how far, the scales' difference and the decoded difference as they
    are (printed)."""
    out = {"scale_rel": 0.0, "mu_rel": 0.0, "mu_excess_rel": 0.0}
    prev = [None] * len(wsnap[0])
    with torch.no_grad():
        for fk, wk in zip(fsnap, wsnap):
            for i, ((qa, sa), (qb, sb)) in enumerate(zip(fk, wk)):
                da = qa.float() * sa[:, None]
                db = qb.float() * sb[:, None]
                norm = db.norm().clamp_min(1e-30)
                diff = (da - db).abs()
                carried = 0.0 if prev[i] is None else b1 * prev[i]
                excess = (diff - carried - 0.5 * (sa + sb)[:, None]
                          ).clamp_min(0.0)
                out["mu_excess_rel"] = max(out["mu_excess_rel"],
                                           float(excess.norm() / norm))
                prev[i] = diff
        last = list(zip(fsnap[-1], wsnap[-1]))
        for (qa, sa), (qb, sb) in last:
            db = qb.float() * sb[:, None]
            out["scale_rel"] = max(out["scale_rel"], float(
                (sa - sb).norm() / sb.norm().clamp_min(1e-30)))
            out["mu_rel"] = max(out["mu_rel"], float(
                (qa.float() * sa[:, None] - db).norm()
                / db.norm().clamp_min(1e-30)))
        out["codes_moved"] = sum(int((qa != qb).sum())
                                 for (qa, _), (qb, _) in last)
        out["codes"] = sum(qa.numel() for (qa, _), _ in last)
        out["code_step_max"] = max(int((qa.int() - qb.int()).abs().max())
                                   for (qa, _), (qb, _) in last)
    return out


def _gloo_probe(torch, dist):
    """Each collective of ``GLOO_PROBES`` on CUDA tensors over the current
    (gloo) world of two: "ok" when it ran and gave the right values, else
    the error's first line. Nothing is copied through the host here."""
    r = dist.get_rank()
    x = torch.full((4,), float(r + 1), device="cuda")

    def empty(n):
        return torch.empty(n, device="cuda")

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, [3.0] * 4

    def all_gather():
        parts = [empty(4), empty(4)]
        dist.all_gather(parts, x)
        return torch.cat(parts), [1.0] * 4 + [2.0] * 4

    def all_gather_into_tensor():
        y = empty(8)
        dist.all_gather_into_tensor(y, x)
        return y, [1.0] * 4 + [2.0] * 4

    def reduce_scatter():
        y = empty(2)
        dist.reduce_scatter(y, [x[:2].clone(), x[2:].clone()])
        return y, [3.0] * 2

    def reduce_scatter_tensor():
        y = empty(2)
        dist.reduce_scatter_tensor(y, x)
        return y, [3.0] * 2

    def all_to_all_single():
        y = empty(4)
        dist.all_to_all_single(y, x)
        return y, [1.0] * 2 + [2.0] * 2

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return y, [1.0] * 4

    probes = {f.__name__: f for f in (all_reduce, all_gather,
                                      all_gather_into_tensor, reduce_scatter,
                                      reduce_scatter_tensor,
                                      all_to_all_single, broadcast)}
    out = {}
    for name in GLOO_PROBES:
        try:
            got, want = probes[name]()
            out[name] = "ok" if got.tolist() == want else "wrong values"
        except Exception as e:             # what gloo cannot carry
            out[name] = (str(e).strip().splitlines() or [repr(e)])[0][:160]
        dist.barrier()
    return out


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _sp_pp_child(torch, params, cfg):
    """The sequence- and pipeline-parallel cases of a rank of the world of
    two: the SP encoder at turbo width on (seq 2), ring and Ulysses, and
    the PP encoder at turbo width over 2 stages, each against ``encode``
    on this rank; ``finetune_whisper(sp_mesh=(data 1, seq 2))`` at
    Whisper-base in float32 for ``SP_FT_STEPS`` steps (the parent runs it
    without a mesh); the PP causal-LM train step at Qwen3-0.6B width
    (``PP_LM_LAYERS`` layers) for ``PP_LM_STEPS`` steps with remat,
    against the one-rank step and the one-stage pipeline step on this
    rank. ``params``/``cfg``: turbo's, whole. Returns {case: {errors,
    seconds, launches, ...}}."""
    import dataclasses

    import numpy as np

    from audax_torch.frontend.features import LogMelFrontend, pad_or_trim
    from audax_torch.models import causal_lm as CL
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.parallel.mesh import make_named_mesh
    from audax_torch.parallel.pp import (encode_pipelined,
                                         make_pp_lm_train_step, pp_shard)
    from audax_torch.parallel.sp import encode_sequence_parallel
    from audax_torch.train.finetune_loop import finetune_whisper
    from audax_torch.train.optim import adamw, apply_updates
    from audax_torch.train.seq2seq import seq2seq_loss_sum

    sync = torch.cuda.synchronize
    out = {}

    plain = {}

    def run(fn):
        sync()
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        sync()
        counts = launch_counts()
        plain.update({k: c["plain"] for k, c in counts.items()
                      if c["plain"]})
        return res, time.perf_counter() - t0, {
            k: c["cuda"] for k, c in counts.items() if c["cuda"]}

    seq = make_named_mesh([("seq", 2)], device="cuda")
    stage = make_named_mesh([("stage", 2)], device="cuda")
    fe = LogMelFrontend.whisper(cfg.n_mels, device="cuda")
    clips = [_turbo_request(np), _speechlike(np.random.default_rng(35),
                                             30.0, pitch=180.0)]
    mel = fe(torch.stack([pad_or_trim(torch.from_numpy(c).cuda(), 480000)
                          for c in clips]))
    with torch.no_grad():
        ref = W.encode(params, cfg, mel)
        for ring in (True, False):
            enc, secs, counts = run(lambda: encode_sequence_parallel(
                params, cfg, mel[:1], seq, ring=ring))
            out["sp_ring" if ring else "sp_ulysses"] = {
                "rel": _rel(enc, ref[:1]), "seconds": secs,
                "counts": counts, "layers": cfg.encoder_layers}
        enc, secs, counts = run(lambda: encode_pipelined(
            params, cfg, mel, stage, n_micro=2))
        out["pp_encode"] = {"rel": _rel(enc, ref), "seconds": secs,
                            "counts": counts, "layers": cfg.encoder_layers}
    del ref, enc

    # ---- finetune_whisper(sp_mesh=), Whisper-base float32 -----------------
    # (the run without a mesh is the parent's, on the same inputs)
    bcfg, bparams, tok, examples, ft = _sp_finetune_inputs(torch, np)
    ds = make_named_mesh([("data", 1), ("seq", 2)], device="cuda")
    (_, h1), s1, c1 = run(lambda: finetune_whisper(
        bparams, bcfg, tok, examples, ft, sp_mesh=ds, device="cuda"))
    out["sp_finetune"] = {"losses": h1["loss"], "seconds": s1, "counts": c1,
                          "remat": ft.gradient_checkpointing,
                          "layers": (bcfg.encoder_layers,
                                     bcfg.decoder_layers)}
    del bparams, examples

    # ---- the PP causal-LM train step, Qwen3-0.6B width ---------------------
    lcfg = dataclasses.replace(CL.CausalLMConfig.qwen3_0_6b(),
                               layers=PP_LM_LAYERS)
    p0 = CL.init_causal_lm(lcfg, torch.Generator(device="cuda").manual_seed(
        39), device="cuda")
    rows, t = PP_LM_BATCH
    toks = torch.from_numpy(np.random.default_rng(39).integers(
        0, lcfg.vocab_size, (rows, t + 1))).cuda()
    opt = adamw(1e-3)
    whole = W.tree_map(lambda x: x.clone().requires_grad_(True), p0)
    state, ref_losses = opt.init(whole), []
    for _ in range(PP_LM_STEPS):
        total, count = seq2seq_loss_sum(
            CL.lm_forward(whole, lcfg, toks[:, :-1]).float(), toks[:, 1:])
        loss = total / count.clamp_min(1)
        grads = torch.autograd.grad(loss, W.tree_leaves(whole))
        ref_losses.append(float(loss))
        up, state = opt.update(W.tree_unflatten(whole, list(grads)), state,
                               whole)
        apply_updates(whole, up)
    one = make_named_mesh([("stage", 1), ("data", 2)], device="cuda")

    def train(mesh):
        # a copy: the step updates in place, and the leaves no stage cuts
        # come back from pp_shard as they are
        params = pp_shard(W.tree_map(lambda x: x.clone(), p0), mesh)
        step = make_pp_lm_train_step(lcfg, mesh, opt, n_micro=2, remat=True)
        st, losses = opt.init(params), []
        for _ in range(PP_LM_STEPS):
            params, st, loss = step(params, st, toks)
            losses.append(float(loss))
        return params, losses

    (local, losses), secs, counts = run(lambda: train(stage))
    one_stage, _ = train(one)
    del p0

    def excess(ref):
        """Each leaf's worst |diff| - rtol |ref| against ``ref`` cut to
        this stage (allclose holds where it is at most atol)."""
        ref = pp_shard(W.tree_map(lambda x: x.detach(), ref), stage)
        return {path: float(((a.detach() - b).abs()
                             - PP_LM_TOL["rtol"] * b.abs()).max())
                for path, a, b in zip(_paths(local), W.tree_leaves(local),
                                      W.tree_leaves(ref))}

    out["pp_lm"] = {"losses": losses, "whole": ref_losses, "seconds": secs,
                    "counts": counts, "excess": excess(one_stage),
                    "excess_whole": excess(whole),
                    "q_local": list(local["layers"]["q"]["kernel"].shape)}
    del whole, local, one_stage, state
    torch.cuda.empty_cache()
    for o in out.values():
        o["plain"] = plain
    return out


def parallel_child(rank: int, d: str) -> int:
    """One rank of the parallel phase's world of two on the one card,
    over gloo (named: NCCL refuses two ranks on one GPU): the collective
    probe, TP decoding at Whisper-large-v3-turbo width (10 of 20 heads a
    rank) and the same clip's word timestamps through
    ``Transcriber(mesh=)``, the SP/PP cases, ``bench-train --dp 2`` through
    the command line (the tokenizer in ``d``/tok), and, where gloo carried
    the collectives FSDP needs, ``PARALLEL_FSDP_STEPS`` FSDP (data 2)
    Whisper-base steps against the same steps whole, with float32 and with
    int8 first moments (``_fsdp_case``). Writes ``out{rank}.json`` in
    ``d``."""
    import os

    import torch
    import torch.distributed as dist

    from audax_torch.core.config import MeshConfig, WhisperConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.models import whisper as W
    from audax_torch.parallel.mesh import make_mesh
    from audax_torch.train.seq2seq import collate_seq2seq

    resolve_device("cuda")
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=2)
    out = {"backend": dist.get_backend(), "probe": _gloo_probe(torch, dist)}
    mesh = make_mesh(MeshConfig(model=2), device="cuda")
    tcfg, tparams = _turbo_params(torch)
    tokens, secs, counts = _turbo_tp_tokens(torch, mesh, tparams)
    out.update(tokens=tokens, seconds=secs,
               counts={k: c["cuda"] for k, c in counts.items()},
               plain={k: c["plain"] for k, c in counts.items()
                      if c["plain"]})
    words, secs, counts = _turbo_words(torch, mesh, tparams)
    out["words"] = {"words": words, "seconds": secs,
                    "counts": {k: c["cuda"] for k, c in counts.items()},
                    "plain": {k: c["plain"] for k, c in counts.items()
                              if c["plain"]}}
    out["sp_pp"] = _sp_pp_child(torch, tparams, tcfg)
    del tparams
    torch.cuda.empty_cache()
    out["bench"] = _bench_child(torch, os.path.join(d, "tok"))
    if all(out["probe"][k] == "ok" for k in ("all_gather",
                                             "reduce_scatter",
                                             "all_reduce")):
        cfg = WhisperConfig.base()
        params = W.init_whisper_params(
            cfg, torch.Generator(device="cuda").manual_seed(35),
            device="cuda")
        g = torch.Generator(device="cuda").manual_seed(36)
        lab = collate_seq2seq([[50258, 50259, 50359, 50363] + list(range(
            300, 316)) + [50257]] * 4, decoder_start_id=50258)
        batch = {"mel": torch.randn(4, 3000, cfg.n_mels, device="cuda",
                                    generator=g),
                 "decoder_input_ids": torch.from_numpy(
                     lab["decoder_input_ids"]).cuda(),
                 "labels": torch.from_numpy(lab["labels"]).cuda()}
        out["fsdp"] = _fsdp_case(torch, params, cfg, batch, "float32")
        out["fsdp_int8"] = _fsdp_case(torch, params, cfg, batch, "int8")
    with open(os.path.join(d, f"out{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mesh_bench_case(torch, bpe, bench, smi):
    """C8 in the world of one: ``PARALLEL_BENCH_ARGV`` through the command
    line (``_run_bench``, the tokenizer ``bpe`` saved for it), its "mesh"
    and "fsdp", and its wgmma launches equal to the bench phase's line
    without a mesh (``bench``, else ``BENCH_RUNS``' prediction), its
    examples/s and MFU printed beside that line's. Returns its counts."""
    import os
    import tempfile

    label = "parallel bench-train --dp 1 --fsdp base bf16 full"
    with tempfile.TemporaryDirectory() as td:
        bpe.save(os.path.join(td, "tok"))
        rec, sb, cb = _run_bench(torch, PARALLEL_BENCH_ARGV,
                                 BENCH_TRAIN_KERNELS["bfloat16"], label,
                                 os.path.join(td, "tok"))
    predicted = {lab: pred for lab, _, _, pred in BENCH_RUNS}
    line = (bench or {}).get(PARALLEL_BENCH_LINE)
    want = ({k: line[1][k]["cuda"] for k in WGMMA} if line is not None
            else predicted[PARALLEL_BENCH_LINE])
    got = {k: cb[k]["cuda"] for k in WGMMA}
    beside = ("not run in this call" if line is None else
              f"{line[0]['value']} examples/s, mfu_pct {line[0]['mfu_pct']}"
              f" ({rec['value'] / line[0]['value']:.4f}x)")
    print(f"[parallel] {label}: mesh {rec['mesh']}, fsdp {rec['fsdp']}; "
          f"{rec['value']} examples/s, mfu_pct {rec['mfu_pct']}, "
          f"{rec['sec_per_step']} s a step; the bench phase's "
          f"{PARALLEL_BENCH_LINE!r} line: {beside}; wgmma launches {got} "
          f"(the line without a mesh {want}); {sb:.2f} s ({smi})",
          flush=True)
    if rec["mesh"] != {"data": 1, "model": 1} or rec["fsdp"] is not True:
        raise AssertionError(f"{label}: {rec}")
    if got != want:
        raise AssertionError(f"{label}: wgmma launches {got} vs {want}")
    return cb


def _check_children(outs, ref_words, sw, smi):
    """The world of two's new cases, each rank's held and rank 0's
    printed: C9's words against ``ref_words`` (the run without a mesh,
    ``sw`` s), C8's ``bench-train --dp 2`` and C10's FSDP (data 2) runs
    with float32 and int8 first moments. Returns their launch counts."""
    counts_all = []
    # C9: the clip's words under TP 2 against the run without a mesh
    for r, o in enumerate(outs):
        w = o["words"]
        got = w["words"]
        same = [x[0] for x in got] == [x[0] for x in ref_words]
        moved = sum(a[1] != b[1] or a[2] != b[2]
                    for a, b in zip(got, ref_words))
        off = max((abs(a[i] - b[i]) for a, b in zip(got, ref_words)
                   for i in (1, 2)), default=0.0)
        if r == 0:
            print(f"[parallel] Transcriber(word_timestamps=True, mesh=) "
                  f"turbo TP 2 over gloo: {len(got)} words equal to the run "
                  f"without a mesh {same}; {moved} with other times, max "
                  f"{off:.3f} s (tol {WORD_TIME_TOL} s, one frame); "
                  f"{w['seconds']:.2f} s (without a mesh {sw:.2f} s); "
                  f"rank 0 launches "
                  f"{ {k: v for k, v in w['counts'].items() if v} } ({smi})",
                  flush=True)
        if not same or off > WORD_TIME_TOL + 1e-6:
            raise AssertionError(f"TP words, rank {r}: {got} vs "
                                 f"{ref_words}")
        wc = _child_counts(w)
        _check_launches(wc, TRANSCRIBE_KERNELS, "parallel TP words")
        counts_all.append(wc)
    # C8: bench-train --dp 2 through the command line on each rank
    for r, o in enumerate(outs):
        b = o["bench"]
        rec = b["rec"] or {}
        flash = {k: b["counts"][k] for k in CHILD_BENCH_LAUNCHES}
        if r == 0:
            print(f"[parallel] {' '.join(CHILD_BENCH_ARGV)} over gloo: exit "
                  f"{b['rc']}, mesh {rec.get('mesh')}, fsdp "
                  f"{rec.get('fsdp')}; {rec.get('value')} examples/s, "
                  f"{rec.get('sec_per_step')} s a step; {b['seconds']:.2f} s "
                  f"(host crossings); rank 0 3xTF32 launches {flash} "
                  f"(predicted {CHILD_BENCH_LAUNCHES}) ({smi})", flush=True)
        missing = set(BENCH_KEYS["bench-train"]) - set(rec)
        if (b["rc"] != 0 or missing
                or rec.get("mesh") != {"data": 2, "model": 1}
                or rec.get("fsdp") is not False
                or flash != CHILD_BENCH_LAUNCHES):
            raise AssertionError(f"bench-train --dp 2, rank {r}: {b}")
        _finite_numbers(rec, f"bench-train --dp 2, rank {r}")
        bc = _child_counts(b)
        _check_launches(bc, CLI_TRAIN_KERNELS[1:], "parallel bench --dp 2")
        _no_core_flash(bc, "parallel bench --dp 2")
        counts_all.append(bc)
    if "fsdp" in outs[0]:
        for r, o in enumerate(outs):
            for key in ("fsdp", "fsdp_int8"):
                f = o[key]
                frel = max(abs(a - b) / abs(b)
                           for a, b in zip(f["losses"], f["whole"]))
                int8 = key == "fsdp_int8"
                moved = f.get("codes_moved", 0) / max(f.get("codes", 1), 1)
                if r == 0:
                    q8 = (f"; past each step's rounding and the carried "
                          f"difference, max leaf rel "
                          f"{f['mu_excess_rel']:.2e} (tol "
                          f"{PARALLEL_FSDP_TOL['mu']:.0e}); the last step's "
                          f"codes moved {f['codes_moved']} of {f['codes']} "
                          f"({moved:.2e}, tol "
                          f"{PARALLEL_FSDP_TOL['codes']:.0e}, max "
                          f"{f['code_step_max']} steps), "
                          f"scales max leaf rel {f['scale_rel']:.2e}"
                          if int8 else "")
                    print(f"[parallel] FSDP (data 2) Whisper-base over gloo "
                          f"on one card, {'int8' if int8 else 'float32'} "
                          f"first moments, {PARALLEL_FSDP_STEPS} steps, "
                          f"{f['cut']} of {f['leaves']} leaves cut: losses "
                          f"{f['losses']} vs the whole run {f['whole']} (max "
                          f"rel {frel:.2e}, tol 1e-05); "
                          + ("" if int8 else "gathered ")
                          + f"first moments max leaf rel {f['mu_rel']:.2e}"
                          + ("" if int8 else
                             f" (tol {PARALLEL_FSDP_TOL['mu']:.0e})") + q8
                          + f"; updates p - p0 max leaf rel "
                          f"{f['update_rel']:.2e} (tol "
                          f"{PARALLEL_FSDP_TOL['update']:.0e})"
                          + f"; moment bytes a rank: m "
                          f"{f['mu_bytes'] / f['params']:.4f} B/param, v "
                          f"{f['nu_bytes'] / f['params']:.4f} B/param; "
                          f"{f['seconds']:.2f} s; launches "
                          f"{ {k: v for k, v in f['counts'].items() if v} } "
                          f"({smi})", flush=True)
                ok = (frel <= 1e-5 and f["cut"] > 0
                      and f["update_rel"] <= PARALLEL_FSDP_TOL["update"])
                if int8:
                    ok = (ok and moved <= PARALLEL_FSDP_TOL["codes"]
                          and f["mu_excess_rel"] <= PARALLEL_FSDP_TOL["mu"])
                else:
                    ok = ok and f["mu_rel"] <= PARALLEL_FSDP_TOL["mu"]
                if not ok:
                    raise AssertionError(f"FSDP {key} over gloo, rank {r}: "
                                         f"{f}")
                fc = _child_counts(f)
                _check_launches(fc, CLI_TRAIN_KERNELS[1:],
                                f"parallel {key}")
                _no_core_flash(fc, f"parallel {key}")
                counts_all.append(fc)
    return counts_all


def _child_counts(case):
    """A child case's launch counts ({kernel: cuda} and its "plain") in
    ``launch_counts()``'s form."""
    return {k: {"cuda": v, "plain": case["plain"].get(k, 0)}
            for k, v in case["counts"].items()}


def parallel_phase(torch, rng, smi, bench=None):
    """Data, tensor, fully-sharded and expert parallelism on the card.

    Part 1, a world of one over NCCL (``make_mesh`` on CUDA): each mesh
    path against the same path without a mesh on the card --
    ``finetune_whisper(mesh=, fsdp=True)`` at Whisper-base in float32
    (losses within 1e-5 relative, the 3xTF32 flash launches equal),
    ``ContinuousBatcher(mesh=)`` at Whisper-large-v3-turbo width with int8
    KV (the same tokens), ``moe_expert_parallel`` on one Qwen3-30B-A3B
    layer against ``_moe_block`` (``TOL_F32``), ``fit_lm(mesh=,
    fsdp=True)`` at Qwen3-0.6B width and ``PARALLEL_LM_LAYERS`` layers,
    ``bench-train --dp 1 --fsdp`` through the command line beside the bench
    phase's line without a mesh (``bench``: ``bench_phase``'s lines; the
    wgmma launches equal); and TP decoding and word timestamps at turbo
    width, the references for part 2. Part 2, a world of two processes on
    the one card over gloo (``parallel_child``): the gloo collective probe
    on CUDA tensors, TP decoding with 10 of turbo's 20 heads a rank (the
    same tokens as the world of one) and the clip's words (within one
    frame of the run without a mesh), ``bench-train --dp 2``, and FSDP
    (data 2) Whisper-base steps with float32 and int8 first moments where
    gloo carried their collectives, held by their moments and updates (the
    world of one's FSDP run cuts nothing: it shows the path runs on NCCL
    and the kernels, not the cut). Returns the launch counts of the mesh
    runs (the children's included)."""
    import dataclasses
    import os
    import subprocess
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from audax_torch.core.config import (FineTuneConfig, MelConfig,
                                         MeshConfig, WhisperConfig)
    from audax_torch.data.audio_io import write_wav
    from audax_torch.infer.continuous import ContinuousBatcher
    from audax_torch.infer.streaming import StreamingTranscriber
    from audax_torch.models import causal_lm as CL
    from audax_torch.models import whisper as W
    from audax_torch.ops import launch_counts, reset_launches
    from audax_torch.parallel.ep import moe_expert_parallel
    from audax_torch.parallel.mesh import make_mesh
    from audax_torch.parallel.sharding import shard_params
    from audax_torch.train.finetune_loop import (build_speech_dataset,
                                                 finetune_whisper)
    from audax_torch.train.lm import LMTrainConfig, fit_lm
    from audax_torch.train.two_tower_loop import fit_two_tower

    t_phase = time.perf_counter()
    counts_all = []

    def run(fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    def ran(counts):
        return {k: c["cuda"] for k, c in counts.items() if c["cuda"]}

    mesh = make_mesh(MeshConfig(), device="cuda")
    print(f"[parallel] world of one: backend {dist.get_backend()}, mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({smi})",
          flush=True)

    # ---- finetune_whisper(mesh=, fsdp=True), Whisper-base float32 ---------
    cfg = WhisperConfig.base()
    tok = _tokenizer()
    params = W.init_whisper_params(cfg, torch.Generator().manual_seed(31),
                                   device="cuda")
    with tempfile.TemporaryDirectory() as d:
        for i, text in enumerate(_transcripts(rng, tok, 4)):
            write_wav(os.path.join(d, f"p{i}.wav"),
                      _speechlike(rng, 30.0, pitch=110.0 + 20 * i), 16000)
            with open(os.path.join(d, f"p{i}.txt"), "w") as fh:
                fh.write(text)
        examples = build_speech_dataset(d, tok, MelConfig.whisper(cfg.n_mels),
                                        chunk_seconds=30.0)
    ft = FineTuneConfig(batch_size=4, max_steps=PARALLEL_STEPS, lora_rank=0,
                        moment_dtype="float32", learning_rate=1e-4,
                        warmup_steps=1, eval_every=10 ** 6)
    (_, h0), s0, c0 = run(lambda: finetune_whisper(params, cfg, tok,
                                                   examples, ft,
                                                   device="cuda"))
    (st1, h1), s1, c1 = run(lambda: finetune_whisper(
        params, cfg, tok, examples, ft, mesh=mesh, fsdp=True, device="cuda"))
    rel = max(abs(a - b) / abs(b) for a, b in zip(h1["loss"], h0["loss"]))
    flash = {k: (c1[k]["cuda"], c0[k]["cuda"]) for k in PARALLEL_FLASH}
    print(f"[parallel] finetune_whisper(mesh=, fsdp=True) Whisper-base f32, "
          f"{PARALLEL_STEPS} steps at B 4: losses {h1['loss']} vs without a "
          f"mesh {h0['loss']}, max rel diff {rel:.3e} (tol 1e-05); "
          f"{s1:.2f} s vs {s0:.2f} s; flash launches (mesh, none) {flash}; "
          f"launches {ran(c1)} ({smi})", flush=True)
    if rel > 1e-5 or any(a != b or a == 0 for a, b in flash.values()):
        raise AssertionError(f"finetune under a mesh: rel {rel}, {flash}")
    _check_launches(c1, FINETUNE_KERNELS[:4], "parallel finetune")
    _no_core_flash(c1, "parallel finetune")
    counts_all.append(c1)
    del st1, examples

    # ---- StreamingTranscriber(mesh=), Whisper-base, one window -------------
    window = _speechlike(rng, 30.0, pitch=150.0)

    def stream(m):
        st = StreamingTranscriber(params, cfg, tok, batch_slots=1,
                                  max_new_tokens=24, mesh=m, device="cuda")
        st.feed("mic", window)
        return [s.text for s in st.drain()]

    text0, ss0, _ = run(lambda: stream(None))
    text1, ss1, cs = run(lambda: stream(mesh))
    print(f"[parallel] StreamingTranscriber(mesh=) Whisper-base, one 30 s "
          f"window: text {text1!r} equal to the transcriber without a mesh "
          f"{text1 == text0}; {ss1:.2f} s vs {ss0:.2f} s; launches "
          f"{ran(cs)} ({smi})", flush=True)
    if text1 != text0 or not text1:
        raise AssertionError(f"streaming under a mesh: {text1} vs {text0}")
    _check_launches(cs, TRANSCRIBE_KERNELS, "parallel streaming")
    counts_all.append(cs)
    del params

    # ---- ContinuousBatcher(mesh=), turbo width, int8 KV --------------------
    tcfg = WhisperConfig.large_v3_turbo()
    ttok = _tokenizer(tcfg.vocab_size)
    tparams = W.init_whisper_params(
        tcfg, torch.Generator(device="cuda").manual_seed(32), device="cuda")
    clips = [_speechlike(rng, sec, pitch=120.0 + 10 * i)
             for i, sec in enumerate((30.0, 12.0, 21.0))]

    def serve(m, p):
        cb = ContinuousBatcher(p, tcfg, ttok, slots=2, kv_quant=True,
                               max_new_tokens=24, mesh=m, device="cuda")
        for i, c in enumerate(clips):
            cb.submit(f"r{i}", c)
        return {r.request_id: r.tokens for r in cb.run()}

    plain, sp, _ = run(lambda: serve(None, tparams))
    meshed, sm, cm = run(lambda: serve(mesh, shard_params(tparams, mesh)))
    print(f"[parallel] ContinuousBatcher(mesh=) turbo int8 KV, 3 requests "
          f"over 2 slots: tokens equal to the engine without a mesh "
          f"{meshed == plain} ({sum(len(v) for v in meshed.values())} "
          f"tokens); {sm:.2f} s vs {sp:.2f} s; launches {ran(cm)} ({smi})",
          flush=True)
    if meshed != plain:
        raise AssertionError(f"serving under a mesh: {meshed} vs {plain}")
    _check_launches(cm, DECODE_Q8_KERNELS, "parallel serve")
    counts_all.append(cm)
    del tparams

    # ---- TP decoding over the world of one: part 2's reference -------------
    _, tparams = _turbo_params(torch)
    ref_tokens, sr, cr = _turbo_tp_tokens(torch, mesh, tparams)
    print(f"[parallel] generate(mesh=) turbo, world of one: "
          f"{len(ref_tokens)} tokens in {sr:.2f} s; launches {ran(cr)} "
          f"({smi})", flush=True)
    _check_launches(cr, TRANSCRIBE_KERNELS, "parallel TP decode")
    counts_all.append(cr)
    # the same clip's word timestamps without a mesh: part 2's reference (C9)
    ref_words, sw, cw = _turbo_words(torch, None, tparams)
    print(f"[parallel] Transcriber(word_timestamps=True) turbo without a "
          f"mesh: {len(ref_words)} words in {sw:.2f} s; launches {ran(cw)} "
          f"({smi})", flush=True)
    if not ref_words:
        raise AssertionError("the turbo clip aligned no words")
    _check_launches(cw, TRANSCRIBE_KERNELS, "parallel words")
    counts_all.append(cw)
    del tparams
    torch.cuda.empty_cache()

    # ---- moe_expert_parallel, one Qwen3-30B-A3B layer -----------------------
    mcfg = dataclasses.replace(CL.CausalLMConfig.qwen3_30b_a3b(), layers=1)
    mp = CL.init_causal_lm(mcfg, torch.Generator(device="cuda").manual_seed(
        33), device="cuda")
    layer = W.layer_params(mp["layers"], 0)
    x = torch.randn(4, 64, mcfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(37))
    with torch.no_grad():
        ref, s_ref, _ = run(lambda: CL._moe_block(layer, mcfg, x))
        ep, s_ep, ce = run(lambda: moe_expert_parallel(layer, mcfg, x, mesh))
    err = float((ep - ref).abs().max()) / float(ref.abs().max())
    print(f"[parallel] moe_expert_parallel Qwen3-30B-A3B layer (E "
          f"{mcfg.num_experts}, k {mcfg.experts_per_tok}, d {mcfg.d_model}, "
          f"moe_ffn {mcfg.moe_ffn}) x [4, 64]: max rel err vs _moe_block "
          f"{err:.3e} (tol {TOL_F32:.0e}); {s_ep * 1e3:.1f} ms vs "
          f"{s_ref * 1e3:.1f} ms; launches {ran(ce)} ({smi})", flush=True)
    if not err <= TOL_F32:
        raise AssertionError(f"EP vs _moe_block: {err}")
    del mp, layer, x, ref, ep

    # ---- fit_lm(mesh=, fsdp=True), Qwen3-0.6B width ------------------------
    lcfg = dataclasses.replace(CL.CausalLMConfig.qwen3_0_6b(),
                               layers=PARALLEL_LM_LAYERS)
    lp = CL.init_causal_lm(lcfg, torch.Generator(device="cuda").manual_seed(
        38), device="cuda")
    corpus = rng.integers(0, 4000, 20000).astype(np.int32)
    tc = LMTrainConfig(max_steps=PARALLEL_STEPS, batch_size=4, seq_len=256,
                       eval_every=PARALLEL_STEPS, eval_windows=2,
                       warmup_steps=0)
    (_, l0), t0_, k0 = run(lambda: fit_lm(lp, lcfg, tc, corpus,
                                          device="cuda"))
    (_, l1), t1_, k1 = run(lambda: fit_lm(lp, lcfg, tc, corpus, mesh=mesh,
                                          fsdp=True, device="cuda"))
    rel = max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(l1, l0)
              for key in ("loss", "eval_loss"))
    flash = {k: (k1[k]["cuda"], k0[k]["cuda"]) for k in PARALLEL_FLASH}
    print(f"[parallel] fit_lm(mesh=, fsdp=True) Qwen3-0.6B width, "
          f"{PARALLEL_LM_LAYERS} layers, {PARALLEL_STEPS} steps at 4 x 256: "
          f"history {l1} vs without a mesh {l0}, max rel diff {rel:.3e} "
          f"(tol 1e-05); {t1_:.2f} s vs {t0_:.2f} s; flash launches (mesh, "
          f"none) {flash} ({smi})", flush=True)
    if rel > 1e-5 or any(a != b or a == 0 for a, b in flash.values()):
        raise AssertionError(f"fit_lm under a mesh: rel {rel}, {flash}")
    _no_core_flash(k1, "parallel fit_lm")
    counts_all.append(k1)
    del lp

    # ---- fit_two_tower(mesh=, fsdp=True), music_train's widths -------------
    tt_model, tt_ds, tt_steps = _two_tower_case(torch, np, rng)
    (_, th0), tt0, tk0 = run(lambda: fit_two_tower(
        tt_model, tt_ds, chunk_seconds=10.0, device="cuda"))
    (_, th1), tt1, tk1 = run(lambda: fit_two_tower(
        tt_model, tt_ds, chunk_seconds=10.0, mesh=mesh, fsdp=True,
        device="cuda"))
    same = all(th1[k] == th0[k] for k in ("train_loss", "val_loss"))
    print(f"[parallel] fit_two_tower(mesh=, fsdp=True) Qwen3-0.6B + "
          f"Whisper-base, {tt_steps} steps at batch "
          f"{tt_model.cfg.batch_size}: history {th1} bit-equal to the run "
          f"without a mesh {th0}: {same}; {tt1:.2f} s vs {tt0:.2f} s; "
          f"launches {ran(tk1)} ({smi})", flush=True)
    if not same:
        raise AssertionError(f"fit_two_tower under a mesh: {th1} vs {th0}")
    if ran(tk1) != ran(tk0):
        raise AssertionError(f"fit_two_tower launches {ran(tk1)} vs "
                             f"{ran(tk0)}")
    _check_launches(tk1, MUSIC_TRAIN_KERNELS, "parallel fit_two_tower")
    _no_core_flash(tk1, "parallel fit_two_tower")
    counts_all.append(tk1)
    del tt_model, tt_ds

    # ---- bench-train --dp 1 --fsdp, Whisper-base bf16 (C8) ----------------
    bpe = _tokenizer(51866).bpe
    counts_all.append(_mesh_bench_case(torch, bpe, bench, smi))

    # ---- the world of two's SP fine-tune, without a mesh -------------------
    bcfg, bparams, btok, bex, bft = _sp_finetune_inputs(torch, np)
    (_, sh), ssp, _ = run(lambda: finetune_whisper(bparams, bcfg, btok, bex,
                                                   bft, device="cuda"))
    sp_whole = sh["loss"]
    print(f"[parallel] the SP fine-tune's inputs without a mesh: losses "
          f"{sp_whole} in {ssp:.2f} s ({smi})", flush=True)
    del bparams, bex
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- part 2: a world of two on the one card over gloo ------------------
    t0 = time.perf_counter()
    p2p_dir = tempfile.TemporaryDirectory()
    p2p = {name: [subprocess.Popen(
        [sys.executable, "-c", P2P_CHILD, name, str(r),
         os.path.join(p2p_dir.name, name)], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)] for name in P2P_PROBES}
    for name in P2P_PROBES:
        os.makedirs(os.path.join(p2p_dir.name, name))
    with tempfile.TemporaryDirectory() as d:
        bpe.save(os.path.join(d, "tok"))
        procs = [subprocess.Popen([sys.executable, "-c", PARALLEL_CHILD,
                                   str(ROOT), str(r), d], cwd=str(ROOT),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"parallel children {bad} failed:\n"
                                 + "\n".join(lg[-3000:] for lg in logs))
        outs = []
        for r in range(2):
            with open(os.path.join(d, f"out{r}.json")) as fh:
                outs.append(json.load(fh))
    wall = time.perf_counter() - t0
    probe = outs[0]["probe"]
    for name, procs in p2p.items():
        res = []
        for p in procs:
            try:
                o, e = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
            lines = (e or "").strip().splitlines()
            res.append("ok" if p.returncode == 0 and '"ok": true' in o
                       else f"exit {p.returncode}: "
                       + ([ln for ln in lines if "what()" in ln or "Error"
                           in ln] or lines or [""])[-1][:160])
        probe[name] = "ok" if res == ["ok", "ok"] else "; ".join(res)
    p2p_dir.cleanup()
    carried = [k for k, v in probe.items() if v == "ok"]
    print(f"[parallel] world of two on one card, backend "
          f"{outs[0]['backend']}: gloo carried {carried} on CUDA tensors; "
          f"not: { {k: v for k, v in probe.items() if v != 'ok'} }; "
          f"ring_shift's exchange is all_to_all_single (gloo carried it "
          f"{probe['all_to_all_single'] == 'ok'}, point-to-point "
          f"{all(probe[k] == 'ok' for k in P2P_PROBES)}) ({smi})",
          flush=True)
    if probe["all_to_all_single"] != "ok":
        raise AssertionError("gloo does not carry all_to_all_single on "
                             "CUDA tensors: ring_shift cannot run")
    same = all(o["tokens"] == ref_tokens for o in outs)
    print(f"[parallel] generate(mesh=) turbo TP 2 over gloo: tokens equal to "
          f"the world of one {same}; {outs[0]['seconds']:.2f} s (world of "
          f"one {sr:.2f} s); rank 0 launches "
          f"{ {k: v for k, v in outs[0]['counts'].items() if v} } "
          f"(children and their start included: {wall:.2f} s) ({smi})",
          flush=True)
    if not same or any(o["plain"] for o in outs):
        raise AssertionError(f"TP decode over gloo: "
                             f"{[o['tokens'] for o in outs]} vs {ref_tokens};"
                             f" plain {[o['plain'] for o in outs]}")
    for o in outs:
        if not (o["counts"]["flash_forward_tf32x3"] > 0
                and o["counts"]["decode_attention_stacked"] > 0):
            raise AssertionError(f"TP decode child launches {o['counts']}")
        counts_all.append({k: {"cuda": v, "plain": 0}
                           for k, v in o["counts"].items()})
    counts_all += _check_children(outs, ref_words, sw, smi)
    if "fsdp" not in outs[0]:
        print("[parallel] FSDP (data 2) over gloo on one card: not run (gloo "
              "did not carry its collectives)", flush=True)
    for o in outs:
        got = _check_sp_pp(o["sp_pp"], sp_whole, smi)
        counts_all.append({k: {"cuda": got.get(k, 0), "plain": 0}
                           for k in launch_counts()})
    print(f"[parallel] phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({smi})", flush=True)
    return counts_all


def _two_tower_case(torch, np, rng):
    """The world of one's two-tower case at music_train's widths
    (Qwen3-0.6B + Whisper-base, the adapter's gates open, TwoTowerConfig's
    batch and target tokens): (model, in-memory dataset of 18 melodies of
    10 s, the epoch's train steps)."""
    from audax_torch.cli import main as cli
    from audax_torch.core.config import TwoTowerConfig, replace
    from audax_torch.data.synth import _random_melody, render_midi
    from audax_torch.models.causal_lm import CausalLMConfig
    from audax_torch.models.two_tower import build_two_tower
    from audax_torch.symbolic.abc import midi_to_abc

    dev = torch.device("cuda")
    tt = replace(TwoTowerConfig(), epochs=1)
    n = 2 * tt.batch_size + 2                    # 2 steps + 1 val + 1 over
    mfs = []
    for _ in range(n):
        mf, _ = _random_melody(rng, MUSIC_TRAIN_EVENTS, 100, low=48,
                               high=84, max_poly=3)
        mfs.append(mf.cut(10.0) if mf.duration_seconds > 10.0 else mf)
    abcs = [midi_to_abc(m, title=f"melody_{i:03d}") for i, m in
            enumerate(mfs)]
    bpe = _abc_tokenizer(rng, CausalLMConfig.qwen3_0_6b().vocab_size,
                         tunes=abcs)
    ds = _MemoryMusic(_music_examples(np, bpe, mfs, abcs,
                                      [render_midi(m, 16000) for m in mfs],
                                      tt.max_target_tokens), bpe)
    model = build_two_tower(tt, cli._whisper_preset(tt.whisper_size),
                            cli._lm_preset(MUSIC_LM, 2048), len(bpe),
                            torch.Generator(device=dev).manual_seed(40),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(41)
    for gate in ("out", "ffn_out"):
        k = model.params["adapter"][gate]["kernel"]
        model.params["adapter"][gate]["kernel"] = torch.randn(
            k.shape, generator=g, device=dev) / math.sqrt(k.shape[0])
    n_val = max(1, int(n * 0.1))
    return model, ds, (n - n_val) // tt.batch_size


def _sp_finetune_inputs(torch, np):
    """The SP fine-tune case's inputs, the same in the parent (the run
    without a mesh) and in both children: Whisper-base from seed 36, four
    30 s clips with their labels, ``SP_FT_STEPS`` full float32 steps at
    B 4 with remat, no warm-up."""
    from audax_torch.core.config import FineTuneConfig, WhisperConfig
    from audax_torch.models import whisper as W

    bcfg = WhisperConfig.base()
    tok = _tokenizer()
    bparams = W.init_whisper_params(bcfg, torch.Generator().manual_seed(36),
                                    device="cuda")
    rng = np.random.default_rng(36)
    examples = [{"audio": _speechlike(rng, 30.0, pitch=110.0 + 20 * i),
                 "labels": tok.sot_sequence(lang="en") + tok.encode(text)
                 + [tok.eot], "text": text, "file": f"sp{i}"}
                for i, text in enumerate(_transcripts(rng, tok, 4))]
    ft = FineTuneConfig(batch_size=4, max_steps=SP_FT_STEPS, lora_rank=0,
                        moment_dtype="float32", learning_rate=1e-4,
                        warmup_steps=0, eval_every=10 ** 6)
    return bcfg, bparams, tok, examples, ft


def _sp_pp_predicted(case, o):
    """The K2/K7/K8 launches a rank of the world of two makes in ``case``
    of ``_sp_pp_child`` (3xTF32 bodies: float32 throughout)."""
    if case == "sp_ring":                        # a launch per held block
        return {"flash_forward_tf32x3": 2 * o["layers"]}
    if case == "sp_ulysses":
        return {"flash_forward_tf32x3": o["layers"]}
    if case == "pp_encode":                      # 3 ticks x a stage's layers
        return {"flash_forward_tf32x3": 3 * o["layers"] // 2}
    if case == "sp_finetune":
        enc, dec = o["layers"]
        r = 2 if o["remat"] else 1              # the recompute replays K2
        return {"flash_forward_tf32x3": SP_FT_STEPS * r * (2 * enc + 2 * dec),
                "flash_backward_dq_tf32x3": SP_FT_STEPS * (2 * enc
                                                           + 2 * dec),
                "flash_backward_dkv_tf32x3": SP_FT_STEPS * (2 * enc
                                                            + 2 * dec)}
    ticks = 2 + 2 - 1                            # n_micro + stages - 1
    layers = PP_LM_LAYERS // 2
    return {"flash_forward_tf32x3": PP_LM_STEPS * 2 * ticks * layers,
            "flash_backward_dq_tf32x3": PP_LM_STEPS * ticks * layers,
            "flash_backward_dkv_tf32x3": PP_LM_STEPS * ticks * layers}


def _check_sp_pp(r, sp_whole, smi):
    """Print and hold one rank's ``_sp_pp_child`` results (``sp_whole``:
    the SP fine-tune's losses without a mesh); returns the launches of its
    cases, summed."""
    total = {}
    for case, o in r.items():
        want = _sp_pp_predicted(case, o)
        got = {k: o["counts"].get(k, 0) for k in want}
        for k, v in o["counts"].items():
            total[k] = total.get(k, 0) + v
        if case in ("sp_ring", "sp_ulysses", "pp_encode"):
            line = (f"max rel err vs encode {o['rel']:.3e} (tol "
                    f"{SP_TOL:.0e})")
            bad = not o["rel"] <= SP_TOL
        elif case == "sp_finetune":
            rel = max(abs(a - b) / abs(b) for a, b in zip(o["losses"],
                                                          sp_whole))
            line = (f"losses {o['losses']} vs without a mesh {sp_whole} "
                    f"max rel {rel:.3e} (tol {SP_TOL:.0e})")
            bad = not rel <= SP_TOL
        else:
            rel = max(abs(a - b) / abs(b) for a, b in zip(o["losses"],
                                                          o["whole"]))
            ex, ew = o["excess"], o["excess_whole"]
            worst = max(ex, key=ex.get)
            worst_whole = max(ew, key=ew.get)
            line = (f"losses {o['losses']} vs the one-rank step "
                    f"{o['whole']} max rel {rel:.3e} (tol "
                    f"{PP_LM_TOL['loss']:.0e}); every leaf of this stage "
                    f"against the one-stage pipeline step (the same two "
                    f"microbatches): worst |diff| - rtol |ref| "
                    f"{ex[worst]:.3e} at {worst} (atol "
                    f"{PP_LM_TOL['atol']:.0e}); against the one-rank step "
                    f"{ew[worst_whole]:.3e} at {worst_whole} (not held: "
                    f"AdamW where a first gradient is below its eps 1e-8 "
                    f"turns the two batchings' rounding into ~0.4 lr, "
                    f"PERF.md §6); q {o['q_local']}")
            bad = (not rel <= PP_LM_TOL["loss"]
                   or not ex[worst] <= PP_LM_TOL["atol"])
        print(f"[parallel] {case} over gloo (world of two): {line}; "
              f"{o['seconds']:.2f} s; launches {got} (predicted {want}); "
              f"all {o['counts']} ({smi})", flush=True)
        if bad or got != want or o["plain"]:
            raise AssertionError(f"{case}: {o}")
        _no_core_flash({k: {"cuda": o["counts"].get(k, 0)} for k in FLASH},
                       case)
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

    # P1, K2's head folds on its tensor-core bodies (the template argument
    # FOLD last): registers of each folded instantiation, where a spill
    # fails
    for name, n_folds in FOLD_LIBS:
        if name not in reports:
            print(f"[build] {name} was built before: its folds' registers "
                  "and spills are not reported", flush=True)
            continue
        folded = [kn for kn in _ptxas_kernels(reports[name])
                  if kn[0].split(",")[-1] in ("2", "4")]
        print(f"[build] {name} folds ptxas (template arguments, FOLD last: "
              "registers, spill bytes): " + "; ".join(
                  f"{a}: {r}, {sp}" for a, r, sp in folded), flush=True)
        if len(folded) != n_folds or any(sp for _, _, sp in folded):
            raise AssertionError(f"{name}: a folded instantiation spills "
                                 f"(or is missing): {folded}")

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
    # K3's and K6's sm90 body: registers of each instantiation by head dim
    # (float32, bf16, and the int8 arm with float32 and bf16 q; each with
    # the PV pass of many rows and of one), where a spill fails
    if "decode_attention_sm90" in reports:
        kernels = _ptxas_kernels(reports["decode_attention_sm90"])
        print("[build] decode_attention_sm90 ptxas (head dim: registers, "
              "spill bytes): " + "; ".join(f"{a}: {r}, {sp}"
                                            for a, r, sp in kernels),
              flush=True)
        if len(kernels) != 32 or any(sp for _, _, sp in kernels):
            raise AssertionError(f"decode_attention_sm90 spills (or lacks "
                                 f"an instantiation): {kernels}")
    else:
        print("[build] decode_attention_sm90 was built before: its "
              "registers and spills are not reported", flush=True)

    # K9's tensor-core source and the int4 tools' bodies built from it:
    # registers and spills of each instantiation
    for name in INT4_MMA_LIBS:
        if name not in reports:
            print(f"[build] {name} was built before: its registers and "
                  "spills are not reported", flush=True)
            continue
        print(f"[build] {name} ptxas (route,dtype,vec,nt: registers, spill "
              "bytes): " + "; ".join(f"{a}: {r}, {sp}" for a, r, sp in
                                     _int4mma_kernels(reports[name])),
              flush=True)

    rng = np.random.default_rng(0)
    kern = kernel_phase(torch, rng)
    k9_index_cases(torch)
    k9_trap_cases(torch)
    precision_check(torch)
    transcribe = main_path_phase(torch, rng)
    decoders = decoders_phase(torch, rng, smi)
    train = finetune_phase(torch, rng, profile=args.profile)
    serve, k6 = serve_phase(torch, rng, profile=args.profile)
    classify = classify_phase(torch, profile=args.profile)
    probes = probes_phase(torch)
    tools = attention_tools_phase(torch)
    # on a generator of its own, so the phases before it draw what they drew
    music = music_phase(torch, np.random.default_rng(19), smi)
    music_train = music_train_phase(torch, np.random.default_rng(20), smi)
    moe_serve = moe_serve_phase(torch, np.random.default_rng(21), smi)
    moe_train = moe_train_phase(torch, np.random.default_rng(22), smi)
    moe_probe_phase(torch)
    cli = cli_phase(torch, np.random.default_rng(23), smi)
    bench, bench_lines = bench_phase(torch, np.random.default_rng(24), smi)
    parallel = parallel_phase(torch, np.random.default_rng(25), smi,
                              bench=bench_lines)
    # launches of the main paths, each counted from 0 just before it; the
    # tools' kernels from the probes phase; K2/K7/K8 and P1 from the
    # attention tools as well
    launches = {k: sum(p[k]["cuda"] for p in (transcribe, decoders, train,
                                              serve, k6, classify, *music,
                                              *music_train, *moe_serve,
                                              *moe_train, *cli, *bench,
                                              *parallel))
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
               "flash_forward_fold": (
                   "audax_torch/csrc/flash_fwd_sm90.cu, "
                   "audax_torch/csrc/flash_fwd_tf32x3.cu",
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
                   "audax_torch/csrc/decode_attention_sm90.cu",
                   "audax/ops/attention.py:680"),
               "decode_attention_stacked_int8": (
                   "audax_torch/csrc/decode_attention_sm90.cu",
                   "audax/ops/attention.py:680"),
               "decode_attention": (
                   "audax_torch/csrc/decode_attention_sm90.cu",
                   "audax/ops/attention.py:547"),
               "int4_matmul": ("audax_torch/csrc/int4_matmul.cu",
                               "audax/ops/int4_matmul.py:236"),
               "int4_matmul_mma": ("audax_torch/csrc/int4_matmul_mma.cu",
                                   "audax/ops/int4_matmul.py:236"),
               "int4_word_matmul": ("audax_torch/csrc/int4_word_matmul.cu",
                                    "tools/int4_layout_ab.py:107"),
               "int4_word_matmul_mma": (
                   "audax_torch/csrc/int4_matmul_mma.cu",
                   "tools/int4_layout_ab.py:107"),
               "int4_plane_matmul": ("audax_torch/csrc/int4_word_matmul.cu",
                                     "tools/int4_plane_probe.py:114"),
               "int4_plane_matmul_mma": (
                   "audax_torch/csrc/int4_matmul_mma.cu",
                   "tools/int4_plane_probe.py:114"),
               "w4a8_matmul": ("audax_torch/csrc/w4a8_matmul.cu",
                               "tools/w4a8_probe.py:66"),
               "int4_unpack_v1": ("audax_torch/csrc/int4_unpack_variants.cu",
                                  "tools/int4_unpack_probe.py:105"),
               "int4_unpack_v1_mma": ("audax_torch/csrc/int4_matmul_mma.cu",
                                      "tools/int4_unpack_probe.py:105"),
               "int4_unpack_v2": ("audax_torch/csrc/int4_unpack_variants.cu",
                                  "tools/int4_unpack_probe.py:105"),
               "int4_unpack_v2_mma": ("audax_torch/csrc/int4_matmul_mma.cu",
                                      "tools/int4_unpack_probe.py:105"),
               "w4a8_matmul_mma": ("audax_torch/csrc/int4_matmul_mma.cu",
                                   "tools/w4a8_probe.py:66")}
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
