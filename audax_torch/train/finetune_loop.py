"""Whisper fine-tune loop: dataset build, step loop, periodic WER eval and
best-by-WER tracking, and the synthetic MIDI fine-tune proof (port of
``audax/train/finetune_loop.py``: ``build_speech_dataset``, ``eval_wer``,
``finetune_whisper``, ``midi_finetune_proof``).

On the card every part of a step runs there: the batch's audio is gathered
from a device copy of the dataset, the log-mel kernel (K1) computes its
mels, and the step runs the flash kernels forward (K2) and backward (K7,
K8). The periodic eval serves the trained weights through ``Transcriber``,
whose decode reads the stacked decode-attention kernel (K3).

Batches are drawn exactly as the JAX loop draws them
(``np.random.default_rng(cfg.seed).choice``), so both packages train on the
same examples in the same order. Under a mesh every rank draws the same
batch and keeps its rows (``finetune_whisper``); under a sequence-parallel
mesh (``sp_mesh``) every rank takes the same global batch into the DP x SP
step (``parallel/sp.py``).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audax_torch.core.config import FineTuneConfig, MelConfig, WhisperConfig
from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.data.audio_io import read_wav, resample, to_mono
from audax_torch.eval.wer import word_error_rate
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.infer.transcribe import Transcriber
from audax_torch.models.whisper import tree_map
from audax_torch.ops.augment import spec_augment
from audax_torch.parallel.fsdp import shard_state
from audax_torch.parallel.mesh import axis_size, batch_size, shard_batch
from audax_torch.symbolic.tokenizer import WhisperTokenizer
from audax_torch.train.ema import ema_init, ema_model_params, ema_update
from audax_torch.train.metrics_sink import MetricsSink
from audax_torch.train.seq2seq import (FTState, collate_seq2seq,
                                       init_finetune, make_finetune_step)

log = get_logger("audax_torch.finetune")

__all__ = ["build_speech_dataset", "finetune_whisper", "eval_wer",
           "midi_finetune_proof"]


def _pad_or_trim(x: np.ndarray, n: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x[:n] if len(x) >= n else np.pad(x, (0, n - len(x)))


def build_speech_dataset(
    audio_dir: str, tokenizer: WhisperTokenizer, mel_cfg: MelConfig,
    *, transcript: Optional[str] = None, lang: str = "en",
    chunk_seconds: float = 30.0, labels_csv: Optional[str] = None,
) -> List[Dict]:
    """Wavs + transcripts -> examples with padded audio + label ids.

    Transcript sources, in priority order: ``labels_csv`` (filename,labels
    rows), ``transcript`` (one shared target string), per-file ``.txt``
    sidecars. Labels are the SOT sequence, the text's tokens and EOT.
    """
    csv_labels: Dict[str, str] = {}
    if labels_csv:
        with open(labels_csv, newline="") as fh:
            for row in csv.DictReader(fh):
                csv_labels[os.path.basename(row["filename"])] = row["labels"]
    n_samples = int(chunk_seconds * mel_cfg.sample_rate)
    examples = []
    paths = sorted(glob.glob(os.path.join(audio_dir, "*.wav"))) if audio_dir \
        else []
    if labels_csv and not paths:
        with open(labels_csv, newline="") as fh:
            paths = [row["filename"] for row in csv.DictReader(fh)]
    for path in paths:
        try:
            x, rate = read_wav(path)
            x = to_mono(x)
            if rate != mel_cfg.sample_rate:
                x = resample(x, rate, mel_cfg.sample_rate)
            x = _pad_or_trim(x, n_samples)
            sidecar = os.path.splitext(path)[0] + ".txt"
            base = os.path.basename(path)
            if base in csv_labels:
                text = csv_labels[base]
            elif transcript is not None:
                text = transcript
            elif os.path.exists(sidecar):
                with open(sidecar) as fh:
                    text = fh.read().strip()
            else:
                log.warning("no transcript for %s; skipped", path)
                continue
            labels = (tokenizer.sot_sequence(lang=lang)
                      + tokenizer.encode(text) + [tokenizer.eot])
            examples.append({"audio": x, "text": text, "labels": labels,
                             "file": base})
        except Exception as e:
            log.warning("skip %s: %s", path, e)
    log.info("built dataset: %d examples", len(examples))
    return examples


def eval_wer(transcriber: Transcriber, examples: Sequence[Dict]) -> float:
    refs, hyps = [], []
    for ex in examples:
        refs.append(ex["text"])
        hyps.append(transcriber.transcribe(ex["audio"]).text)
    return word_error_rate(refs, hyps)


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def finetune_whisper(
    params, model_cfg: WhisperConfig, tokenizer: WhisperTokenizer,
    examples: Sequence[Dict], cfg: FineTuneConfig,
    *, mel_cfg: Optional[MelConfig] = None,
    sink: Optional[MetricsSink] = None,
    eval_examples: Optional[Sequence[Dict]] = None,
    lora_targets: Tuple[str, ...] = ("attn/q", "attn/v"),
    mesh=None, fsdp: bool = False, sp_mesh=None,
    eval_suppress_tokens="-1",
    device: DeviceLike = None,
) -> Tuple[FTState, Dict]:
    """Step-based fine-tune with periodic WER eval; returns (state,
    history). ``state.model_params()`` yields the serving weights (LoRA
    merged). The caller's ``params`` are never modified: a full fine-tune
    trains a copy, LoRA freezes them.

    ``history`` holds "loss" (one float per step, fetched from the device
    every ``cfg.loss_fetch_every`` steps), "wer" (``{"step", "wer"}`` per
    eval), "best_wer", "best_params" (a copy of the best serving weights)
    and, with EMA on, "ema_params". ``eval_suppress_tokens`` feeds the eval
    ``Transcriber``. ``device=None`` means the CUDA card.

    ``mesh`` (a (data, model) mesh, ``parallel/mesh.py:make_mesh``) runs
    the same step on every rank of it: parameters Megatron-TP-cut over
    'model' (``WHISPER_TP_RULES``), every batch's rows cut over 'data',
    the summed loss, token count and the gradients of replicated leaves
    all-reduced. ``fsdp=True`` also cuts parameters and Adam moments over
    'data' (ZeRO-3, ``parallel/fsdp.py``). The returned state then holds
    this rank's blocks; ``state.full_params()`` gathers the serving tree,
    and "best_params" / "ema_params" are whole. Evaluation runs whole on
    every rank, as in JAX.

    ``sp_mesh`` (a ("data", "seq") mesh, ``parallel/mesh.py:
    make_named_mesh``) instead runs the DP x SP ring-attention step
    (``parallel/sp.py:make_sp_finetune_step``): the mel frames are cut over
    'seq' inside the encoder, so windows whose encoder activations exceed
    one card still train; the batch's rows go over 'data'. The state stays
    whole on every rank and every rank applies the same update. Exclusive
    of ``mesh``/``fsdp``; ``accum_steps`` composes (its microbatches run
    outside the ring)."""
    if sp_mesh is not None and (mesh is not None or fsdp):
        raise ValueError("sp_mesh is mutually exclusive with mesh/fsdp")
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    device = resolve_device(device)
    mel_cfg = mel_cfg or MelConfig.whisper(model_cfg.n_mels)
    frontend = LogMelFrontend(mel_cfg, device=device, whisper_frames=True)
    params = tree_map(lambda t: t.to(device), params)
    # every rank builds the same whole state (same seed), then keeps its
    # blocks: the adapters are drawn at their whole shapes
    state = init_finetune(params, cfg, lora_targets=lora_targets)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp, heads=model_cfg.heads)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if sp_mesh is not None:
        from audax_torch.parallel.sp import make_sp_finetune_step
        step_fn = make_sp_finetune_step(model_cfg, sp_mesh, cfg, dtype=dtype)
    else:
        step_fn = make_finetune_step(
            model_cfg, remat=cfg.gradient_checkpointing, dtype=dtype,
            accum_steps=cfg.accum_steps)

    audio = torch.from_numpy(
        np.stack([ex["audio"] for ex in examples]).astype(np.float32)
    ).to(device)
    label_rows = [ex["labels"] for ex in examples]
    rng = np.random.default_rng(cfg.seed)
    aug_gen = (torch.Generator(device=device).manual_seed(cfg.seed)
               if cfg.spec_augment else None)
    history: Dict[str, list] = {"loss": [], "wer": []}
    pending: list = []                      # (step, on-device loss scalar)
    fetch_every = max(1, int(cfg.loss_fetch_every))
    best_wer = float("inf")
    best_params = None
    ema = ema_init(state.trainable) if cfg.ema_decay > 0.0 else None

    n = len(examples)
    # realized batch size: capped by the dataset, rounded to a multiple of
    # accum_steps x the data ranks; tiny datasets round UP (sample with
    # replacement)
    div = max(1, cfg.accum_steps) * (
        axis_size(sp_mesh, "data") if sp_mesh is not None
        else 1 if mesh is None else batch_size(mesh))
    bsz = min(cfg.batch_size, n)
    bsz = max(div, (bsz // div) * div)
    for step in range(cfg.max_steps):
        idx = rng.choice(n, size=bsz, replace=n < bsz)
        mel = frontend(audio[torch.from_numpy(idx).to(device)])
        if aug_gen is not None:
            # SpecAugment on the TRAIN batch only (eval sees clean mels)
            mel = spec_augment(aug_gen, mel, time_masks=cfg.sa_time_masks,
                               freq_masks=cfg.sa_freq_masks,
                               max_time_width=cfg.sa_max_time_width,
                               max_freq_width=cfg.sa_max_freq_width)
        coll = collate_seq2seq([label_rows[i] for i in idx],
                               decoder_start_id=tokenizer.sot)
        batch = {"mel": mel,
                 "decoder_input_ids": torch.from_numpy(
                     coll["decoder_input_ids"]).to(device),
                 "labels": torch.from_numpy(coll["labels"]).to(device)}
        if mesh is not None:
            # every rank draws the same global batch; each keeps its rows
            batch = shard_batch(mesh, batch, device)
        state, m = step_fn(state, batch)
        if ema is not None:
            ema = ema_update(ema, state.trainable, cfg.ema_decay, state.step)
        # the loss stays on the device and is fetched in chunks: a host
        # read every step would wait for the device every step
        pending.append((step, m["loss"]))
        do_eval = bool(eval_examples) and (step + 1) % cfg.eval_every == 0
        if (len(pending) >= fetch_every or do_eval
                or step == cfg.max_steps - 1):
            fetched = torch.stack([d for _, d in pending]).cpu().numpy()
            for (s, _), loss in zip(pending, fetched):
                loss = float(loss)
                history["loss"].append(loss)
                if sink:
                    sink.log({"loss": loss}, step=s, echo=(s + 1) % 10 == 0)
                elif (s + 1) % 10 == 0:
                    log.info("step %d loss %.4f", s, loss)
            pending.clear()

        if do_eval:
            # with EMA on, WER and the best checkpoint use the averaged
            # weights -- the tree one would serve
            if mesh is not None:
                serving = state.full_params(ema)
            elif ema is not None:
                serving = ema_model_params(state, ema)
            else:
                serving = state.model_params()
            # window from the model's encoder context, not a fixed 30 s
            win_s = (2 * model_cfg.n_audio_ctx * mel_cfg.hop_length
                     / mel_cfg.sample_rate)
            tr = Transcriber(serving, model_cfg, tokenizer,
                             chunk_seconds=win_s,
                             suppress_tokens=eval_suppress_tokens,
                             device=device)
            wer = eval_wer(tr, eval_examples)
            history["wer"].append({"step": step, "wer": wer})
            if wer < best_wer:
                best_wer = wer
                # a copy: the next step updates the trainable tensors in place
                best_params = _copy(serving)
            if sink:
                sink.log({"step": step, "wer": 100.0 * wer}, step=step)
    history["best_wer"] = best_wer
    history["best_params"] = best_params
    if ema is not None:
        history["ema_params"] = _copy(
            ema_model_params(state, ema) if mesh is None
            else state.full_params(ema))
    return state, history


def midi_finetune_proof(
    out_dir: str,
    *,
    num_items: int = 16,
    notes_per_item: int = 3,
    steps: int = 80,
    chunk_seconds: float = 6.0,
    d_model: int = 64,
    layers: int = 2,
    seed: int = 0,
    holdout_items: int = 6,
    augment: bool = False,
    moment_dtype: str = "float32",
    device: DeviceLike = None,
) -> Dict:
    """End-to-end synthetic fine-tune proof on ``device`` (default the CUDA
    card): a note-name dataset from the MIDI datagen
    (``data/synth.py:make_midi_dataset``), a byte-level BPE over its labels,
    a compact random Whisper (drawn from a CPU ``torch.Generator`` seeded
    ``seed``), transcriptions BEFORE, ``finetune_whisper``, transcriptions
    AFTER (float32 and bfloat16), and a comparison CSV (file, target,
    previous, finetuned, finetuned_bf16, split) plus a metrics JSON in
    ``out_dir``. ``holdout_items`` clips of the same distribution with a
    disjoint seed are never trained on. ``augment`` widens the TRAIN
    datagen (velocity/gain jitter, noise at 25 dB SNR) and turns on
    SpecAugment's frequency masks; the holdout stays clean. Returns the WERs
    and the two paths."""
    import json

    from audax_torch.core.config import DataGenConfig
    from audax_torch.data.synth import make_midi_dataset
    from audax_torch.eval.wer import word_error_rate
    from audax_torch.models.whisper import init_whisper_params
    from audax_torch.ops.augment import (SHORT_CLIP_FREQ_WIDTH,
                                         SHORT_CLIP_TIME_WIDTH)
    from audax_torch.symbolic.bpe import train_bpe

    device = resolve_device(device)
    gen = DataGenConfig(num_items=num_items, notes_per_item=notes_per_item,
                        out_dir=os.path.join(out_dir, "datagen"), seed=seed,
                        velocity_jitter=20 if augment else 0,
                        gain_jitter_db=6.0 if augment else 0.0,
                        noise_snr_db=25.0 if augment else 0.0)
    labels_csv = make_midi_dataset(gen)
    holdout_csv = None
    if holdout_items > 0:
        holdout_csv = make_midi_dataset(DataGenConfig(
            num_items=holdout_items, notes_per_item=notes_per_item,
            out_dir=os.path.join(out_dir, "datagen_holdout"), seed=seed + 1))
    with open(labels_csv, newline="") as fh:
        label_texts = [row["labels"] for row in csv.DictReader(fh)]
    # tokenizer over the TRAIN labels only (byte-level fallback covers the
    # holdout's)
    tokenizer = WhisperTokenizer(
        train_bpe(label_texts, vocab_size=320,
                  special_tokens=["<|MIDI|>", "<|/MIDI|>"]))
    frames = int(chunk_seconds * 16000) // 160          # whisper hop 160
    model_cfg = WhisperConfig(
        n_mels=80, n_audio_ctx=frames // 2, d_model=d_model,
        encoder_layers=layers, decoder_layers=layers,
        heads=max(2, d_model // 32), vocab_size=tokenizer.vocab_size,
        n_text_ctx=64)
    mel_cfg = MelConfig.whisper(80)
    params = init_whisper_params(model_cfg, torch.Generator().manual_seed(
        seed), device=device)
    examples = build_speech_dataset("", tokenizer, mel_cfg,
                                    labels_csv=labels_csv,
                                    chunk_seconds=chunk_seconds)
    if not examples:
        raise RuntimeError("the datagen produced no usable examples")
    holdout = build_speech_dataset("", tokenizer, mel_cfg,
                                   labels_csv=holdout_csv,
                                   chunk_seconds=chunk_seconds) \
        if holdout_csv else []

    def snapshot(p, exs, dtype=torch.float32):
        # suppress_tokens=[]: the default non-speech ban includes '#', a
        # third of the note-name alphabet
        tr = Transcriber(p, model_cfg, tokenizer, max_new_tokens=24,
                         temperature_fallback=False, suppress_tokens=[],
                         chunk_seconds=chunk_seconds, dtype=dtype,
                         device=device)
        return {ex["file"]: tr.transcribe(ex["audio"]).text for ex in exs}

    def wer_of(snap, exs):
        return word_error_rate([ex["text"] for ex in exs],
                               [snap[ex["file"]] for ex in exs])

    before = snapshot(params, examples)
    wer_before = wer_of(before, examples)
    before_h = snapshot(params, holdout) if holdout else {}
    holdout_wer_before = wer_of(before_h, holdout) if holdout else None

    ft = FineTuneConfig(learning_rate=1e-3, warmup_steps=5, max_steps=steps,
                        eval_every=steps, batch_size=8, lora_rank=0,
                        seed=seed, moment_dtype=moment_dtype,
                        spec_augment=augment, sa_time_masks=0,
                        sa_max_time_width=SHORT_CLIP_TIME_WIDTH,
                        sa_max_freq_width=SHORT_CLIP_FREQ_WIDTH)
    state, history = finetune_whisper(params, model_cfg, tokenizer, examples,
                                      ft, mel_cfg=mel_cfg,
                                      eval_examples=examples,
                                      eval_suppress_tokens=[], device=device)
    serving = state.model_params()
    after = snapshot(serving, examples)
    wer_after = wer_of(after, examples)
    after_h = snapshot(serving, holdout) if holdout else {}
    holdout_wer_after = wer_of(after_h, holdout) if holdout else None
    after_bf16 = snapshot(serving, examples, dtype=torch.bfloat16)
    wer_after_bf16 = wer_of(after_bf16, examples)

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "midi_finetune_comparison.csv")
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["file", "target", "previous",
                                           "finetuned", "finetuned_bf16",
                                           "split"])
        w.writeheader()
        for ex in examples:
            w.writerow({"file": ex["file"], "target": ex["text"],
                        "previous": before[ex["file"]],
                        "finetuned": after[ex["file"]],
                        "finetuned_bf16": after_bf16[ex["file"]],
                        "split": "train"})
        for ex in holdout:
            w.writerow({"file": ex["file"], "target": ex["text"],
                        "previous": before_h[ex["file"]],
                        "finetuned": after_h[ex["file"]],
                        "finetuned_bf16": "", "split": "holdout"})
    metrics = {"wer_before": round(float(wer_before), 4),
               "wer_after": round(float(wer_after), 4),
               "wer_after_bf16": round(float(wer_after_bf16), 4),
               "steps": steps, "items": len(examples),
               "augment": augment, "moment_dtype": moment_dtype,
               "loss_first": round(history["loss"][0], 4),
               "loss_last": round(history["loss"][-1], 4)}
    if holdout:
        metrics["holdout_items"] = len(holdout)
        metrics["holdout_wer_before"] = round(float(holdout_wer_before), 4)
        metrics["holdout_wer_after"] = round(float(holdout_wer_after), 4)
    metrics_path = os.path.join(out_dir, "midi_finetune_metrics.json")
    with open(metrics_path, "w") as fh:
        json.dump(metrics, fh, indent=2)
    log.success("fine-tune proof: WER %.3f -> %.3f (bf16 %.3f; holdout "
                "%s -> %s) (%s)", wer_before, wer_after, wer_after_bf16,
                holdout_wer_before, holdout_wer_after, csv_path)
    return {"wer_before": wer_before, "wer_after": wer_after,
            "wer_after_bf16": wer_after_bf16,
            "holdout_wer_before": holdout_wer_before,
            "holdout_wer_after": holdout_wer_after,
            "csv": csv_path, "metrics": metrics_path, **metrics}
