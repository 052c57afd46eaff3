"""Whisper fine-tune loop: dataset build, step loop, periodic WER eval and
best-by-WER tracking (port of ``audax/train/finetune_loop.py``:
``build_speech_dataset``, ``eval_wer``, ``finetune_whisper``).

On the card every part of a step runs there: the batch's audio is gathered
from a device copy of the dataset, the log-mel kernel (K1) computes its
mels, and the step runs the flash kernels forward (K2) and backward (K7,
K8). The periodic eval serves the trained weights through ``Transcriber``,
whose decode reads the stacked decode-attention kernel (K3).

Batches are drawn exactly as the JAX loop draws them
(``np.random.default_rng(cfg.seed).choice``), so both packages train on the
same examples in the same order. The mesh, FSDP and sequence-parallel
modes belong to the parallelism slice of the port; the synthetic MIDI
fine-tune proof waits for the data-generation slice.
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
from audax_torch.symbolic.tokenizer import WhisperTokenizer
from audax_torch.train.ema import ema_init, ema_model_params, ema_update
from audax_torch.train.metrics_sink import MetricsSink
from audax_torch.train.seq2seq import (FTState, collate_seq2seq,
                                       init_finetune, make_finetune_step)

log = get_logger("audax_torch.finetune")

__all__ = ["build_speech_dataset", "finetune_whisper", "eval_wer"]


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
    ``Transcriber``. ``device=None`` means the CUDA card."""
    for name, value in (("mesh", mesh), ("fsdp", fsdp), ("sp_mesh", sp_mesh)):
        if value not in (None, False):
            raise NotImplementedError(
                f"finetune_whisper({name}=...) arrives with the parallelism "
                "slice of the port (data/tensor/sequence-parallel training)")
    device = resolve_device(device)
    mel_cfg = mel_cfg or MelConfig.whisper(model_cfg.n_mels)
    frontend = LogMelFrontend(mel_cfg, device=device, whisper_frames=True)
    params = tree_map(lambda t: t.to(device), params)
    state = init_finetune(params, cfg, lora_targets=lora_targets)
    step_fn = make_finetune_step(
        model_cfg, remat=cfg.gradient_checkpointing,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
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
    # accum_steps; tiny datasets round UP (sample with replacement)
    div = max(1, cfg.accum_steps)
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
            serving = (ema_model_params(state, ema) if ema is not None
                       else state.model_params())
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
        history["ema_params"] = _copy(ema_model_params(state, ema))
    return state, history
