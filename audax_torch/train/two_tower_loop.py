"""Two-tower end-to-end training and validation loop over a music dataset
(port of ``audax/train/two_tower_loop.py``).

The reference main() (.charles/music2midi/train.py:387-554): a 90/10
random split, collated waveform batches, the dual-LR optimizer, an epoch
loop with per-N-batch logging, validation, ReduceLROnPlateau, best-model
and periodic trainable-only checkpoints. The batch's log-mel runs on the
device (kernel K1 on the card, one launch per ``collate_music``); the step
is ``train/two_tower.py:make_two_tower_step``.

The splits and shuffles draw from numpy's ``default_rng`` exactly as the
JAX loop does, so both packages train on the same batches in the same
order. SpecAugment and ``eval_note_f1``'s sampling draw from
``torch.Generator``\\ s (the JAX ``jax.random`` streams cannot be matched;
parity holds with augmentation off and at temperature 0). A dataset is
anything with ``MusicDataset``'s interface: ``__len__``, ``__getitem__``
-> ``MusicExample``, ``tokenizer``, ``start_id``, ``end_id``, ``pad_id``.

Over a (data, model) mesh (``fit_two_tower(mesh=)``) the frozen Whisper
tower is cut over 'model' by ``WHISPER_TP_RULES``, the adapter and the LM
by ``CAUSAL_LM_TP_RULES`` (``fsdp=True`` also cuts them and their Adam
moments over 'data'), and each batch's rows go over 'data' -- a batch
whose rows the axis does not divide runs whole on every rank, as in JAX.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
import shutil
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from audax_torch.core.logging import get_logger
from audax_torch.core.runtime import DeviceLike, resolve_device
from audax_torch.data.audio_io import resample
from audax_torch.eval.music_metrics import abc_note_prf
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.models.two_tower import TwoTowerModel
from audax_torch.models.whisper import tree_map
from audax_torch.ops.augment import SHORT_CLIP_FREQ_WIDTH, SHORT_CLIP_TIME_WIDTH
from audax_torch.ops.augment import spec_augment as _spec_augment
from audax_torch.parallel.fsdp import Layout, fsdp_specs
from audax_torch.parallel.mesh import batch_size, shard_batch, use_mesh
from audax_torch.parallel.sharding import (CAUSAL_LM_TP_RULES,
                                           WHISPER_TP_RULES, shard_params,
                                           tp_specs)
from audax_torch.symbolic.abc_parse import AbcParseError, abc_to_midi
from audax_torch.train.metrics_sink import MetricsSink
from audax_torch.train.two_tower import (TwoTowerState, init_two_tower_state,
                                         load_trainable_checkpoint,
                                         make_two_tower_step,
                                         save_trainable_checkpoint,
                                         scale_learning_rates,
                                         trainable_param_counts)

log = get_logger("audax_torch.two_tower")

__all__ = ["collate_music", "fit_two_tower", "eval_note_f1",
           "music_transcription_proof"]


def eval_note_f1(model: TwoTowerModel, state: TwoTowerState, dataset,
                 idx, frontend: LogMelFrontend, chunk_seconds: float, *,
                 max_len: int = 256, onset_tolerance: float = 0.05,
                 temperature: float = 0.7,
                 generator: Optional[torch.Generator] = None,
                 return_samples: bool = False) -> Dict[str, float]:
    """Generation-quality validation: generate ABC for the ``idx``
    examples and score note-level P/R/F1 against each one's ground-truth
    ABC (parsed back to MIDI), plus the parseable fraction. An unparseable
    ground truth is skipped. ``generator`` draws the samples at a
    temperature above 0 (``TwoTowerModel.generate``'s default when None)."""
    examples = [dataset[int(i)] for i in idx]
    if not examples:
        return {}
    batch = collate_music(examples, frontend, chunk_seconds)
    enc = model.encode_audio(batch["mel"])
    tokens, lengths = model.generate(state.params, enc,
                                     start_id=dataset.start_id,
                                     end_id=dataset.end_id, max_len=max_len,
                                     temperature=temperature,
                                     generator=generator)
    tokens = tokens.cpu().numpy()
    lengths = lengths.cpu().numpy()
    scores, samples = [], []
    for row, ex in enumerate(examples):
        ids = [int(t) for t in tokens[row, 1: lengths[row]]
               if t != dataset.end_id]
        abc = dataset.tokenizer.decode(ids, skip_specials=True)
        samples.append({"file": ex.filename, "target_abc": ex.abc,
                        "generated_abc": abc})
        try:
            ref = abc_to_midi(ex.abc)
        except AbcParseError:
            continue
        scores.append(abc_note_prf(ref, abc, onset_tolerance=onset_tolerance))
    if not scores:
        return {"samples": samples} if return_samples else {}
    out = {
        "note_f1": float(np.mean([s["f1"] for s in scores])),
        "note_precision": float(np.mean([s["precision"] for s in scores])),
        "note_recall": float(np.mean([s["recall"] for s in scores])),
        "abc_valid_rate": float(np.mean([s["valid"] for s in scores])),
    }
    if return_samples:
        out["samples"] = samples
    return out


def collate_music(examples: List, frontend: LogMelFrontend,
                  chunk_seconds: float) -> Dict[str, torch.Tensor]:
    """Waveforms -> a zero-padded [B, chunk] batch -> its log-mel on the
    frontend's device, with the token ids and masks beside it (reference
    collate_fn train.py:207-228). A waveform at another rate is resampled
    first."""
    sr = frontend.cfg.sample_rate
    n_samples = int(chunk_seconds * sr)
    wavs = np.zeros((len(examples), n_samples), np.float32)
    for i, ex in enumerate(examples):
        w = ex.waveform
        ex_sr = getattr(ex, "sample_rate", sr)
        if ex_sr != sr:
            w = np.asarray(resample(w, ex_sr, sr))
        w = w[:n_samples]
        wavs[i, : len(w)] = w
    device = frontend.device

    def ids(key):
        return torch.from_numpy(np.stack([getattr(ex, key)
                                          for ex in examples])).to(device)
    return {"mel": frontend(wavs), "input_ids": ids("input_ids"),
            "attention_mask": ids("attention_mask")}


def _batches(ds, idx: np.ndarray, batch_size: int, frontend: LogMelFrontend,
             chunk_seconds: float, *,
             shuffle_rng: Optional[np.random.Generator] = None
             ) -> Iterator[Dict[str, torch.Tensor]]:
    order = idx.copy()
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)
    # a split smaller than batch_size still trains (one smaller batch)
    bs = min(batch_size, len(order))
    if bs == 0:
        return
    for start in range(0, len(order) - bs + 1, bs):
        group = [ds[int(i)] for i in order[start: start + bs]]
        yield collate_music(group, frontend, chunk_seconds)


def _epochs_on_disk(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"epoch_(\d+)", d)))


def fit_two_tower(
    model: TwoTowerModel,
    dataset,
    *,
    chunk_seconds: float = 30.0,
    val_fraction: float = 0.1,
    sink: Optional[MetricsSink] = None,
    ckpt_dir: Optional[str] = None,
    log_every: int = 10,
    frontend: Optional[LogMelFrontend] = None,
    plateau_patience: int = 2,
    plateau_factor: float = 0.5,
    note_eval_every: int = 0,
    note_eval_samples: int = 4,
    keep_epochs: int = 3,
    resume: bool = False,
    mesh=None, fsdp: bool = False,
    spec_augment: bool = False,
    sa_time_masks: int = 2,
    sa_freq_masks: int = 2,
    sa_max_time_width: Optional[int] = None,   # None = short-clip default
    sa_max_freq_width: Optional[int] = None,
    device: DeviceLike = None,
):
    """Train ``model``'s adapter and top LM layers on ``dataset`` on
    ``device`` (default the CUDA card; the model's tensors are moved
    there). Returns (state, history) with ``history["train_loss"]`` and
    ``["val_loss"]`` per epoch (and ``["note_f1"]`` with note evals).

    ``resume=True`` continues from the latest ``epoch_NNN`` checkpoint in
    ``ckpt_dir``: parameters, optimizer state (Adam moments and the plateau
    scheduler's scaled rates) and step. ``spec_augment`` masks the TRAIN
    mels (validation and note evals stay clean).

    ``mesh`` runs the same loop on every rank of a (data, model) mesh
    (module docstring); ``fsdp`` also cuts the trainable leaves and their
    moments over 'data'. Checkpoints and note evals see the whole tree
    (rank 0 writes), and the returned state is whole on every rank."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    device = resolve_device(device)
    model = model._replace(
        audio_params=tree_map(lambda t: t.to(device), model.audio_params),
        params=tree_map(lambda t: t.to(device), model.params))
    if mesh is not None:
        model = model._replace(audio_params=shard_params(
            model.audio_params, mesh, WHISPER_TP_RULES,
            heads=model.audio_cfg.heads))
    cfg = model.cfg
    frontend = frontend or LogMelFrontend.whisper(model.audio_cfg.n_mels,
                                                  device=device)
    state = init_two_tower_state(model)

    start_epoch = 0
    if resume and ckpt_dir and os.path.isdir(ckpt_dir):
        on_disk = _epochs_on_disk(ckpt_dir)
        if on_disk:
            last = on_disk[-1]
            model, saved = load_trainable_checkpoint(
                os.path.join(ckpt_dir, f"epoch_{last:03d}"), model,
                return_saved=True, opt_state_template=state.opt_state)
            resumed = init_two_tower_state(model)
            if "opt_state" in saved:
                resumed = resumed.replace(opt_state=saved["opt_state"])
            else:
                log.warning("checkpoint has no optimizer state; Adam "
                            "moments reset")
            state = resumed.replace(step=int(saved["step"]))
            start_epoch = last + 1
            log.info("resumed from epoch %d", last)

    lay = None
    if mesh is not None:
        state, lay = _onto_mesh(state, mesh, fsdp, model.lm_cfg.heads)
    lead = mesh is None or torch.distributed.get_rank() == 0
    train_step, eval_step = make_two_tower_step(
        model, accum_steps=cfg.accum_steps, layout=lay)
    counts = trainable_param_counts(model, state.layer_mask)
    log.info("two-tower params: %s", {k: f"{v:,}" for k, v in counts.items()})

    rng = np.random.default_rng(cfg.seed)
    idx = rng.permutation(len(dataset))
    n_val = (max(1, int(len(dataset) * val_fraction))
             if len(dataset) > 1 and val_fraction > 0 else 0)
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    log.info("split: %d train / %d val", len(train_idx), len(val_idx))
    # over a mesh the train batches split evenly over the batch axes when
    # the split allows; one whose rows do not divide runs whole everywhere
    n_rows = 1 if mesh is None else batch_size(mesh)
    train_bs = cfg.batch_size
    if n_rows > 1 and len(train_idx):
        train_bs = max(n_rows, (min(train_bs, len(train_idx)) // n_rows)
                       * n_rows)

    def place(batch):
        if n_rows == 1 or next(iter(batch.values())).shape[0] % n_rows:
            return batch
        return shard_batch(mesh, batch)

    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    best_val = float("inf")
    epochs_since_improvement = 0
    shuffle_rng = np.random.default_rng(cfg.seed + 1)
    epoch_handles: list = []       # (epoch, pending write) in flight
    best_handle = None
    aug_gen = (torch.Generator(device=device).manual_seed(cfg.seed + 7)
               if spec_augment else None)
    for epoch in range(start_epoch, cfg.epochs):
        losses, log_at = [], []
        for i, batch in enumerate(_batches(dataset, train_idx, train_bs,
                                           frontend, chunk_seconds,
                                           shuffle_rng=shuffle_rng)):
            if aug_gen is not None:
                batch["mel"] = _spec_augment(
                    aug_gen, batch["mel"], time_masks=sa_time_masks,
                    freq_masks=sa_freq_masks,
                    max_time_width=sa_max_time_width or SHORT_CLIP_TIME_WIDTH,
                    max_freq_width=sa_max_freq_width or SHORT_CLIP_FREQ_WIDTH)
            state, m = train_step(state, place(batch))
            losses.append(m["loss"])
            if sink and (i + 1) % log_every == 0:
                log_at.append((i, state.step))
        # one device -> host read per epoch
        fetched = (torch.stack(losses).cpu().numpy() if losses
                   else np.zeros(0))
        train_loss = float(fetched.mean()) if losses else 0.0
        if sink:
            for i, step_no in log_at:
                sink.log({"batch_loss": float(fetched[i]), "epoch": epoch},
                         step=step_no)
        history["train_loss"].append(train_loss)

        val_losses = [eval_step(state, batch)["loss"] for batch in _batches(
            dataset, val_idx, min(cfg.batch_size, max(len(val_idx), 1)),
            frontend, chunk_seconds)]
        val_loss = (float(torch.stack(val_losses).mean()) if val_losses
                    else train_loss)
        history["val_loss"].append(val_loss)

        record = {"epoch": epoch, "train_loss": train_loss,
                  "val_loss": val_loss}
        if note_eval_every and (epoch + 1) % note_eval_every == 0 \
                and len(val_idx):
            with use_mesh(mesh):
                nm = eval_note_f1(model, _whole(state, lay), dataset,
                                  val_idx[:note_eval_samples], frontend,
                                  chunk_seconds)
            record.update(nm)
            history.setdefault("note_f1", []).append(nm.get("note_f1"))
        if sink:
            sink.log(record, step=epoch)
        else:
            log.info("epoch %d: train %.4f val %.4f", epoch, train_loss,
                     val_loss)

        whole = _whole(state, lay) if ckpt_dir else None
        if ckpt_dir and lead:
            # the write overlaps the next epoch; pending writes are waited
            # for before a path is pruned or rewritten, and before return
            h = save_trainable_checkpoint(
                os.path.join(ckpt_dir, f"epoch_{epoch:03d}"), whole, model,
                extra={"epoch": epoch, "val_loss": val_loss}, block=False)
            epoch_handles.append((epoch, h))
            while keep_epochs and len(epoch_handles) > keep_epochs:
                old_epoch, old_h = epoch_handles.pop(0)
                old_h.wait_until_finished()
                shutil.rmtree(os.path.join(ckpt_dir,
                                           f"epoch_{old_epoch:03d}"),
                              ignore_errors=True)
        # best-model tracking + ReduceLROnPlateau (train.py:467,524,538-544)
        if val_loss < best_val - 1e-6:
            best_val = val_loss
            epochs_since_improvement = 0
            if ckpt_dir and lead:
                if best_handle is not None:
                    best_handle.wait_until_finished()
                best_handle = save_trainable_checkpoint(
                    os.path.join(ckpt_dir, "best_model"), whole, model,
                    extra={"epoch": epoch, "val_loss": val_loss},
                    block=False)
        else:
            epochs_since_improvement += 1
            if epochs_since_improvement >= plateau_patience:
                state = state.replace(opt_state=scale_learning_rates(
                    state.opt_state, plateau_factor))
                epochs_since_improvement = 0
                log.info("plateau: scaled learning rates by %.2f",
                         plateau_factor)
    for _, h in epoch_handles:
        h.wait_until_finished()
    if best_handle is not None:
        best_handle.wait_until_finished()
    return _whole(state, lay), history


def _onto_mesh(state: TwoTowerState, mesh, fsdp: bool, lm_heads: int):
    """The whole state cut to this rank's blocks over ``mesh`` (the
    adapter and LM by ``CAUSAL_LM_TP_RULES``, with ``fsdp`` also over
    'data'; each group's moments like its parameters) and its layout."""
    specs = (fsdp_specs(state.params, mesh, rules=CAUSAL_LM_TP_RULES,
                        heads=lm_heads) if fsdp
             else tp_specs(state.params, mesh, CAUSAL_LM_TP_RULES,
                           heads=lm_heads))
    lay = Layout(mesh, specs)
    opt = state.opt_state
    adam = {g: Layout(mesh, specs[g]).local_opt_state(a)
            for g, a in opt.adam.items()}
    return state.replace(params=lay.local(state.params, grad=True),
                         opt_state=opt._replace(adam=adam)), lay


def _whole(state: TwoTowerState, lay) -> TwoTowerState:
    """``state`` with its parameters and moments whole (gathered over the
    mesh; every rank calls this alike). Without a layout, ``state``."""
    if lay is None:
        return state
    opt = state.opt_state
    adam = {}
    for g, a in opt.adam.items():
        part = Layout(lay.mesh, lay.specs[g])
        adam[g] = a._replace(mu=part.full(a.mu), nu=part.full(a.nu))
    return state.replace(params=lay.full(state.params),
                         opt_state=opt._replace(adam=adam))


def music_transcription_proof(
    out_dir: str,
    *,
    num_items: int = 12,
    notes_per_item: int = 3,
    epochs: int = 40,
    chunk_seconds: float = 3.0,
    seed: int = 0,
    holdout_items: int = 4,
    pretrain_encoder_steps: int = 600,
    pretrain_items: int = 64,
    augment: bool = False,
    pretrain_lm_steps: int = 0,
    pretrain_lm_items: int = 256,
    lm_params=None,
    lm_cfg_override=None,
    bpe_override=None,
    max_poly: int = 1,
    notes_max: int = 0,
    eval_items: int = 0,
    model_scale: float = 1.0,
    device: DeviceLike = None,
) -> Dict:
    """End-to-end two-tower learning proof (audio -> ABC notation), on
    ``device`` (default the CUDA card):

      1. random melodies through the 4-stage pipeline (cut -> render, MIDI
         -> ABC, BPE tokens, typed Parquet; needs pyarrow);
      2. a compact random two-tower (both towers ``model_scale`` wide),
         scored by note-level P/R/F1 of greedy generations BEFORE training;
      3. training with the real loop (dual LR, top-K unfreeze, plateau LR,
         ``val_fraction`` 0, patience 8);
      4. the same scores AFTER; a metrics JSON and a generated-vs-target
         ABC CSV are written into ``out_dir``.

    ``holdout_items`` melodies of the same distribution (disjoint draws,
    never trained on) are scored separately. ``pretrain_encoder_steps`` > 0
    first fine-tunes the audio tower on a note-name seq2seq task
    (``train/finetune_loop.py:finetune_whisper``) and then freezes it;
    ``pretrain_lm_steps`` > 0 pretrains the decoder on a disjoint ABC
    corpus (``train/lm.py:fit_lm``), or ``lm_params`` /
    ``lm_cfg_override`` / ``bpe_override`` bring an external one.
    ``max_poly`` > 1 makes the corpus polyphonic; ``notes_max`` >
    ``notes_per_item`` draws a variable note count. ``augment`` turns on
    SpecAugment (frequency masks) in both training stages and widens the
    pretrain datagen; holdout renders stay clean. Random initialisations
    draw from CPU ``torch.Generator``\\ s seeded from ``seed``, so the
    card and the CPU start from the same weights."""
    from audax_torch.core.config import (DataGenConfig, FineTuneConfig,
                                         MelConfig, TwoTowerConfig,
                                         WhisperConfig)
    from audax_torch.data.music_dataset import (ABC_SPECIALS, MusicDataset,
                                                stage_genparquet,
                                                stage_gentokens_bpe,
                                                stage_midi2abc,
                                                stage_midi2wav)
    from audax_torch.data.synth import _random_melody, make_midi_dataset
    from audax_torch.models.causal_lm import CausalLMConfig, init_causal_lm
    from audax_torch.models.two_tower import build_two_tower
    from audax_torch.models.whisper import init_whisper_params
    from audax_torch.symbolic.abc import midi_to_abc
    from audax_torch.symbolic.bpe import train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer
    from audax_torch.train.finetune_loop import (build_speech_dataset,
                                                 finetune_whisper)
    from audax_torch.train.lm import LMTrainConfig, fit_lm

    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def gen(offset: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed + offset)

    def _melody(r):
        n = notes_per_item if notes_max <= notes_per_item else \
            int(r.integers(notes_per_item, notes_max + 1))
        mf, _ = _random_melody(r, n, velocity=100, low=48, high=84,
                               max_poly=max_poly)
        return mf

    midi_dir = os.path.join(out_dir, "proof_midis")
    os.makedirs(midi_dir, exist_ok=True)
    for i in range(num_items):
        _melody(rng).save(os.path.join(midi_dir, f"melody_{i:03d}.mid"))
    # holdout melodies: the rng stream continues (disjoint draws)
    midi_h = os.path.join(out_dir, "proof_midis_holdout")
    os.makedirs(midi_h, exist_ok=True)
    for i in range(holdout_items):
        _melody(rng).save(os.path.join(midi_h, f"holdout_{i:03d}.mid"))

    gen_cfg = DataGenConfig(chunk_duration_s=chunk_seconds, out_dir=out_dir,
                            seed=seed)
    wav_dir = os.path.join(out_dir, "proof_wavs")
    abc_dir = os.path.join(out_dir, "proof_abcs")
    stage_midi2wav(midi_dir, wav_dir, gen_cfg, workers=1)
    stage_midi2abc(wav_dir, abc_dir, workers=1)
    lm_pretrain_texts: List[str] = []
    if bpe_override is not None:
        bpe = bpe_override
    elif pretrain_lm_steps > 0:
        # BPE over the LM corpus + the proof's train ABCs: one vocabulary
        r_lm = np.random.default_rng(seed + 13)
        for i in range(pretrain_lm_items):
            mf = _melody(r_lm)
            if chunk_seconds and mf.duration_seconds > chunk_seconds:
                mf = mf.cut(chunk_seconds)
            lm_pretrain_texts.append(midi_to_abc(mf, title=f"lm{i:04d}"))
        train_texts = []
        for path in sorted(glob.glob(os.path.join(abc_dir, "*.abc"))):
            with open(path) as fh:
                train_texts.append(fh.read())
        bpe = train_bpe(lm_pretrain_texts + train_texts, 300,
                        special_tokens=list(ABC_SPECIALS), min_frequency=2)
        bpe.save(os.path.join(out_dir, "proof_bpe"))
    else:
        # BPE from the TRAIN ABCs only; the holdout rides the same vocab
        bpe = stage_gentokens_bpe(abc_dir, os.path.join(out_dir, "proof_bpe"),
                                  vocab_size=300)
    parquet = stage_genparquet(wav_dir, abc_dir,
                               os.path.join(out_dir, "proof_music.parquet"))
    dataset = MusicDataset(parquet, bpe, max_tokens=64)
    if len(dataset) < num_items // 2:
        raise RuntimeError(f"the pipeline produced {len(dataset)} rows of "
                           f"{num_items}")
    holdout_ds = None
    if holdout_items > 0:
        wav_h = os.path.join(out_dir, "proof_wavs_holdout")
        abc_h = os.path.join(out_dir, "proof_abcs_holdout")
        stage_midi2wav(midi_h, wav_h, gen_cfg, workers=1)
        stage_midi2abc(wav_h, abc_h, workers=1)
        parquet_h = stage_genparquet(
            wav_h, abc_h, os.path.join(out_dir, "proof_holdout.parquet"))
        holdout_ds = MusicDataset(parquet_h, bpe, max_tokens=64)

    frames = int(chunk_seconds * 16000) // 160      # whisper hop 160
    s = model_scale
    audio_cfg = WhisperConfig(
        n_mels=80, n_audio_ctx=frames // 2, d_model=int(64 * s),
        encoder_layers=2, decoder_layers=1, heads=max(2, int(2 * s)),
        vocab_size=64, n_text_ctx=8)
    lm_cfg = lm_cfg_override or CausalLMConfig(
        vocab_size=len(bpe), d_model=int(96 * s), layers=4,
        heads=max(4, int(4 * s)), kv_heads=max(2, int(2 * s)),
        ffn_dim=int(192 * s), tie_embeddings=True, max_seq=128)
    if pretrain_lm_steps > 0 and lm_params is None:
        ids: List[int] = []
        for t in lm_pretrain_texts:
            ids.extend(bpe.encode(t))
            ids.extend(bpe.encode("\n\n"))
        lm_tc = LMTrainConfig(learning_rate=1e-3,
                              max_steps=pretrain_lm_steps, batch_size=16,
                              seq_len=96,
                              eval_every=max(1, pretrain_lm_steps // 4),
                              seed=seed + 13)
        lm0 = init_causal_lm(lm_cfg, gen(13), device=device)
        lm_params, lm_hist = fit_lm(lm0, lm_cfg, lm_tc,
                                    np.asarray(ids, np.int32), device=device)
        log.info("decoder pretrained: %d steps over %d ABC tunes "
                 "(%d tokens), eval ppl %.2f", pretrain_lm_steps,
                 len(lm_pretrain_texts), len(ids),
                 lm_hist[-1].get("eval_ppl", float("nan"))
                 if lm_hist else float("nan"))
    # learning rates scale 1/width past scale 1
    tt_cfg = TwoTowerConfig(adapter_heads=4, top_k_unfrozen_layers=2,
                            max_target_tokens=64,
                            adapter_lr=3e-3 / max(1.0, s),
                            lm_lr=1e-3 / max(1.0, s),
                            batch_size=4, epochs=epochs, seed=seed)
    audio_params = None
    if pretrain_encoder_steps > 0:
        # the hubless "pretrained whisper": a note-name seq2seq fine-tune
        # on the same synth distribution (disjoint seed), then FROZEN
        gen_p = DataGenConfig(num_items=pretrain_items,
                              notes_per_item=notes_per_item,
                              out_dir=os.path.join(out_dir,
                                                   "pretrain_datagen"),
                              seed=seed + 7,
                              velocity_jitter=20 if augment else 0,
                              gain_jitter_db=6.0 if augment else 0.0,
                              noise_snr_db=25.0 if augment else 0.0)
        pre_csv = make_midi_dataset(gen_p)
        with open(pre_csv, newline="") as fh:
            pre_texts = [r["labels"] for r in csv.DictReader(fh)]
        ptok = WhisperTokenizer(
            train_bpe(pre_texts, vocab_size=320,
                      special_tokens=["<|MIDI|>", "<|/MIDI|>"]))
        pre_cfg = WhisperConfig(
            n_mels=audio_cfg.n_mels, n_audio_ctx=audio_cfg.n_audio_ctx,
            d_model=audio_cfg.d_model,
            encoder_layers=audio_cfg.encoder_layers,
            decoder_layers=2, heads=audio_cfg.heads,
            vocab_size=ptok.vocab_size, n_text_ctx=32)
        pre_mel = MelConfig.whisper(audio_cfg.n_mels)
        pre_examples = build_speech_dataset("", ptok, pre_mel,
                                            labels_csv=pre_csv,
                                            chunk_seconds=chunk_seconds)
        pre_params = init_whisper_params(pre_cfg, gen(7), device=device)
        ft_pre = FineTuneConfig(learning_rate=1e-3, warmup_steps=20,
                                max_steps=pretrain_encoder_steps,
                                eval_every=10 ** 9, batch_size=8,
                                lora_rank=0, seed=seed + 7,
                                spec_augment=augment, sa_time_masks=0,
                                sa_max_time_width=SHORT_CLIP_TIME_WIDTH,
                                sa_max_freq_width=SHORT_CLIP_FREQ_WIDTH)
        pre_state, _ = finetune_whisper(pre_params, pre_cfg, ptok,
                                        pre_examples, ft_pre,
                                        mel_cfg=pre_mel, device=device)
        audio_params = tree_map(lambda t: t.detach(),
                                pre_state.model_params())
        log.info("encoder pretrained: %d steps over %d pitch clips",
                 pretrain_encoder_steps, len(pre_examples))
    model = build_two_tower(tt_cfg, audio_cfg, lm_cfg, len(bpe), gen(0),
                            audio_params=audio_params, lm_params=lm_params,
                            device=device)
    frontend = LogMelFrontend.whisper(80, device=device)
    state0 = init_two_tower_state(model)
    all_idx = np.arange(len(dataset))
    if eval_items and eval_items < len(dataset):
        all_idx = np.random.default_rng(seed + 13).choice(
            len(dataset), size=eval_items, replace=False)

    def score(st, ds, idx):
        if ds is None:
            return {}
        return eval_note_f1(model, st, ds, idx, frontend, chunk_seconds,
                            max_len=64, temperature=0.0,
                            return_samples=True)

    h_idx = np.arange(len(holdout_ds)) if holdout_ds is not None else None
    before = score(state0, dataset, all_idx)
    before_h = score(state0, holdout_ds, h_idx)
    # frequency masks only: a time mask can blank a whole note of a short
    # melody; patience 8: with val_fraction 0 the scheduler watches the
    # noisy small-batch train loss
    state, history = fit_two_tower(model, dataset,
                                   chunk_seconds=chunk_seconds,
                                   val_fraction=0.0, frontend=frontend,
                                   plateau_patience=8, spec_augment=augment,
                                   sa_time_masks=0, device=device)
    after = score(state, dataset, all_idx)
    after_h = score(state, holdout_ds, h_idx)

    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "two_tower_proof_comparison.csv")
    before_by_file = {x["file"]: x for x in before.pop("samples", [])}
    after_samples = after.pop("samples", [])
    before_h_by_file = {x["file"]: x for x in before_h.pop("samples", [])}
    after_h_samples = after_h.pop("samples", [])
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["file", "target_abc", "previous",
                                           "trained", "split"])
        w.writeheader()
        for split, samples, prev_map in (
                ("train", after_samples, before_by_file),
                ("holdout", after_h_samples, before_h_by_file)):
            for x in samples:
                prev = prev_map.get(x["file"], {})
                w.writerow({"file": os.path.basename(x["file"]),
                            "target_abc": x["target_abc"],
                            "previous": prev.get("generated_abc", ""),
                            "trained": x["generated_abc"], "split": split})
    metrics = {
        "before": {k: round(v, 4) for k, v in before.items()},
        "after": {k: round(v, 4) for k, v in after.items()},
        "epochs": epochs, "items": len(dataset),
        "eval_items": int(len(all_idx)),
        "augment": augment, "model_scale": model_scale,
        "pretrain_lm_steps": pretrain_lm_steps,
        "lm_pretrained": lm_params is not None,
        "max_poly": max_poly, "notes_max": notes_max,
        "train_loss_first": round(history["train_loss"][0], 4),
        "train_loss_last": round(history["train_loss"][-1], 4),
    }
    if holdout_ds is not None:
        metrics["holdout_items"] = len(holdout_ds)
        metrics["holdout_before"] = {k: round(v, 4)
                                     for k, v in before_h.items()}
        metrics["holdout_after"] = {k: round(v, 4)
                                    for k, v in after_h.items()}
    metrics_path = os.path.join(out_dir, "two_tower_proof_metrics.json")
    with open(metrics_path, "w") as fh:
        json.dump(metrics, fh, indent=2)
    log.success("two-tower proof: note_f1 %.3f -> %.3f (holdout %.3f -> "
                "%.3f), valid %.2f -> %.2f (%s)",
                before.get("note_f1", 0.0), after.get("note_f1", 0.0),
                before_h.get("note_f1", 0.0), after_h.get("note_f1", 0.0),
                before.get("abc_valid_rate", 0.0),
                after.get("abc_valid_rate", 0.0), csv_path)
    return {"before": before, "after": after,
            "holdout_before": before_h or None,
            "holdout_after": after_h or None,
            "csv": csv_path, "metrics": metrics_path, **metrics}
