"""audax_torch command line (port of ``audax/cli/main.py``'s registry,
``main``, the Whisper and LM presets, and the music subcommands).

    python -m audax_torch.cli.main infer-music --wav clip.wav \\
        --tokenizer-dir tok/ --ckpt trainable/ [--lm-ckpt lm/] [--constrained]
    python -m audax_torch.cli.main train-lm --corpus abcs/ \\
        --tokenizer-dir tok/ --lm-size qwen3-0.6b --steps 1000
    python -m audax_torch.cli.main train-music --parquet music.parquet \\
        --tokenizer-dir tok/ --lm-size qwen3-0.6b [--lm-ckpt lm/best]

Each stage of the JAX command line is a subcommand of one entry point.
This port registers the music path: the data tools (``make-midi-dataset``,
``midi2wav``, ``midi2abc``, ``abc2wav``, ``gentokens-raw``,
``gentokens-bpe``, ``genparquet``, ``data-quality``), the trainers
(``train-lm``, ``train-music``), the proofs (``music-proof``,
``finetune-proof``) and ``infer-music``. The other subcommands of the JAX
command line (preprocess, the classifier trainers and testers, transcribe,
serve, convert-hf, demo, ...) are not registered yet (ROADMAP A12.2). The
mesh flags (``--dp``/``--tp``/``--fsdp``) are accepted and raise when set:
tensor and data parallelism wait for the parallelism slice; so does a
``--soundfont`` (the SF2 synth is not ported). ``train-lm --moe-experts N``
pretrains a Qwen3-MoE-family decoder (the ragged impl, the Switch aux
loss), as the JAX command line does. Two flags are the port's
own: ``--device`` (default the CUDA card; ``cpu`` runs every kernel's plain
version) and ``--out`` on ``infer-music`` and ``train-lm`` (a JSON record
of the run: tokens and text, or the history and seconds).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from dataclasses import replace
from typing import Callable, Dict

from audax_torch.core.logging import get_logger

__all__ = ["main", "command", "WHISPER_SIZES", "LM_SIZES"]

log = get_logger("audax_torch.cli")

_COMMANDS: Dict[str, Callable] = {}


def command(name: str):
    def deco(fn):
        _COMMANDS[name] = fn
        return fn
    return deco


def _add_mesh_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel axis size (0 = no mesh)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params + Adam moments over the data axis")


def _check_no_mesh(args) -> None:
    if args.dp or args.tp > 1 or args.fsdp:
        raise NotImplementedError("--dp/--tp/--fsdp (a device mesh) arrive "
                                  "with the parallelism slice of the port")


#: the published whisper family; "turbo" is the distilled
#: 4-decoder-layer large-v3
WHISPER_SIZES = ("tiny", "base", "small", "medium", "large-v3",
                 "large-v3-turbo")


def _whisper_preset(size: str):
    from audax_torch.core.config import WhisperConfig
    return {"tiny": WhisperConfig.tiny, "base": WhisperConfig.base,
            "small": WhisperConfig.small, "medium": WhisperConfig.medium,
            "large-v3": WhisperConfig.large_v3,
            "large-v3-turbo": WhisperConfig.large_v3_turbo}[size]()


#: decoder dims per --lm-size: (d_model, layers, heads, kv_heads), shared
#: with the JAX command line so a checkpoint of either matches
_LM_DIMS = {"tiny": (128, 4, 4, 2), "small": (256, 6, 8, 4),
            "base": (512, 12, 8, 4)}
#: published decoder configs by --lm-size (each keeps its own vocab)
_LM_PUBLISHED = {"qwen3-0.6b": "qwen3_0_6b"}
LM_SIZES = tuple(sorted(_LM_DIMS)) + tuple(_LM_PUBLISHED)


def _lm_preset(size: str, vocab_size: int):
    """The decoder config of ``--lm-size``: a dims preset at ``vocab_size``,
    or a published config (Qwen3-0.6B) at its own vocab."""
    from audax_torch.models.causal_lm import CausalLMConfig
    if size in _LM_PUBLISHED:
        return getattr(CausalLMConfig, _LM_PUBLISHED[size])()
    d, layers, heads, kv = _LM_DIMS[size]
    return CausalLMConfig(vocab_size=vocab_size, d_model=d, layers=layers,
                          heads=heads, kv_heads=kv)


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch versions)")


def _write_out(path: str, record: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(record, fh, indent=1)


@command("infer-music")
def cmd_infer_music(argv) -> int:
    """Audio -> ABC generation (reference: music2midi/inference.py main)."""
    p = argparse.ArgumentParser(prog="audax_torch infer-music")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav", help="one file (single fixed-batch generate)")
    src.add_argument("--wav-dir", help="directory of .wav files served "
                     "through the continuous-batching generator "
                     "(slot refill; infer/continuous.py)")
    p.add_argument("--tokenizer-dir", required=True)
    p.add_argument("--ckpt", required=True,
                   help="trainable-only two-tower checkpoint (the port's "
                        "format or a JAX orbax one)")
    p.add_argument("--chunk-seconds", type=float, default=10.0)
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (per-request reproducible streams)")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent decode slots (--wav-dir mode)")
    p.add_argument("--lm-size", default="small", choices=LM_SIZES)
    p.add_argument("--lm-ckpt", default="",
                   help="pretrained decoder weights (a tree saved by "
                        "save_pytree) -- must match what training used "
                        "(trainable-only checkpoints rebuild the frozen "
                        "layers from here)")
    p.add_argument("--constrained", action="store_true",
                   help="restrict sampling to the tokenizer's added/special "
                        "ABC token set (the reference's 'mask out non-ABC "
                        "tokens' variant, model.py:346-417)")
    p.add_argument("--prompt", default="",
                   help="teacher-forced ABC header after <abc_start> (e.g. "
                        "'X:1\\nK:C\\n'). Single-wav mode only")
    _add_device_flag(p)
    p.add_argument("--out", default="",
                   help="write a JSON record of the requests' tokens and "
                        "text, the decode steps and the seconds here")
    _add_mesh_flags(p)
    args = p.parse_args(argv)
    _check_no_mesh(args)

    import numpy as np
    import torch

    from audax_torch.core.config import TwoTowerConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.data.audio_io import read_wav, resample, to_mono
    from audax_torch.frontend.features import LogMelFrontend, pad_or_trim
    from audax_torch.models.two_tower import build_two_tower
    from audax_torch.symbolic.bpe import BPE
    from audax_torch.train.checkpoints import load_pytree
    from audax_torch.train.two_tower import load_trainable_checkpoint

    device = resolve_device(args.device)
    tt = TwoTowerConfig.from_env()
    lm_cfg = _lm_preset(args.lm_size, 2048)
    audio_cfg = _whisper_preset(tt.whisper_size)
    bpe = BPE.load(args.tokenizer_dir)
    lm_params = None
    if args.lm_ckpt:
        lm_params = load_pytree(args.lm_ckpt)
        lm_cfg = replace(lm_cfg, vocab_size=lm_params["embed"].shape[0])
    model = build_two_tower(tt, audio_cfg, lm_cfg, len(bpe),
                            torch.Generator(device=device).manual_seed(0),
                            lm_params=lm_params, device=device)
    del lm_params
    model = load_trainable_checkpoint(args.ckpt, model)
    start = bpe.vocab.get("<abc_start>", 0)
    end = bpe.vocab.get("<abc_end>", 1)
    sr = 16000

    def load(path):
        x, rate = read_wav(path)
        x = to_mono(x)
        if rate != sr:
            x = resample(x, rate, sr)
            log.warning("%s: resampled %d -> %d Hz", path, rate, sr)
        return x

    allowed = bpe.added_token_ids() if args.constrained else None
    if args.wav_dir:
        from audax_torch.infer.continuous import ContinuousGenerator
        g = ContinuousGenerator(
            model, bpe=bpe, start_id=start, end_id=end, slots=args.slots,
            window_seconds=args.chunk_seconds,
            max_new_tokens=args.max_tokens - 1,
            temperature=args.temperature, allowed_ids=allowed,
            device=device)
        names = sorted(f for f in os.listdir(args.wav_dir)
                       if f.lower().endswith(".wav"))
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            g.submit(name, load(os.path.join(args.wav_dir, name)),
                     seed=args.seed + i)
        results = {r.request_id: r for r in g.run()}
        seconds = time.perf_counter() - t0
        for name in names:                    # stable file order
            r = results[name]
            print(f"== {r.request_id} (avg_logprob {r.avg_logprob:.3f})")
            print(r.text)
        _write_out(args.out, {
            "mode": "wav-dir", "seconds": seconds,
            "decode_steps": g.decode_steps,
            "requests": [{"id": n, "tokens": results[n].tokens,
                          "text": results[n].text,
                          "avg_logprob": results[n].avg_logprob}
                         for n in names]})
        return 0

    t0 = time.perf_counter()
    x = load(args.wav)
    frontend = LogMelFrontend.whisper(audio_cfg.n_mels, device=device)
    n = int(args.chunk_seconds * sr)
    mel = frontend(pad_or_trim(torch.from_numpy(
        np.ascontiguousarray(x[:n], np.float32)), n)[None])
    enc = model.encode_audio(mel)
    prompt_ids = bpe.encode(args.prompt) if args.prompt else None
    tokens, lengths = model.generate(
        model.params, enc, start_id=start, end_id=end,
        max_len=args.max_tokens, temperature=args.temperature,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        allowed_ids=allowed, prompt_ids=prompt_ids)
    length = int(lengths[0])
    ids = [int(i) for i in tokens[0, 1: length - 1].cpu()]
    seconds = time.perf_counter() - t0
    text = bpe.decode(ids, skip_specials=True)
    print(text)
    _write_out(args.out, {
        "mode": "wav", "seconds": seconds, "decode_steps": length - 1,
        "requests": [{"id": os.path.basename(args.wav), "tokens": ids,
                      "all_tokens": [int(i) for i in tokens[0].cpu()],
                      "text": text}]})
    return 0


@command("train-lm")
def cmd_train_lm(argv) -> int:
    """Pretrain a Qwen-family causal LM on a text corpus (the hubless
    counterpart of the reference's pretrained Qwen, music2midi/model.py:
    209-213); ``train-music --lm-ckpt <out-dir>/best`` then starts the
    two-tower from it."""
    p = argparse.ArgumentParser(prog="audax_torch train-lm")
    p.add_argument("--corpus", nargs="+", required=True,
                   help="text files or directories (*.txt/*.abc) to train on")
    p.add_argument("--tokenizer-dir", required=True,
                   help="BPE dir (symbolic/bpe.py format, e.g. from "
                        "gentokens-bpe)")
    p.add_argument("--out-dir", default="artifacts/lm")
    p.add_argument("--lm-size", default="small", choices=LM_SIZES)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--moe-experts", type=int, default=0,
                   help=">0 pretrains a Qwen3-MoE-family decoder: N experts "
                        "(ragged impl) with the Switch load-balancing aux "
                        "loss; see --moe-top-k/--moe-ffn-dim")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-ffn-dim", type=int, default=0,
                   help="per-expert FFN width (default: the preset's "
                        "ffn_dim / top_k, at least 16, as the JAX command "
                        "line)")
    p.add_argument("--remat", default="", choices=["", "full", "dots"],
                   help="per-layer gradient checkpointing")
    p.add_argument("--moment-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="Adam moment storage dtype (train/optim.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="",
                   help="write a JSON record of the history, the steps and "
                        "the seconds of the fit here")
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)
    _check_no_mesh(args)

    import numpy as np
    import torch

    from audax_torch.core.runtime import resolve_device
    from audax_torch.models.causal_lm import init_causal_lm
    from audax_torch.symbolic.bpe import BPE
    from audax_torch.train.lm import LMTrainConfig, fit_lm
    from audax_torch.train.metrics_sink import MetricsSink

    device = resolve_device(args.device)
    bpe = BPE.load(args.tokenizer_dir)
    paths = []
    for c in args.corpus:
        if os.path.isdir(c):
            paths.extend(sorted(os.path.join(c, f) for f in os.listdir(c)
                                if f.endswith((".txt", ".abc"))))
        else:
            paths.extend(sorted(glob.glob(c)) or [c])
    ids: list = []
    for path in paths:
        with open(path, encoding="utf-8", errors="replace") as fh:
            ids.extend(bpe.encode(fh.read()))
        ids.extend(bpe.encode("\n\n"))          # document separator
    log.info("corpus: %d files -> %d tokens (vocab %d)", len(paths),
             len(ids), len(bpe))
    cfg = _lm_preset(args.lm_size, len(bpe))
    if args.moe_experts:
        cfg = replace(cfg, num_experts=args.moe_experts,
                      experts_per_tok=args.moe_top_k,
                      moe_ffn_dim=args.moe_ffn_dim
                      or max(cfg.ffn_dim // args.moe_top_k, 16))
    train_cfg = LMTrainConfig(
        learning_rate=args.lr, max_steps=args.steps,
        batch_size=args.batch_size, seq_len=args.seq_len,
        accum_steps=args.accum_steps, dtype=args.dtype,
        eval_every=args.eval_every, remat=args.remat,
        moment_dtype=args.moment_dtype, seed=args.seed)
    params = init_causal_lm(cfg, torch.Generator().manual_seed(args.seed),
                            device=device)
    sink = MetricsSink("lm", config={"model": cfg.__dict__.copy(),
                                     "train": train_cfg.__dict__.copy()})
    t0 = time.perf_counter()
    _, history = fit_lm(params, cfg, train_cfg, np.asarray(ids, np.int32),
                        ckpt_dir=args.out_dir, sink=sink, device=device)
    seconds = time.perf_counter() - t0
    sink.close()
    if history:
        print({k: round(v, 4) for k, v in history[-1].items()})
    print(args.out_dir)
    _write_out(args.out, {"history": history, "steps": args.steps,
                          "seconds": seconds, "tokens": len(ids)})
    return 0


@command("train-music")
def cmd_train_music(argv) -> int:
    """Two-tower audio->ABC training (reference: music2midi/train.py main)."""
    p = argparse.ArgumentParser(prog="audax_torch train-music")
    p.add_argument("--parquet", required=True)
    p.add_argument("--tokenizer-dir", required=True)
    p.add_argument("--ckpt-dir", default="artifacts/two_tower")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--accum-steps", type=int, default=0,
                   help="gradient accumulation microbatches per step")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint in "
                        "--ckpt-dir (params + optimizer state + step)")
    p.add_argument("--chunk-seconds", type=float, default=10.0)
    p.add_argument("--note-eval-every", type=int, default=0,
                   help="run note-level P/R/F1 generation eval every N epochs")
    p.add_argument("--lm-size", default="small", choices=LM_SIZES)
    p.add_argument("--lm-ckpt", default="",
                   help="pretrained decoder weights from `train-lm` (e.g. "
                        "artifacts/lm/best); dims must match --lm-size")
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)
    _check_no_mesh(args)

    import torch

    from audax_torch.core.config import TwoTowerConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.data.music_dataset import MusicDataset
    from audax_torch.models.two_tower import build_two_tower
    from audax_torch.symbolic.bpe import BPE
    from audax_torch.train.checkpoints import load_pytree
    from audax_torch.train.metrics_sink import MetricsSink
    from audax_torch.train.two_tower_loop import fit_two_tower
    from audax_torch.utils.reports import TWO_TOWER_DIAGRAM, model_report

    device = resolve_device(args.device)
    tt = TwoTowerConfig.from_env()
    if args.epochs:
        tt = replace(tt, epochs=args.epochs)
    if args.batch_size:
        tt = replace(tt, batch_size=args.batch_size)
    if args.accum_steps:
        tt = replace(tt, accum_steps=args.accum_steps)
    lm_cfg = _lm_preset(args.lm_size, 2048)
    audio_cfg = _whisper_preset(tt.whisper_size)
    bpe = BPE.load(args.tokenizer_dir)
    ds = MusicDataset(args.parquet, bpe, max_tokens=tt.max_target_tokens)
    lm_params = None
    if args.lm_ckpt:
        lm_params = load_pytree(args.lm_ckpt)
        lm_vocab = lm_params["embed"].shape[0]
        lm_cfg = replace(lm_cfg, vocab_size=lm_vocab)
        log.info("pretrained decoder: %s (vocab %d)", args.lm_ckpt, lm_vocab)
    model = build_two_tower(tt, audio_cfg, lm_cfg, len(bpe),
                            torch.Generator().manual_seed(tt.seed),
                            lm_params=lm_params, device=device)
    del lm_params
    print(model_report(
        {"whisper(frozen)": model.audio_params,
         "adapter": model.params["adapter"], "lm": model.params["lm"]},
        trainable={"adapter": True, "lm": True},
        diagram=TWO_TOWER_DIAGRAM))
    sink = MetricsSink("two_tower", config=tt.asdict())
    fit_two_tower(model, ds, chunk_seconds=args.chunk_seconds, sink=sink,
                  ckpt_dir=args.ckpt_dir,
                  note_eval_every=args.note_eval_every, resume=args.resume,
                  device=device)
    sink.close()
    print(args.ckpt_dir)
    return 0


@command("finetune-proof")
def cmd_finetune_proof(argv) -> int:
    """Self-contained synthetic fine-tune proof: datagen -> BPE -> random
    init -> before/after transcription CSV with the WER drop."""
    p = argparse.ArgumentParser(prog="audax_torch finetune-proof")
    p.add_argument("--out", default="results")
    p.add_argument("--items", type=int, default=16)
    p.add_argument("--notes", type=int, default=3)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--chunk-seconds", type=float, default=6.0)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--holdout-items", type=int, default=6,
                   help="unseen clips (disjoint seed) scored separately")
    p.add_argument("--augment", action="store_true",
                   help="velocity/gain/noise datagen jitter + SpecAugment "
                        "on train batches (holdout stays clean)")
    p.add_argument("--moment-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="Adam moment storage dtype (train/optim.py)")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from audax_torch.train.finetune_loop import midi_finetune_proof
    out = midi_finetune_proof(
        args.out, num_items=args.items, notes_per_item=args.notes,
        steps=args.steps, chunk_seconds=args.chunk_seconds,
        d_model=args.d_model, layers=args.layers,
        holdout_items=args.holdout_items, augment=args.augment,
        moment_dtype=args.moment_dtype, device=args.device)
    print(json.dumps({k: out[k] for k in
                      ("wer_before", "wer_after", "holdout_wer_before",
                       "holdout_wer_after", "csv", "metrics")}))
    return 0 if out["wer_after"] < out["wer_before"] else 1


@command("music-proof")
def cmd_music_proof(argv) -> int:
    """Self-contained two-tower learning proof: synthetic MIDI corpus ->
    4-stage pipeline -> random-init two-tower -> train -> note-level F1
    before/after with a generated-vs-target ABC CSV."""
    p = argparse.ArgumentParser(prog="audax_torch music-proof")
    p.add_argument("--out", default="results")
    p.add_argument("--items", type=int, default=12)
    p.add_argument("--notes", type=int, default=3)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--chunk-seconds", type=float, default=3.0)
    p.add_argument("--holdout-items", type=int, default=4,
                   help="unseen melodies (disjoint draws) scored separately")
    p.add_argument("--pretrain-encoder-steps", type=int, default=600,
                   help="pretrain the frozen audio tower on a note-name "
                        "seq2seq task first; 0 = random frozen encoder")
    p.add_argument("--pretrain-items", type=int, default=64)
    p.add_argument("--augment", action="store_true",
                   help="SpecAugment in both training stages + pretrain "
                        "datagen jitter (holdout stays clean)")
    p.add_argument("--pretrain-lm-steps", type=int, default=0,
                   help=">0: pretrain the decoder LM on a disjoint "
                        "synthetic ABC corpus first")
    p.add_argument("--pretrain-lm-items", type=int, default=256,
                   help="melodies in the LM-pretraining ABC corpus")
    p.add_argument("--lm-ckpt", default="",
                   help="EXTERNAL pretrained decoder checkpoint (train-lm "
                        "output); overrides --pretrain-lm-steps")
    p.add_argument("--lm-tokenizer-dir", default="",
                   help="BPE dir the --lm-ckpt was trained with "
                        "(required with --lm-ckpt)")
    p.add_argument("--max-poly", type=int, default=1,
                   help=">1: polyphonic corpus (chords of up to this many "
                        "pitches)")
    p.add_argument("--notes-max", type=int, default=0,
                   help="> --notes: variable per-melody note count drawn "
                        "from [notes, notes-max]")
    p.add_argument("--eval-items", type=int, default=0,
                   help=">0: score train-set F1 on this many sampled items "
                        "(holdout eval is always complete)")
    p.add_argument("--model-scale", type=float, default=1.0,
                   help="width multiplier for both towers (head_dim "
                        "preserved)")
    _add_device_flag(p)
    args = p.parse_args(argv)
    if args.lm_ckpt and not args.lm_tokenizer_dir:
        p.error("--lm-ckpt requires --lm-tokenizer-dir")

    from audax_torch.train.two_tower_loop import music_transcription_proof
    lm_params = lm_cfg = bpe_override = None
    if args.lm_ckpt:
        from audax_torch.models.causal_lm import CausalLMConfig
        from audax_torch.symbolic.bpe import BPE
        from audax_torch.train.checkpoints import load_pytree
        lm_params = load_pytree(args.lm_ckpt)
        bpe_override = BPE.load(args.lm_tokenizer_dir)
        cfg_json = None
        for d in (args.lm_ckpt, os.path.dirname(args.lm_ckpt.rstrip("/"))):
            c = os.path.join(d, "config.json")
            if os.path.exists(c):
                with open(c) as fh:
                    cfg_json = json.load(fh)
                break
        if cfg_json is None:
            p.error(f"no config.json sidecar next to {args.lm_ckpt}")
        lm_cfg = CausalLMConfig(**cfg_json)
    out = music_transcription_proof(
        args.out, num_items=args.items, notes_per_item=args.notes,
        epochs=args.epochs, chunk_seconds=args.chunk_seconds,
        holdout_items=args.holdout_items,
        pretrain_encoder_steps=args.pretrain_encoder_steps,
        pretrain_items=args.pretrain_items, augment=args.augment,
        pretrain_lm_steps=args.pretrain_lm_steps,
        pretrain_lm_items=args.pretrain_lm_items,
        lm_params=lm_params, lm_cfg_override=lm_cfg,
        bpe_override=bpe_override, max_poly=args.max_poly,
        notes_max=args.notes_max, eval_items=args.eval_items,
        model_scale=args.model_scale, device=args.device)
    print(json.dumps({"before": out["before"], "after": out["after"],
                      "holdout_before": out["holdout_before"],
                      "holdout_after": out["holdout_after"],
                      "csv": out["csv"], "metrics": out["metrics"]}))
    # pass/fail keys on HOLDOUT improvement when a holdout exists
    if args.holdout_items > 0 and out["holdout_after"] is not None:
        return 0 if (out["holdout_after"].get("note_f1", 0.0)
                     > out["holdout_before"].get("note_f1", 0.0)) else 1
    return 0 if (out["after"].get("note_f1", 0.0)
                 > out["before"].get("note_f1", 0.0)) else 1


@command("data-quality")
def cmd_data_quality(argv) -> int:
    """Dataset quality report (reference SQL cookbooks as callable checks)."""
    p = argparse.ArgumentParser(prog="audax_torch data-quality")
    p.add_argument("--parquet", required=True)
    p.add_argument("--kind", default="urbansound",
                   choices=["urbansound", "music"])
    args = p.parse_args(argv)
    from audax_torch.data.quality import (format_report, music_quality_report,
                                          urbansound_quality_report)
    fn = (urbansound_quality_report if args.kind == "urbansound"
          else music_quality_report)
    print(format_report(fn(args.parquet), f"{args.kind} quality"))
    return 0


def _datagen_cfg(**changes):
    from audax_torch.core.config import DataGenConfig
    cfg = DataGenConfig.from_env()
    return replace(cfg, **{k: v for k, v in changes.items() if v})


@command("midi2wav")
def cmd_midi2wav(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch midi2wav")
    p.add_argument("--midi-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--chunk-seconds", type=float, default=0.0)
    p.add_argument("--soundfont", default="")
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    from audax_torch.data.music_dataset import stage_midi2wav
    cfg = _datagen_cfg(chunk_duration_s=args.chunk_seconds,
                       soundfont=args.soundfont)
    stage_midi2wav(args.midi_dir, args.out_dir, cfg,
                   workers=args.workers or None)
    return 0


@command("abc2wav")
def cmd_abc2wav(argv) -> int:
    """ABC notation -> rendered audio in one step (the reference's
    ``--playabc``, .charles/music2midi/test/music21_tests.py:58-60):
    ``abc_parse.abc_to_midi`` + ``synth.render_midi`` + ``write_wav``."""
    p = argparse.ArgumentParser(prog="audax_torch abc2wav")
    p.add_argument("abc", nargs="?", default="",
                   help="path to an .abc file ('-' or omitted: read stdin)")
    p.add_argument("--abc-text", default="",
                   help="inline ABC string instead of a file")
    p.add_argument("--out", required=True, help="output .wav path")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--soundfont", default="",
                   help="SF2 soundfont (not ported: raises)")
    p.add_argument("--program", type=int, default=0)
    args = p.parse_args(argv)
    from audax_torch.data.audio_io import write_wav
    from audax_torch.data.synth import render_midi
    from audax_torch.symbolic.abc_parse import abc_to_midi
    if args.abc_text:
        text = args.abc_text
    elif args.abc and args.abc != "-":
        with open(args.abc) as fh:
            text = fh.read()
    else:
        text = sys.stdin.read()
    mf = abc_to_midi(text)
    audio = render_midi(mf, args.sample_rate,
                        soundfont=args.soundfont or None,
                        program=args.program)
    write_wav(args.out, audio, args.sample_rate)
    log.success("rendered %d notes -> %s (%.2f s)", len(mf.notes), args.out,
                len(audio) / args.sample_rate)
    print(args.out)
    return 0


@command("midi2abc")
def cmd_midi2abc(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch midi2abc")
    p.add_argument("--midi-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)
    from audax_torch.data.music_dataset import stage_midi2abc
    stage_midi2abc(args.midi_dir, args.out_dir, workers=args.workers or None)
    return 0


@command("gentokens-raw")
def cmd_gentokens_raw(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch gentokens-raw")
    p.add_argument("--abc-dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from audax_torch.data.music_dataset import stage_gentokens_raw
    stage_gentokens_raw(args.abc_dir, args.out)
    return 0


@command("gentokens-bpe")
def cmd_gentokens_bpe(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch gentokens-bpe")
    p.add_argument("--abc-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--vocab-size", type=int, default=2000)
    args = p.parse_args(argv)
    from audax_torch.data.music_dataset import stage_gentokens_bpe
    stage_gentokens_bpe(args.abc_dir, args.out_dir, args.vocab_size)
    return 0


@command("genparquet")
def cmd_genparquet(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch genparquet")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--abc-dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from audax_torch.data.music_dataset import stage_genparquet
    stage_genparquet(args.wav_dir, args.abc_dir, args.out)
    return 0


@command("make-midi-dataset")
def cmd_make_midi_dataset(argv) -> int:
    p = argparse.ArgumentParser(prog="audax_torch make-midi-dataset")
    p.add_argument("--num-items", type=int, default=0)
    p.add_argument("--out-dir", default="")
    p.add_argument("--soundfont", default="")
    args = p.parse_args(argv)
    from audax_torch.data.synth import make_midi_dataset
    print(make_midi_dataset(_datagen_cfg(num_items=args.num_items,
                                         out_dir=args.out_dir,
                                         soundfont=args.soundfont)))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("audax_torch commands:\n  " + "\n  ".join(sorted(_COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; available: "
              f"{', '.join(sorted(_COMMANDS))}", file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
