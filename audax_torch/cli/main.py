"""audax_torch command line (port of ``audax/cli/main.py``'s registry,
``main``, the Whisper and LM presets, and its subcommands).

    python -m audax_torch.cli.main transcribe a.wav b.wav --size \\
        large-v3-turbo --ckpt turbo_int4/ --tokenizer-dir tok/
    python -m audax_torch.cli.main serve --ckpt turbo_int4/ --kv-quant
    python -m audax_torch.cli.main convert-hf --hf-dir hf/ --out ckpt/ \\
        [--kind causal-lm] [--quantize int4]
    python -m audax_torch.cli.main export-hf --ckpt ckpt/ --out hf/
    python -m audax_torch.cli.main infer-music --wav clip.wav \\
        --tokenizer-dir tok/ --ckpt trainable/ [--lm-ckpt lm/] [--constrained]

Each stage of the JAX command line is a subcommand of one entry point,
and the port registers all 35: the UrbanSound commands (``preprocess``,
``sample``, ``train-cnn``, ``test-cnn``, ``train-transformer``,
``test-transformer``, ``classifier-proof``), Whisper's (``transcribe``,
``detect-language``, ``finetune``, ``serve``, ``stream-serve``), weight
I/O (``convert-hf``, ``export-hf``, ``verify-parity``), the music data
tools (``make-midi-dataset``, ``midi2wav``, ``midi2abc``, ``abc2wav``,
``gentokens-raw``, ``gentokens-bpe``, ``genparquet``, ``data-quality``),
the music trainers (``train-lm``, ``train-music``), the proofs
(``music-proof``, ``finetune-proof``), ``infer-music``, the five benches
(``bench-rtf``, ``bench-streaming``, ``bench-continuous``,
``bench-speculative``, ``bench-train``: one JSON line each, with the JAX
command line's flags, keys and exit codes), ``memo2wav`` and ``demo``
(the browser demo, ``cli/demo_ui.py``).

``convert-hf`` and ``export-hf`` read and write HF directories without
``transformers`` or ``safetensors`` (``models/hf_files.py``);
``verify-parity --kind whisper|causal-lm`` imports ``transformers`` as its
reference and raises ``ImportError`` without it. Checkpoints are the port's
(``train/checkpoints.py``) or the JAX package's orbax trees (read through
the orbax reader and carried by ``models/bridge.py``), with the
``<ckpt>.config.json`` sidecar of true dims that ``convert-hf`` and
``finetune`` write. Audio inputs are WAV or any container the port's
native decoder reads over the system libav (``data/audio_io.py:
read_audio``); ``--soundfont`` renders through the port's SF2 synth
(``native/``). The mesh flags ``--dp``/``--tp``/``--fsdp`` build a (data,
model) mesh over the ranks of a ``torchrun`` launch (``_mesh_from_args``)
for ``finetune``, ``transcribe``, ``serve``, ``stream-serve``,
``train-cnn``, ``train-transformer``, ``train-lm``, ``train-music``,
``infer-music --wav-dir`` and ``bench-train``; rank 0 writes the files (and
answers the servers' clients, the other ranks following in lockstep).
``finetune --sp N`` builds a (data, seq) mesh instead and runs the
ring-attention step (``parallel/sp.py``). ``train-lm --moe-experts N``
pretrains a Qwen3-MoE-family decoder (the ragged impl, the Switch aux
loss), as the JAX command line does. The port's own flags: ``--device``
(default the CUDA card; ``cpu`` runs every kernel's plain version), ``--out`` on
``infer-music`` and ``train-lm`` (a JSON record of the run), ``--no-plot``
on ``test-*`` and ``classifier-proof`` (no confusion-matrix PNG, for a host
without matplotlib), and ``--tokenizer-dir`` on the Whisper benches (a
vocabulary whose size sets the LM head; the JAX benches always take a
small ad-hoc one).

    python -m audax_torch.cli.main bench-rtf --size base [--device cpu]
    python -m audax_torch.cli.main memo2wav --src-dir memos/ --dst-dir wavs/
    python -m audax_torch.cli.main demo --size tiny [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import struct
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


def _world_size() -> int:
    """The ranks of this launch: the process group's, else torchrun's
    ``WORLD_SIZE`` (1 without one)."""
    import torch.distributed as dist

    return (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", "1")))


def _mesh_from_args(args, device=None):
    """(mesh, fsdp) from --dp/--tp/--fsdp; (None, False) = one device. The
    ranks come from ``torchrun`` (``parallel/mesh.py:init_distributed``);
    a mesh larger than the world raises before any rank waits for
    another."""
    if not (args.dp or args.tp > 1 or args.fsdp):
        return None, False
    from audax_torch.core.config import MeshConfig
    from audax_torch.parallel.mesh import init_distributed, make_mesh

    world = _world_size()
    data = args.dp if args.dp else max(1, world // args.tp)
    if world % args.tp or data * args.tp > world:
        raise ValueError(f"mesh ({data} data x {args.tp} model) needs "
                         f"{data * args.tp} devices, only {world} present "
                         "(launch the ranks with torchrun)")
    init_distributed(device=device)
    mesh = make_mesh(MeshConfig(data=args.dp if args.dp else -1,
                                model=args.tp), device=device)
    log.info("mesh: %s%s", dict(zip(mesh.mesh_dim_names, mesh.shape)),
             " + FSDP" if args.fsdp else "")
    return mesh, args.fsdp


def _lead() -> bool:
    """Whether this process writes the files: rank 0, or the only one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


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
    if args.wav and (args.dp or args.tp > 1 or args.fsdp):
        p.error("a mesh serves --wav-dir (the continuous generator)")

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
    mesh, _ = _mesh_from_args(args, device)
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
            mesh=mesh, device=device)
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
        if not _lead():
            return 0
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

    import numpy as np
    import torch

    from audax_torch.core.runtime import resolve_device
    from audax_torch.models.causal_lm import init_causal_lm
    from audax_torch.symbolic.bpe import BPE
    from audax_torch.train.lm import LMTrainConfig, fit_lm
    from audax_torch.train.metrics_sink import MetricsSink

    device = resolve_device(args.device)
    mesh, fsdp = _mesh_from_args(args, device)
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
                                     "train": train_cfg.__dict__.copy()}) \
        if _lead() else None
    t0 = time.perf_counter()
    _, history = fit_lm(params, cfg, train_cfg, np.asarray(ids, np.int32),
                        ckpt_dir=args.out_dir, sink=sink, mesh=mesh,
                        fsdp=fsdp, device=device)
    seconds = time.perf_counter() - t0
    if not _lead():
        return 0
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
    mesh, fsdp = _mesh_from_args(args, device)
    lead = _lead()
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
    if lead:
        print(model_report(
            {"whisper(frozen)": model.audio_params,
             "adapter": model.params["adapter"], "lm": model.params["lm"]},
            trainable={"adapter": True, "lm": True},
            diagram=TWO_TOWER_DIAGRAM))
    sink = MetricsSink("two_tower", config=tt.asdict()) if lead else None
    fit_two_tower(model, ds, chunk_seconds=args.chunk_seconds, sink=sink,
                  ckpt_dir=args.ckpt_dir,
                  note_eval_every=args.note_eval_every, resume=args.resume,
                  mesh=mesh, fsdp=fsdp, device=device)
    if not lead:
        return 0
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
                   help="SF2 soundfont (default: the additive synth)")
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


# ------------------------------------------------ the Whisper and classifier
def _mel_from_args(args):
    from audax_torch.core.config import MelConfig
    over = {}
    if args.mels:
        over["n_mels"] = args.mels
    if args.hop:
        over["hop_length"] = args.hop
    if args.fft:
        over["n_fft"] = args.fft
    return replace(MelConfig.from_env(), **over)


def _add_mel_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mels", type=int, default=0)
    p.add_argument("--hop", type=int, default=0)
    p.add_argument("--fft", type=int, default=0)


def _read_audio(path: str, sample_rate: int):
    """Mono float32 samples of any audio file (WAV, or a compressed
    container through the native decoder) at ``sample_rate``."""
    from audax_torch.data.audio_io import read_audio, resample, to_mono
    x, rate = read_audio(path)
    x = to_mono(x)
    if rate != sample_rate:
        x = resample(x, rate, sample_rate)
    return x


@command("preprocess")
def cmd_preprocess(argv) -> int:
    """Featurize UrbanSound8K into one Parquet file (log-mel on the card)."""
    p = argparse.ArgumentParser(prog="audax_torch preprocess")
    p.add_argument("--dataset-root", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--limit", type=int, default=0)
    _add_mel_flags(p)
    _add_device_flag(p)
    args = p.parse_args(argv)
    from audax_torch.core.config import UrbanSoundConfig
    from audax_torch.data.urbansound import preprocess_to_parquet
    from audax_torch.frontend.features import LogMelFrontend
    us = UrbanSoundConfig.from_env()
    if args.dataset_root:
        us = replace(us, dataset_root=args.dataset_root)
    mel = _mel_from_args(args)
    path = preprocess_to_parquet(us, mel, args.out, limit=args.limit or None,
                                 frontend=LogMelFrontend(mel,
                                                         device=args.device))
    print(path)
    return 0


@command("sample")
def cmd_sample(argv) -> int:
    """Waveform + spectrogram PNG for one audio file (reference --sample-*
    flags)."""
    p = argparse.ArgumentParser(prog="audax_torch sample")
    p.add_argument("--wav", required=True)
    p.add_argument("--out", default="sample.png")
    _add_mel_flags(p)
    _add_device_flag(p)
    args = p.parse_args(argv)
    from audax_torch.core.config import UrbanSoundConfig
    from audax_torch.eval.plots import plot_sample
    from audax_torch.frontend.features import LogMelFrontend
    mel_cfg = _mel_from_args(args)
    x = _read_audio(args.wav, mel_cfg.sample_rate)
    feats = LogMelFrontend(mel_cfg, device=args.device)(
        x, mel_first=True).cpu().numpy()
    plot_sample(x, feats, mel_cfg.sample_rate, mel_cfg.hop_length, args.out,
                window_s=UrbanSoundConfig.from_env().duration_s,
                title=os.path.basename(args.wav))
    print(args.out)
    return 0


def _classifier_model(kind: str, n_mels: int, pool: str = "cls",
                      max_len: int = 2048):
    """The classifier of ``kind`` ("cnn" or "transformer") for inputs of
    ``n_mels`` bands, its config from the environment."""
    from audax_torch.core.config import (CNNClassifierConfig,
                                         TransformerClassifierConfig)
    from audax_torch.models.classifiers import (CNNClassifier,
                                                TransformerClassifier)
    if kind == "cnn":
        return CNNClassifier(CNNClassifierConfig.from_env(), n_mels=n_mels)
    return TransformerClassifier(
        replace(TransformerClassifierConfig.from_env(), pool=pool),
        max_len=max_len, n_mels=n_mels)


def _classifier_common(argv, model_kind: str, train: bool) -> int:
    p = argparse.ArgumentParser(
        prog=f"audax_torch {'train' if train else 'test'}-{model_kind}")
    p.add_argument("--parquet", required=True)
    p.add_argument("--run-name", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--pool", default="cls", choices=["cls", "mean"])
    _add_device_flag(p)
    if train:
        _add_mesh_flags(p)
    else:
        p.add_argument("--no-plot", action="store_true",
                       help="skip the confusion-matrix PNG (matplotlib)")
    args = p.parse_args(argv)

    from audax_torch.core.artifacts import stamped_name
    from audax_torch.core.config import (ClassifierTrainConfig, MelConfig,
                                         UrbanSoundConfig)
    from audax_torch.core.runtime import resolve_device
    from audax_torch.data.urbansound import load_split
    from audax_torch.eval.metrics import (URBANSOUND8K_CLASSES,
                                          classification_report,
                                          plot_confusion_matrix)
    from audax_torch.train.checkpoints import CheckpointManager
    from audax_torch.train.loops import evaluate_classifier, fit_classifier
    from audax_torch.train.metrics_sink import MetricsSink
    from audax_torch.train.optim import adamw
    from audax_torch.train.steps import TrainState, make_classifier_steps

    device = resolve_device(args.device)
    mesh = _mesh_from_args(args, device)[0] if train else None
    us = UrbanSoundConfig.from_env()
    tc = ClassifierTrainConfig.from_env()
    if args.epochs:
        tc = replace(tc, epochs=args.epochs)
    if args.batch_size:
        tc = replace(tc, batch_size=args.batch_size)
    mel = MelConfig.from_env()
    if train:
        data = load_split(args.parquet, us.train_folds)
        ev = load_split(args.parquet, [us.eval_fold])
        split = data
    else:
        split = load_split(args.parquet, [us.test_fold])
    model = _classifier_model(model_kind, split["x"].shape[-1], args.pool)
    run = args.run_name or stamped_name(
        f"urbansound8k_{model_kind}", n_mels=mel.n_mels,
        hop_length=mel.hop_length, batch_size=tc.batch_size, epochs=tc.epochs,
        learning_rate=tc.learning_rate, dropout=model.cfg.dropout)
    ckpt_dir = args.ckpt_dir or os.path.join("artifacts", "ckpt", run)

    if train:
        lead = _lead()
        sink = (MetricsSink(run, config={"model": model_kind, **tc.asdict()})
                if lead else None)
        mgr = CheckpointManager(ckpt_dir, config=tc.asdict())
        fit_classifier(model, data, ev if len(ev["y"]) else None, tc,
                       sink=sink, ckpt_manager=mgr, mesh=mesh, device=device)
        mgr.close()
        if sink is not None:
            sink.close()
        print(ckpt_dir)
        return 0

    # test: fold 10 from the latest checkpoint
    import torch
    model.to(device)
    state = TrainState.create(model, adamw(1e-3))
    mgr = CheckpointManager(ckpt_dir)
    restored = mgr.restore({"params": state.params,
                            "batch_stats": state.buffers})
    with torch.no_grad():
        for group, tensors in (("params", state.params),
                               ("batch_stats", state.buffers)):
            for name, t in tensors.items():
                t.copy_(restored[group][name])
    _, eval_step = make_classifier_steps(model)
    m, preds = evaluate_classifier(eval_step, state, split, tc.batch_size,
                                   10)
    print(classification_report(split["y"], preds, URBANSOUND8K_CLASSES))
    if args.no_plot:
        log.success("test accuracy %.4f", m["accuracy"])
    else:
        cm_path = os.path.join("artifacts", f"confusion_matrix_{run}.png")
        os.makedirs("artifacts", exist_ok=True)
        plot_confusion_matrix(split["y"], preds, URBANSOUND8K_CLASSES,
                              cm_path,
                              title=f"{model_kind} fold-{us.test_fold}")
        log.success("test accuracy %.4f; confusion matrix -> %s",
                    m["accuracy"], cm_path)
    mgr.close()
    return 0


@command("train-cnn")
def cmd_train_cnn(argv) -> int:
    return _classifier_common(argv, "cnn", train=True)


@command("test-cnn")
def cmd_test_cnn(argv) -> int:
    return _classifier_common(argv, "cnn", train=False)


@command("train-transformer")
def cmd_train_transformer(argv) -> int:
    return _classifier_common(argv, "transformer", train=True)


@command("test-transformer")
def cmd_test_transformer(argv) -> int:
    return _classifier_common(argv, "transformer", train=False)


def _read_sidecar(ckpt: str):
    path = ckpt.rstrip("/") + ".config.json" if ckpt else ""
    if path and os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return None


def _load_tree(path: str, convert, device):
    """A checkpoint's tree on ``device``: the port's format as it is, a JAX
    orbax tree (read on this host's CPU through ``read_orbax``) through
    ``convert``, the bridge of its layout."""
    import torch

    from audax_torch.models.whisper import tree_map
    from audax_torch.train.checkpoints import _is_orbax, load_pytree
    tree = load_pytree(path)
    if _is_orbax(os.path.abspath(path)):
        # float leaves as float32 (exact; bf16 has no numpy dtype), codes
        # as they are
        return convert(tree_map(lambda t: t.float() if t.is_floating_point()
                                else t, tree), device)
    return tree_map(lambda t: torch.as_tensor(t).to(device), tree)


def _load_whisper(size: str, ckpt: str, tokenizer_dir: str, device=None):
    """(params, cfg, tokenizer) from a size preset, an optional checkpoint
    (the port's, or a JAX orbax one; with its ``.config.json`` sidecar of
    true dims, which wins over the preset) and a tokenizer directory
    (vocab.json/merges.txt; a small ad-hoc vocab when none is given -- the
    weights are then random). A quantized tree is returned as it is."""
    import torch

    from audax_torch.core.config import WhisperConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.models.bridge import params_from_numpy
    from audax_torch.models.whisper import init_whisper_params
    from audax_torch.symbolic.bpe import BPE, train_bpe
    from audax_torch.symbolic.tokenizer import WhisperTokenizer

    device = resolve_device(device)
    cfg = _whisper_preset(size)
    dims = _read_sidecar(ckpt)
    if dims is not None:
        cfg = WhisperConfig(**dims)
    if tokenizer_dir and not os.path.exists(
            os.path.join(tokenizer_dir, "vocab.json")):
        # an explicit path that does not resolve is an error: the toy vocab
        # would decode a real checkpoint's ids into garbage
        raise FileNotFoundError(
            f"--tokenizer-dir {tokenizer_dir!r} has no vocab.json")
    if tokenizer_dir:
        bpe = BPE.load(tokenizer_dir)
        try:
            # real vocabs: the language count from the vocab size
            tok = WhisperTokenizer.for_vocab_size(bpe, cfg.vocab_size)
        except ValueError:
            tok = WhisperTokenizer(bpe)
    else:
        log.warning("no tokenizer dir; building a small ad-hoc BPE vocab")
        corpus = ["the quick brown fox jumps over the lazy dog"] * 4
        tok = WhisperTokenizer(train_bpe(corpus, vocab_size=300))
    if tok.vocab_size != cfg.vocab_size:
        if dims is not None:
            # the checkpoint's dims win: a mismatched cfg would shape-fail
            log.warning("tokenizer vocab %d != checkpoint vocab %d -- pass "
                        "the tokenizer the model was trained with",
                        tok.vocab_size, cfg.vocab_size)
        else:
            cfg = replace(cfg, vocab_size=tok.vocab_size)
    if ckpt:
        params = _load_tree(ckpt, lambda t, d: params_from_numpy(t, cfg, d),
                            device)
    else:
        params = init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                     device=device)
    return params, cfg, tok


@command("convert-hf")
def cmd_convert_hf(argv) -> int:
    """Convert a local HF checkpoint directory (Whisper or a Qwen/LLaMA-
    family causal LM) into the port's checkpoint and its ``.config.json``
    sidecar, reading ``config.json`` and the weights (``model.safetensors``,
    its sharded index, or ``pytorch_model.bin``) without ``transformers``
    (``models/hf_files.py``). No network: the directory must be local."""
    p = argparse.ArgumentParser(prog="audax_torch convert-hf")
    p.add_argument("--hf-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--kind", default="whisper", choices=["whisper",
                                                         "causal-lm"])
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="save int8/int4 weight-only serving weights "
                        "(models/quantize.py; loads straight into the "
                        "Transcriber and the serving engine)")
    args = p.parse_args(argv)
    from audax_torch.models.hf_files import read_config, read_state_dict
    from audax_torch.train.checkpoints import save_pytree

    hc = read_config(args.hf_dir)
    sd = read_state_dict(args.hf_dir)
    if args.kind == "whisper":
        from audax_torch.models.port import (port_whisper_state_dict,
                                             whisper_config_from_hf)
        cfg = whisper_config_from_hf(hc)
        params = port_whisper_state_dict(sd, cfg, device="cpu")
    else:
        from audax_torch.models.causal_lm import port_causal_lm_state_dict
        params, cfg = port_causal_lm_state_dict(sd, hc, device="cpu")
    del sd
    if args.quantize:
        from audax_torch.models.quantize import quantize_tree
        params = quantize_tree(params, bits=4 if args.quantize == "int4"
                               else 8)
    save_pytree(args.out, params)
    with open(args.out.rstrip("/") + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)
    log.success("ported %s (%s) -> %s", args.hf_dir, args.kind, args.out)
    print(args.out)
    return 0


@command("verify-parity")
def cmd_verify_parity(argv) -> int:
    """One-command parity harness: port a local HF checkpoint and hold the
    port's logits against the transformers forward (``--kind whisper``,
    with ``--audio-dir`` the transcriptions of both stacks too, or
    ``causal-lm``; both need ``transformers`` as the reference), or run the
    UrbanSound8K fold protocol against the published accuracies
    (``--kind classifier``)."""
    p = argparse.ArgumentParser(prog="audax_torch verify-parity")
    p.add_argument("--hf-dir", required=True,
                   help="local HF checkpoint directory")
    p.add_argument("--kind", default="whisper",
                   choices=["whisper", "causal-lm", "classifier"])
    p.add_argument("--audio-dir", default="",
                   help="wavs to transcribe with both stacks; .txt sidecars "
                        "(when present) add reference WER columns")
    p.add_argument("--tokenizer-dir", default="",
                   help="vocab.json/merges.txt dir (default: --hf-dir)")
    p.add_argument("--lang", default="en")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="max |logit diff| allowed for parity PASS")
    p.add_argument("--samples", type=int, default=16,
                   help="max clips from --audio-dir")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--report", default="",
                   help="write the full JSON report here")
    p.add_argument("--data-dir", default="",
                   help="[classifier] UrbanSound8K root (metadata/ + "
                        "audio/fold*/); featurized to Parquet first")
    p.add_argument("--parquet", default="",
                   help="[classifier] already-featurized Parquet")
    p.add_argument("--variant", default="v2", choices=["v1", "v2"],
                   help="[classifier] v1 = 64 mels hop 512 (published "
                        "64%%), v2 = 128 mels hop 128 (published 68%%)")
    p.add_argument("--model", default="cnn", choices=["cnn", "transformer"])
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--limit", type=int, default=0,
                   help="[classifier] cap clips featurized")
    _add_device_flag(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audax_torch.core.runtime import resolve_device
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    def finish(report, ok):
        if args.report:
            with open(args.report, "w") as fh:
                json.dump(report, fh, indent=2)
        print(json.dumps({k: v for k, v in report.items() if k != "clips"}))
        return 0 if ok else 1

    if args.kind == "classifier":
        from audax_torch.core.config import (ClassifierTrainConfig,
                                             MelConfig, UrbanSoundConfig)
        from audax_torch.data.urbansound import (load_split,
                                                 preprocess_to_parquet)
        from audax_torch.frontend.features import LogMelFrontend
        from audax_torch.train.loops import (evaluate_classifier,
                                             fit_classifier)
        from audax_torch.train.steps import make_classifier_steps

        if not (args.data_dir or args.parquet):
            p.error("--kind classifier needs --data-dir or --parquet")
        published = {"v1": 0.64, "v2": 0.68}[args.variant]
        mel = (MelConfig.urbansound_v1() if args.variant == "v1"
               else MelConfig.urbansound_v2())
        us = UrbanSoundConfig.from_env()
        parquet = args.parquet
        if not parquet:
            us = replace(us, dataset_root=args.data_dir)
            parquet = preprocess_to_parquet(
                us, mel, limit=args.limit or None,
                frontend=LogMelFrontend(mel, device=device))
        tc = ClassifierTrainConfig.from_env()
        if args.epochs:
            tc = replace(tc, epochs=args.epochs)
        if args.batch_size:
            tc = replace(tc, batch_size=args.batch_size)
        data = load_split(parquet, us.train_folds)
        ev = load_split(parquet, [us.eval_fold])
        test = load_split(parquet, [us.test_fold])
        model = _classifier_model(args.model, data["x"].shape[-1])
        state, _ = fit_classifier(model, data, ev if len(ev["y"]) else None,
                                  tc, device=device)
        _, eval_step = make_classifier_steps(model)
        accs = {}
        for name, split in (("fold9", ev), ("fold10", test)):
            if len(split["y"]):
                m, _ = evaluate_classifier(eval_step, state, split,
                                           tc.batch_size, us.num_classes)
                accs[f"{name}_accuracy"] = round(float(m["accuracy"]), 4)
        report = {"kind": "classifier", "variant": args.variant,
                  "model": args.model, "parquet": parquet,
                  "train_clips": int(len(data["y"])), **accs,
                  "published_accuracy": published,
                  "delta_vs_published": (
                      round(accs["fold10_accuracy"] - published, 4)
                      if "fold10_accuracy" in accs else None)}
        return finish(report, bool(accs))

    from audax_torch.models.hf_files import read_config
    hc = read_config(args.hf_dir)
    if args.kind == "causal-lm":
        # the reference's decoder tower family: port + teacher-forced
        # logit parity against transformers on the CPU
        from transformers import AutoModelForCausalLM

        from audax_torch.models.causal_lm import (lm_forward,
                                                  port_causal_lm_state_dict)
        from audax_torch.models.hf_files import read_state_dict
        params, cfg = port_causal_lm_state_dict(
            read_state_dict(args.hf_dir), hc, device=device)
        hf = AutoModelForCausalLM.from_pretrained(args.hf_dir).eval()
        toks = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int64)
        with torch.no_grad():
            ref = hf(input_ids=torch.from_numpy(toks)).logits.float().numpy()
            got = lm_forward(params, cfg, torch.from_numpy(toks).to(
                device)).float().cpu().numpy()
        diff = float(np.abs(got - ref).max())
        report = {"hf_dir": args.hf_dir, "kind": "causal-lm",
                  "logit_max_abs_diff": diff, "logit_tol": args.tol,
                  "logit_parity": diff <= args.tol}
        return finish(report, report["logit_parity"])

    from transformers import WhisperForConditionalGeneration

    from audax_torch.models.hf_files import read_state_dict
    from audax_torch.models.port import (port_whisper_state_dict,
                                         whisper_config_from_hf)
    from audax_torch.models.whisper import whisper_forward

    cfg = whisper_config_from_hf(hc)
    params = port_whisper_state_dict(read_state_dict(args.hf_dir), cfg,
                                     device=device)
    hf = WhisperForConditionalGeneration.from_pretrained(args.hf_dir).eval()
    mel = rng.standard_normal((1, 2 * cfg.n_audio_ctx, cfg.n_mels)) \
        .astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int64)
    with torch.no_grad():
        ref = hf(input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
                 decoder_input_ids=torch.from_numpy(toks)).logits.numpy()
        got = whisper_forward(params, cfg, torch.from_numpy(mel).to(device),
                              torch.from_numpy(toks).to(device)
                              ).float().cpu().numpy()
    diff = float(np.abs(got - ref).max())
    report = {"hf_dir": args.hf_dir, "kind": "whisper",
              "logit_max_abs_diff": diff, "logit_tol": args.tol,
              "logit_parity": diff <= args.tol}

    if args.audio_dir:
        from audax_torch.eval.wer import word_error_rate
        from audax_torch.frontend.features import pad_or_trim
        from audax_torch.infer.transcribe import Transcriber
        from audax_torch.symbolic.bpe import BPE
        from audax_torch.symbolic.tokenizer import WhisperTokenizer

        bpe = BPE.load(args.tokenizer_dir or args.hf_dir)
        try:
            tok = WhisperTokenizer.for_vocab_size(bpe, cfg.vocab_size)
        except ValueError:
            tok = WhisperTokenizer(bpe)
        tr = Transcriber(params, cfg, tok, lang=args.lang,
                         max_new_tokens=args.max_tokens,
                         temperature_fallback=False, device=device)
        rows, ours, theirs, refs = [], [], [], []
        paths = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
        for path in paths[: args.samples]:
            x = _read_audio(path, 16000)
            our_text = tr.transcribe(x).text.strip()
            # HF consumes the SAME features (the port's frontend), so the
            # comparison isolates the model and the decode
            feats = tr.frontend(pad_or_trim(torch.from_numpy(
                np.ascontiguousarray(x, np.float32)), tr.chunk_samples)[None])
            with torch.no_grad():
                ids = hf.generate(input_features=feats.cpu().transpose(1, 2),
                                  max_new_tokens=args.max_tokens)
            hf_text = tok.decode([int(t) for t in ids[0]]).strip()
            row = {"file": os.path.basename(path), "audax": our_text,
                   "hf": hf_text}
            side = os.path.splitext(path)[0] + ".txt"
            if os.path.exists(side):
                with open(side) as fh:
                    row["reference"] = fh.read().strip()
                refs.append(row["reference"])
            ours.append(our_text)
            theirs.append(hf_text)
            rows.append(row)
        report["clips"] = rows
        if rows:
            report["cross_wer_audax_vs_hf"] = round(
                word_error_rate(theirs, ours), 4)
        if refs and len(refs) == len(rows):
            report["wer_audax_vs_reference"] = round(
                word_error_rate(refs, ours), 4)
            report["wer_hf_vs_reference"] = round(
                word_error_rate(refs, theirs), 4)
    return finish(report, report["logit_parity"])


@command("export-hf")
def cmd_export_hf(argv) -> int:
    """Export a checkpoint (the port's, or a JAX orbax one) to a local HF
    checkpoint directory (config.json + model.safetensors or
    pytorch_model.bin), the inverse of ``convert-hf``, written without
    ``transformers``/``safetensors`` (``models/hf_files.py``)."""
    p = argparse.ArgumentParser(prog="audax_torch export-hf")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True, help="output HF directory")
    p.add_argument("--kind", default="whisper", choices=["whisper",
                                                         "causal-lm"])
    p.add_argument("--size", default="", choices=("",) + WHISPER_SIZES,
                   help="whisper size preset when no <ckpt>.config.json "
                        "sidecar exists")
    p.add_argument("--config", default="",
                   help="explicit config JSON (overrides the sidecar)")
    p.add_argument("--lora-ckpt", default="",
                   help="LoRA adapter checkpoint (finetune --lora) to merge "
                        "into the base weights before export")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--format", default="safetensors",
                   choices=["safetensors", "bin"],
                   help="safetensors (default; tied aliases dropped, "
                        "from_pretrained re-ties them from the config) or "
                        "a classic pytorch_model.bin")
    args = p.parse_args(argv)
    import torch

    from audax_torch.models.hf_files import write_config, write_state_dict

    cfg_path = args.config or (args.ckpt.rstrip("/") + ".config.json")
    if args.kind == "whisper":
        from audax_torch.core.config import WhisperConfig
        from audax_torch.models.bridge import (lora_from_numpy,
                                               params_from_numpy)
        from audax_torch.models.export import (export_whisper_state_dict,
                                               hf_whisper_config_dict)
        if os.path.exists(cfg_path):
            with open(cfg_path) as fh:
                cfg = WhisperConfig(**json.load(fh))
        elif args.size:
            cfg = _whisper_preset(args.size)
        else:
            raise FileNotFoundError(
                f"no config sidecar at {cfg_path}; pass --size or --config")
        params = _load_tree(args.ckpt,
                            lambda t, d: params_from_numpy(t, cfg, d), "cpu")
        lora_convert = lora_from_numpy
    else:
        from audax_torch.models.bridge import causal_lm_from_numpy
        from audax_torch.models.causal_lm import CausalLMConfig
        from audax_torch.models.export import (export_causal_lm_state_dict,
                                               hf_causal_lm_config_dict)
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(
                f"no config sidecar at {cfg_path}; pass --config")
        with open(cfg_path) as fh:
            cfg = CausalLMConfig(**json.load(fh))
        params = _load_tree(args.ckpt,
                            lambda t, d: causal_lm_from_numpy(t, cfg, d),
                            "cpu")
        lora_convert = None
    if args.lora_ckpt:
        from audax_torch.models.lora import merge_lora
        if lora_convert is None:
            raise NotImplementedError("--lora-ckpt merges Whisper adapters "
                                      "(finetune --lora)")
        params = merge_lora(params, _load_tree(args.lora_ckpt, lora_convert,
                                               "cpu"),
                            alpha=args.lora_alpha)
    if args.kind == "whisper":
        # a config smaller than the checkpoint would silently drop layers
        for tower, want in (("encoder", cfg.encoder_layers),
                            ("decoder", cfg.decoder_layers)):
            have = int(params[tower]["layers"]["attn_ln"]["scale"].shape[0])
            if have != want:
                raise ValueError(
                    f"config mismatch: checkpoint has {have} {tower} "
                    f"layers, config says {want} -- wrong --size/--config?")
        sd = export_whisper_state_dict(params, cfg)
        hf_cfg = hf_whisper_config_dict(cfg)
        tied = ["proj_out.weight"]
    else:
        sd = export_causal_lm_state_dict(params, cfg)
        hf_cfg = hf_causal_lm_config_dict(cfg)
        tied = ["lm_head.weight"] if cfg.tie_embeddings else []
    n = len(sd)
    # bf16 leaves (finetune --dtype bfloat16) are written as float32, as
    # the JAX command writes them
    sd = {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in sd.items()}
    if args.format == "safetensors":
        for k in tied:
            sd.pop(k, None)
    write_config(args.out, hf_cfg)
    write_state_dict(args.out, sd, format=args.format)
    log.success("exported %s (%s) -> %s (%d tensors)", args.ckpt, args.kind,
                args.out, n)
    print(args.out)
    return 0


def _suppress(spec: str):
    return spec if spec == "-1" else [int(t) for t in spec.split(",")
                                      if t.strip()]


def _dtype(name: str):
    import torch
    return torch.bfloat16 if name == "bfloat16" else torch.float32


@command("transcribe")
def cmd_transcribe(argv) -> int:
    """Batch wav -> text with a CSV and sidecars (reference:
    AB/wavToWhisper.py)."""
    p = argparse.ArgumentParser(prog="audax_torch transcribe")
    p.add_argument("wavs", nargs="+")
    p.add_argument("--size", default="tiny")
    p.add_argument("--ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--csv", default="transcriptions.csv")
    p.add_argument("--lang", default="en",
                   help="language code, or 'auto' for per-file detection")
    p.add_argument("--timestamps", action="store_true")
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--beam-width", type=int, default=1)
    p.add_argument("--best-of", type=int, default=5)
    p.add_argument("--patience", type=float, default=None)
    p.add_argument("--length-penalty", type=float, default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--draft-size", default="")
    p.add_argument("--draft-ckpt", default="")
    p.add_argument("--spec-tokens", type=int, default=8)
    p.add_argument("--no-speech-threshold", type=float, default=0.6)
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--seek", action="store_true")
    p.add_argument("--clip-timestamps", default=None)
    p.add_argument("--hallucination-silence-threshold", type=float,
                   default=None)
    p.add_argument("--vad-threshold-db", type=float, default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--suppress-tokens", default="-1")
    p.add_argument("--no-suppress-blank", action="store_true")
    p.add_argument("--output-format", default=None,
                   choices=["txt", "srt", "vtt", "tsv", "json", "all"])
    p.add_argument("--output-dir", default=None)
    p.add_argument("--max-line-width", type=int, default=None)
    p.add_argument("--max-line-count", type=int, default=None)
    p.add_argument("--max-words-per-line", type=int, default=None)
    p.add_argument("--highlight-words", action="store_true")
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)
    import torch

    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.transcribe import (Transcriber,
                                              batch_transcribe_to_csv)
    paths = []
    for w in args.wavs:
        paths.extend(sorted(glob.glob(os.path.join(w, "*.wav")))
                     if os.path.isdir(w) else [w])
    device = resolve_device(args.device)
    mesh, _ = _mesh_from_args(args, device)
    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    draft = None
    if args.draft_size:
        dparams, dcfg, _ = _load_whisper(args.draft_size, args.draft_ckpt,
                                         args.tokenizer_dir, device)
        if dcfg.vocab_size != cfg.vocab_size:
            if args.draft_ckpt:
                # never replace user weights: a random draft runs below the
                # no-draft baseline
                print(f"--draft-ckpt vocab {dcfg.vocab_size} does not match "
                      f"the target's {cfg.vocab_size}; the draft must share "
                      f"the target token space", file=sys.stderr)
                return 1
            from audax_torch.models.whisper import init_whisper_params
            dcfg = replace(dcfg, vocab_size=cfg.vocab_size)
            dparams = init_whisper_params(
                dcfg, torch.Generator().manual_seed(1), device=device)
        draft = (dparams, dcfg)
    hal = args.hallucination_silence_threshold
    want_subs = args.output_format in ("srt", "vtt", "tsv", "json", "all")
    want_words = (args.highlight_words or args.max_line_width is not None
                  or args.max_words_per_line is not None)
    tr = Transcriber(params, cfg, tok, lang=args.lang, task=args.task,
                     timestamps=args.timestamps or args.seek
                     or hal is not None or want_subs,
                     seek_by_timestamps=args.seek,
                     clip_timestamps=args.clip_timestamps,
                     hallucination_silence_threshold=hal,
                     word_timestamps=args.word_timestamps
                     or hal is not None or want_words,
                     beam_width=args.beam_width,
                     best_of=args.best_of, patience=args.patience,
                     length_penalty=args.length_penalty,
                     draft=draft, spec_tokens=args.spec_tokens,
                     no_speech_threshold=(args.no_speech_threshold
                                          if args.no_speech_threshold > 0
                                          else None),
                     suppress_tokens=_suppress(args.suppress_tokens),
                     suppress_blank=not args.no_suppress_blank,
                     vad_threshold_db=args.vad_threshold_db,
                     initial_prompt=args.initial_prompt,
                     dtype=_dtype(args.dtype), mesh=mesh, device=device)
    lead = _lead()
    rows = batch_transcribe_to_csv(
        tr, paths, args.csv if lead else None, write_sidecars=lead,
        output_format=args.output_format if lead else None,
        output_dir=args.output_dir, verbose=args.verbose and lead,
        writer_opts={"max_line_width": args.max_line_width,
                     "max_line_count": args.max_line_count,
                     "max_words_per_line": args.max_words_per_line,
                     "highlight_words": args.highlight_words})
    for r in rows:
        print(f"{r['file']}: {r.get('text', '')[:80]}")
    print(args.csv)
    return 0


@command("detect-language")
def cmd_detect_language(argv) -> int:
    """The spoken language of audio files (whisper detect_language over
    the first 30 s window)."""
    p = argparse.ArgumentParser(prog="audax_torch detect-language")
    p.add_argument("files", nargs="+")
    p.add_argument("--size", default="tiny")
    p.add_argument("--ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--top", type=int, default=5)
    _add_device_flag(p)
    args = p.parse_args(argv)
    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.transcribe import Transcriber
    device = resolve_device(args.device)
    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    tr = Transcriber(params, cfg, tok, device=device)
    sr = tr.frontend.cfg.sample_rate
    rc = 0
    for path in args.files:
        try:
            best, probs = tr.detect(_read_audio(path, sr))
            top = sorted(probs.items(), key=lambda kv: -kv[1])[: args.top]
            print(f"{os.path.basename(path)}: {best}  "
                  + "  ".join(f"{c}={q:.3f}" for c, q in top))
        except Exception as e:  # noqa: BLE001 - per-file tolerance
            print(f"{os.path.basename(path)}: error: {e}", file=sys.stderr)
            rc = 1
    return rc


@command("finetune")
def cmd_finetune(argv) -> int:
    """Whisper fine-tune on wavs + transcripts with WER tracking
    (reference: AB/fineTune.py); writes the serving weights and their
    ``.config.json`` sidecar, which ``transcribe --ckpt`` and
    ``export-hf`` read."""
    p = argparse.ArgumentParser(prog="audax_torch finetune")
    p.add_argument("--audio-dir", default="")
    p.add_argument("--transcript", default=None)
    p.add_argument("--labels-csv", default=None)
    p.add_argument("--size", default="tiny")
    p.add_argument("--ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--out", default="artifacts/whisper_ft")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--lora-rank", type=int, default=-1)
    p.add_argument("--accum-steps", type=int, default=0)
    p.add_argument("--dtype", default="", choices=["", "float32", "bfloat16"])
    p.add_argument("--compare-csv", default="")
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--spec-augment", action="store_true")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel axis size: a (data, seq) mesh "
                        "over the ranks, ring attention over the mel frames")
    p.add_argument("--chunk-seconds", type=float, default=30.0)
    p.add_argument("--eval-suppress-tokens", default="-1")
    p.add_argument("--moment-dtype", default="",
                   choices=["", "float32", "bfloat16", "int8"])
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)
    if args.sp > 1 and (args.tp > 1 or args.fsdp):
        p.error("--sp composes with --dp only (not --tp/--fsdp)")
    sp_dp = 0
    if args.sp > 1:
        # the ranks' count is checked before any checkpoint or dataset is
        # read: an infeasible --dp x --sp must not fail minutes into a run
        world = _world_size()
        sp_dp = args.dp if args.dp > 0 else max(1, world // args.sp)
        if sp_dp * args.sp > world:
            p.error(f"--dp {sp_dp} x --sp {args.sp} needs "
                    f"{sp_dp * args.sp} devices; {world} available "
                    "(launch the ranks with torchrun)")

    from audax_torch.core.config import FineTuneConfig, MelConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.train.checkpoints import save_pytree
    from audax_torch.train.finetune_loop import (build_speech_dataset,
                                                 finetune_whisper)
    from audax_torch.train.metrics_sink import MetricsSink

    device = resolve_device(args.device)
    sp_mesh = None
    if args.sp > 1:
        from audax_torch.parallel.mesh import (init_distributed,
                                               make_named_mesh)
        init_distributed(device=device)
        sp_mesh = make_named_mesh([("data", sp_dp), ("seq", args.sp)],
                                  device=device)
        mesh, fsdp = None, False
        log.info("SP mesh: %s", dict(zip(sp_mesh.mesh_dim_names,
                                          sp_mesh.shape)))
    else:
        mesh, fsdp = _mesh_from_args(args, device)
    lead = _lead()
    ft = FineTuneConfig.from_env()
    if args.steps:
        ft = replace(ft, max_steps=args.steps)
    if args.batch_size:
        ft = replace(ft, batch_size=args.batch_size)
    if args.lora_rank >= 0:
        ft = replace(ft, lora_rank=args.lora_rank)
    if args.accum_steps:
        ft = replace(ft, accum_steps=args.accum_steps)
    if args.dtype:
        ft = replace(ft, dtype=args.dtype)
    if args.ema_decay:
        ft = replace(ft, ema_decay=args.ema_decay)
    if args.spec_augment:
        ft = replace(ft, spec_augment=True)
    if args.moment_dtype:
        ft = replace(ft, moment_dtype=args.moment_dtype)

    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    mel_cfg = MelConfig.whisper(cfg.n_mels)
    if args.chunk_seconds != 30.0:
        ctx = int(args.chunk_seconds * mel_cfg.sample_rate) \
            // mel_cfg.hop_length // 2
        cfg = replace(cfg, n_audio_ctx=ctx)
        enc = dict(params["encoder"])
        if enc["pos"].shape[0] < ctx:
            raise ValueError(f"--chunk-seconds {args.chunk_seconds} needs "
                             f"{ctx} encoder positions; checkpoint has "
                             f"{enc['pos'].shape[0]}")
        enc["pos"] = enc["pos"][:ctx]
        params = {**params, "encoder": enc}
    examples = build_speech_dataset(args.audio_dir, tok, mel_cfg,
                                    transcript=args.transcript,
                                    labels_csv=args.labels_csv,
                                    chunk_seconds=args.chunk_seconds)
    if not examples:
        print("no training examples", file=sys.stderr)
        return 1

    before = None
    if args.compare_csv:
        tr0 = Transcriber(params, cfg, tok, chunk_seconds=args.chunk_seconds,
                          device=device)
        before = {ex["file"]: tr0.transcribe(ex["audio"]).text
                  for ex in examples}
    sink = MetricsSink("whisper_ft", config=ft.asdict()) if lead else None
    state, history = finetune_whisper(
        params, cfg, tok, examples, ft, mel_cfg=mel_cfg, sink=sink,
        eval_examples=examples,
        eval_suppress_tokens=_suppress(args.eval_suppress_tokens),
        mesh=mesh, fsdp=fsdp, sp_mesh=sp_mesh, device=device)
    serving = history["best_params"] or state.full_params()
    if not lead:
        return 0
    sink.close()
    save_pytree(args.out, serving)
    # the dims sidecar: a --chunk-seconds run carries a shortened
    # n_audio_ctx, which transcribe --ckpt and export-hf read
    with open(args.out.rstrip("/") + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)
    log.success("saved fine-tuned params -> %s (best WER %.3f)", args.out,
                history["best_wer"])
    if args.compare_csv:
        import csv
        tr1 = Transcriber(serving, cfg, tok, chunk_seconds=args.chunk_seconds,
                          device=device)
        with open(args.compare_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["file", "target", "previous",
                                               "finetuned"])
            w.writeheader()
            for ex in examples:
                w.writerow({"file": ex["file"], "target": ex["text"],
                            "previous": before.get(ex["file"], ""),
                            "finetuned": tr1.transcribe(ex["audio"]).text})
        print(args.compare_csv)
    print(args.out)
    return 0


@command("classifier-proof")
def cmd_classifier_proof(argv) -> int:
    """The UrbanSound fold protocol end to end on synthetic 10-class audio:
    datagen -> Parquet (log-mel on the card) -> train folds 1-8 / eval 9 ->
    test fold 10 -> metrics JSON and a confusion-matrix PNG."""
    p = argparse.ArgumentParser(prog="audax_torch classifier-proof")
    p.add_argument("--out", default="results")
    p.add_argument("--per-fold", type=int, default=20)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--model", default="transformer",
                   choices=["transformer", "cnn"])
    p.add_argument("--work-dir", default="artifacts/synth_urbansound")
    p.add_argument("--no-plot", action="store_true",
                   help="skip the confusion-matrix PNG (matplotlib)")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from audax_torch.core.config import (ClassifierTrainConfig,
                                         CNNClassifierConfig, MelConfig,
                                         TransformerClassifierConfig,
                                         UrbanSoundConfig)
    from audax_torch.core.runtime import resolve_device
    from audax_torch.data.synth import SYNTH_CLASSES, make_synthetic_urbansound
    from audax_torch.data.urbansound import load_split, preprocess_to_parquet
    from audax_torch.eval.metrics import plot_confusion_matrix
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.models.classifiers import (CNNClassifier,
                                                TransformerClassifier)
    from audax_torch.train.loops import evaluate_classifier, fit_classifier
    from audax_torch.train.steps import make_classifier_steps

    device = resolve_device(args.device)
    root = make_synthetic_urbansound(args.work_dir, per_fold=args.per_fold)
    us = UrbanSoundConfig(dataset_root=root,
                          parquet_dir=os.path.join(args.work_dir, "pq"))
    mel = MelConfig.urbansound_v2()
    parquet = preprocess_to_parquet(us, mel, frontend=LogMelFrontend(
        mel, device=device))
    tc = ClassifierTrainConfig(batch_size=16, epochs=args.epochs,
                               learning_rate=3e-4)
    data = load_split(parquet, list(us.train_folds))
    ev = load_split(parquet, [us.eval_fold])
    if args.model == "transformer":
        model = TransformerClassifier(TransformerClassifierConfig(),
                                      n_mels=mel.n_mels)
    else:
        model = CNNClassifier(CNNClassifierConfig(), n_mels=mel.n_mels)
    state, history = fit_classifier(model, data, ev, tc, num_classes=10,
                                    device=device)
    test = load_split(parquet, [us.test_fold])
    _, eval_step = make_classifier_steps(model)
    m, preds = evaluate_classifier(eval_step, state, test, tc.batch_size, 10)
    os.makedirs(args.out, exist_ok=True)
    if not args.no_plot:
        plot_confusion_matrix(
            test["y"], preds, list(SYNTH_CLASSES),
            os.path.join(args.out, "synthetic_urbansound_confusion.png"),
            title=f"{args.model} fold-10 (synthetic)")
    metrics = {"model": args.model, "per_fold": args.per_fold,
               "epochs": args.epochs,
               "test_accuracy": round(float(m["accuracy"]), 4),
               "test_f1_macro": round(float(m["f1_macro"]), 4),
               "eval_accuracy_last": round(
                   float(history["eval"][-1]["accuracy"]), 4)
               if history["eval"] else None,
               "classes": list(SYNTH_CLASSES)}
    with open(os.path.join(args.out, "synthetic_urbansound_metrics.json"),
              "w") as fh:
        json.dump(metrics, fh, indent=2)
    print(json.dumps(metrics))
    return 0 if m["accuracy"] >= 0.5 else 1


def _serve_until_stopped(server, on_stop) -> None:
    """``serve_forever`` until the server is shut down (from another
    thread) or interrupted, then ``on_stop()`` and close the socket."""
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        on_stop()
        server.server_close()


@command("stream-serve")
def cmd_stream_serve(argv) -> int:
    """Live streaming-ASR WebSocket server (RFC 6455 over the fixed-slot
    batched StreamingTranscriber)."""
    p = argparse.ArgumentParser(prog="audax_torch stream-serve")
    p.add_argument("--size", default="base")
    p.add_argument("--ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--batch-slots", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warm-up (first request pays it)")
    p.add_argument("--vad-threshold-db", type=float, default=None)
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)

    from audax_torch.cli import stream_server
    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.continuous import Lockstep
    from audax_torch.infer.streaming import StreamingTranscriber

    device = resolve_device(args.device)
    mesh, _ = _mesh_from_args(args, device)
    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    st = StreamingTranscriber(params, cfg, tok, batch_slots=args.batch_slots,
                              dtype=_dtype(args.dtype), device=device,
                              vad_threshold_db=args.vad_threshold_db,
                              mesh=mesh)
    del params
    if not args.no_warmup:
        log.info("warming up...")
        st.warmup()
    if mesh is not None:
        # rank 0 answers the WebSockets; every rank drains in lockstep
        st = Lockstep(st, recorded=("feed", "flush", "remove"), run="drain")
        if not _lead():
            st.follow()
            return 0
    server = stream_server.serve_streaming(st, host=args.host, port=args.port)
    log.success("streaming ASR on ws://%s:%d/ws?stream=<id>", args.host,
                server.server_address[1])

    def stop():
        if mesh is not None:
            with server.hub.lock:             # after any drain in flight
                st.stop()
    _serve_until_stopped(server, stop)
    return 0


@command("serve")
def cmd_serve(argv) -> int:
    """REST transcription server: every in-flight request is a slot of one
    continuous-batching engine (infer/continuous.py, cli/http_server.py)."""
    p = argparse.ArgumentParser(prog="audax_torch serve")
    p.add_argument("--size", default="base")
    p.add_argument("--ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--lang", default="en")
    p.add_argument("--max-tokens", type=int, default=224)
    p.add_argument("--steps-per-sync", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV caches (serving capacity tier)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warm-up (first request pays it)")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="admission cap before 429 (default 8x slots)")
    p.add_argument("--suppress-blank", action="store_true")
    p.add_argument("--suppress-tokens", default="-1")
    _add_device_flag(p)
    _add_mesh_flags(p)
    args = p.parse_args(argv)

    from audax_torch.cli import http_server
    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.continuous import ContinuousBatcher, Lockstep

    device = resolve_device(args.device)
    mesh, _ = _mesh_from_args(args, device)
    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    if mesh is not None:
        from audax_torch.parallel.sharding import shard_params
        params = shard_params(params, mesh, heads=cfg.heads)
    cb = ContinuousBatcher(
        params, cfg, tok, slots=args.slots, lang=args.lang,
        max_new_tokens=args.max_tokens, steps_per_sync=args.steps_per_sync,
        dtype=_dtype(args.dtype), kv_quant=args.kv_quant,
        suppress_blank=args.suppress_blank,
        suppress_tokens=_suppress(args.suppress_tokens), mesh=mesh,
        device=device)
    del params
    if not args.no_warmup:
        log.info("warming up (one full admit of every slot)...")
        cb.warmup()
    if mesh is not None:
        # rank 0 answers HTTP; every rank steps the engine in lockstep
        cb = Lockstep(cb)
        if not _lead():
            cb.follow()
            return 0
    server = http_server.serve_http(cb, host=args.host, port=args.port,
                                    max_inflight=args.max_inflight or None)
    log.success("POST audio to http://%s:%d/v1/audio/transcriptions",
                args.host, server.server_address[1])
    _serve_until_stopped(server, server.scheduler.shutdown)
    if mesh is not None:
        server.scheduler.join()        # its last step, then the followers
        cb.stop()
    return 0


# ----------------------------------------------------------- the benches
def _dtype_tag(args) -> str:
    return (args.dtype + ("+" + args.quantize if args.quantize else "")
            + ("+int8kv" if args.kv_quant else ""))


def _sync(device) -> None:
    """End a timed window: wait for the card's queued work."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(dtype: str) -> float:
    """The H100's peak for ``dtype``'s products, for ``mfu``."""
    from audax_torch.utils.profiling import H100_BF16_FLOPS, H100_F32_FLOPS
    return H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS


def _add_bench_model_flags(p: argparse.ArgumentParser) -> None:
    """The port's own flags of the Whisper benches."""
    p.add_argument("--tokenizer-dir", default="",
                   help="vocab.json/merges.txt whose size sets the LM head "
                        "(default: the JAX command line's small ad-hoc "
                        "vocab)")
    _add_device_flag(p)


@command("bench-rtf")
def cmd_bench_rtf(argv) -> int:
    """Serving real-time-factor benchmark: synthetic audio through the full
    Transcriber (frontend + encoder + KV-cached decode + fallback ladder).
    Prints one JSON line; exits 1 when the RTF is above the 0.05 target
    (BASELINE: Whisper-base RTF <= 0.05 on one chip), else 0. The
    Transcriber's wall time ends with a device synchronize."""
    p = argparse.ArgumentParser(prog="audax_torch bench-rtf")
    p.add_argument("--size", default="base")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seconds", type=float, default=120.0)
    p.add_argument("--batch-chunks", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="int8/int4 weight-only serving (models/quantize.py"
                   " / ops/int4_matmul.py)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 self+cross KV caches")
    p.add_argument("--no-fallback", action="store_true",
                   help="single greedy decode per chunk (random-weight "
                   "models always fail the quality gates, so the default "
                   "measures the full 6-temperature ladder -- the worst "
                   "case; trained checkpoints mostly decode once)")
    _add_bench_model_flags(p)
    args = p.parse_args(argv)

    import numpy as np

    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.transcribe import Transcriber
    from audax_torch.utils.profiling import mfu
    from audax_torch.utils.reports import param_count

    device = resolve_device(args.device)
    params, cfg, tok = _load_whisper(args.size, "", args.tokenizer_dir,
                                     device)
    tr = Transcriber(params, cfg, tok, max_new_tokens=args.max_new_tokens,
                     quantize=args.quantize, kv_quant=args.kv_quant,
                     temperature_fallback=not args.no_fallback,
                     dtype=_dtype(args.dtype), device=device)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(int(args.seconds * 16000))
             ).astype(np.float32)
    tr.transcribe(audio, batch_chunks=args.batch_chunks)   # warm-up
    best = min((tr.transcribe(audio, batch_chunks=args.batch_chunks)
                for _ in range(args.runs)), key=lambda r: r.rtf)
    rtf = best.rtf
    # approximate achieved TFLOP/s by the 2 * params * tokens rule (the
    # encoder: n_audio_ctx positions a 30 s window; the decoder: one full
    # forward an emitted token, the count re-derived from the text). The
    # decode reads weights far more than it multiplies, so a low share is
    # expected: the number puts the RTF beside the card, not a target.
    n_chunks = -(-int(args.seconds * 16000) // (30 * 16000))
    enc_tok = n_chunks * cfg.n_audio_ctx
    dec_tok = len(tok.encode(best.text)) + 6 * n_chunks
    flops = (2 * param_count(params["encoder"]) * enc_tok
             + 2 * param_count(params["decoder"]) * dec_tok)
    print(json.dumps({"metric": "whisper_rtf", "size": args.size,
                      "dtype": _dtype_tag(args),
                      "fallback_ladder": not args.no_fallback,
                      "seconds": args.seconds,
                      "value": round(rtf, 5), "target": 0.05,
                      **mfu(flops, best.wall_seconds,
                            peak=_peak(args.dtype))}))
    return 0 if rtf <= 0.05 else 1


@command("bench-streaming")
def cmd_bench_streaming(argv) -> int:
    """Batched multi-stream serving throughput: N concurrent streams of
    synthetic audio through StreamingTranscriber's fixed-slot batches.
    Reports audio-seconds transcribed per wall-second, i.e. how many
    real-time streams one card sustains (the timed drain ends with a
    device synchronize)."""
    p = argparse.ArgumentParser(prog="audax_torch bench-streaming")
    p.add_argument("--size", default="base")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--streams", type=int, default=16)
    p.add_argument("--windows", type=int, default=2,
                   help="30 s windows fed per stream")
    p.add_argument("--batch-slots", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"])
    p.add_argument("--kv-quant", action="store_true")
    _add_bench_model_flags(p)
    args = p.parse_args(argv)

    import numpy as np

    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.streaming import StreamingTranscriber

    device = resolve_device(args.device)
    params, cfg, tok = _load_whisper(args.size, "", args.tokenizer_dir,
                                     device)
    if args.quantize:
        from audax_torch.models.quantize import quantize_tree
        params = quantize_tree(params, bits=4 if args.quantize == "int4"
                               else 8)
    st = StreamingTranscriber(
        params, cfg, tok, batch_slots=args.batch_slots,
        max_new_tokens=args.max_new_tokens, kv_quant=args.kv_quant,
        dtype=_dtype(args.dtype), device=device)
    rng = np.random.default_rng(0)
    window = st.window

    def fill():
        for i in range(args.streams):
            for _ in range(args.windows):
                st.feed(f"s{i:03d}",
                        (0.1 * rng.standard_normal(window)).astype(np.float32))

    fill()
    st.drain()                                   # warm-up
    fill()
    audio_s = args.streams * args.windows * window / 16000.0
    _sync(device)
    t0 = time.perf_counter()
    segs = st.drain()
    _sync(device)
    wall = time.perf_counter() - t0
    if len(segs) != args.streams * args.windows:
        raise RuntimeError(f"bench-streaming: {len(segs)} segments for "
                           f"{args.streams * args.windows} windows")
    print(json.dumps({
        "metric": "streaming_realtime_streams_per_chip", "size": args.size,
        "dtype": _dtype_tag(args),
        "batch_slots": args.batch_slots, "streams": args.streams,
        "value": round(audio_s / wall, 2), "audio_seconds": audio_s,
        "wall_seconds": round(wall, 3)}))
    return 0


def _music_engine(args, rng, dtype, device):
    """``bench-continuous --engine music``: the two-tower (a Whisper
    audio tower + the Qwen3-0.6B-shaped decoder, or a tiny one), random
    from generator seed 0, its ContinuousGenerator factory and requests."""
    import numpy as np
    import torch

    from audax_torch.core.config import TwoTowerConfig
    from audax_torch.infer.continuous import ContinuousGenerator
    from audax_torch.models.causal_lm import CausalLMConfig
    from audax_torch.models.two_tower import build_two_tower

    audio_cfg = _whisper_preset(args.size)
    if args.lm_preset == "qwen3-0.6b":
        lm_cfg = replace(CausalLMConfig.qwen3_0_6b(),
                         max_seq=max(2048, 1 + args.max_new_tokens))
    else:
        lm_cfg = CausalLMConfig(
            vocab_size=1024, d_model=128, layers=2, heads=4, kv_heads=2,
            ffn_dim=256, qk_norm=True, tie_embeddings=True,
            max_seq=max(256, 1 + args.max_new_tokens))
    model = build_two_tower(TwoTowerConfig(), audio_cfg, lm_cfg,
                            lm_cfg.vocab_size,
                            torch.Generator().manual_seed(0), device=device)
    if args.quantize:
        from audax_torch.models.quantize import quantize_tree
        model = model._replace(params=quantize_tree(
            model.params, bits=4 if args.quantize == "int4" else 8))
    # constrained decoding: an allow set the size of an ABC alphabet
    allowed = list(range(3, 515))
    win = args.window_seconds
    audio = [(0.1 * rng.standard_normal(int(win * 16000))).astype(np.float32)
             for _ in range(args.requests)]

    def make():
        return ContinuousGenerator(
            model, start_id=0, end_id=1, slots=args.slots,
            window_seconds=win, max_new_tokens=args.max_new_tokens,
            temperature=0.7, steps_per_sync=args.steps_per_sync,
            dtype=dtype, allowed_ids=allowed, device=device)
    return make, audio


@command("bench-continuous")
def cmd_bench_continuous(argv) -> int:
    """Continuous batching against the convoy schedule on one
    variable-length workload (each request's max_tokens drawn uniformly,
    the shape of real transcript-length traffic). Convoy = admit a full
    batch, drain it completely, repeat (every slot waits for the
    slowest); continuous = slot refill mid-decode (infer/continuous.py).
    Both run on one engine, so the speedup is the schedule's alone. Each
    timed schedule ends with a device synchronize."""
    p = argparse.ArgumentParser(prog="audax_torch bench-continuous")
    p.add_argument("--engine", default="asr", choices=["asr", "music"],
                   help="asr: whisper ContinuousBatcher; music: two-tower "
                        "audio->ABC ContinuousGenerator (whisper-base "
                        "encoder + Qwen3-0.6B-shape decoder, constrained "
                        "decoding on -- the reference's music2midi serving "
                        "shape, model.py:209-213)")
    p.add_argument("--size", default="base")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--min-new-tokens", type=int, default=16)
    p.add_argument("--steps-per-sync", type=int, default=32)
    p.add_argument("--window-seconds", type=float, default=10.0,
                   help="music engine: per-request audio window")
    p.add_argument("--lm-preset", default="qwen3-0.6b",
                   choices=["qwen3-0.6b", "tiny"],
                   help="music engine decoder shape (tiny = smoke/test)")
    p.add_argument("--kv-quant", action="store_true")
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"])
    _add_bench_model_flags(p)
    args = p.parse_args(argv)

    import numpy as np

    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.continuous import ContinuousBatcher

    device = resolve_device(args.device)
    dtype = _dtype(args.dtype)
    rng = np.random.default_rng(0)
    budgets = rng.integers(args.min_new_tokens, args.max_new_tokens + 1,
                           args.requests)
    if args.engine == "music":
        make, audio = _music_engine(args, rng, dtype, device)
    else:
        params, cfg, tok = _load_whisper(args.size, "", args.tokenizer_dir,
                                         device)
        if args.quantize:
            from audax_torch.models.quantize import quantize_tree
            params = quantize_tree(params, bits=4 if args.quantize == "int4"
                                   else 8)
        audio = [(0.1 * rng.standard_normal(16000)).astype(np.float32)
                 for _ in range(args.requests)]

        def make():
            return ContinuousBatcher(
                params, cfg, tok, slots=args.slots,
                max_new_tokens=args.max_new_tokens,
                steps_per_sync=args.steps_per_sync, dtype=dtype,
                kv_quant=args.kv_quant, device=device)

    def continuous(cb):
        for i in range(args.requests):
            cb.submit(f"r{i}", audio[i], max_new_tokens=int(budgets[i]))
        return cb.run()

    def convoy(cb):
        out = []
        for lo in range(0, args.requests, args.slots):
            for i in range(lo, min(lo + args.slots, args.requests)):
                cb.submit(f"r{i}", audio[i], max_new_tokens=int(budgets[i]))
            out.extend(cb.run())          # barrier: drain the whole batch
        return out

    cb = make()
    cb.warmup()
    results = {}
    for name, fn in (("continuous", continuous), ("convoy", convoy)):
        steps0 = cb.steps_run
        _sync(device)
        t0 = time.perf_counter()
        got = fn(cb)
        _sync(device)
        wall = time.perf_counter() - t0
        if len(got) != args.requests:
            raise RuntimeError(f"bench-continuous {name}: {len(got)} of "
                               f"{args.requests} requests returned")
        toks = sum(len(r.tokens) for r in got)
        steps = cb.steps_run - steps0
        results[name] = {"wall_s": round(wall, 3),
                         "tokens_per_s": round(toks / wall, 1),
                         "decode_steps": steps,
                         # useful tokens per slot-step: the schedule's
                         # quality, independent of the host's latency
                         "slot_efficiency": round(
                             toks / (steps * args.slots), 3)}
    speedup = (results["convoy"]["wall_s"] /
               results["continuous"]["wall_s"])
    print(json.dumps({
        "metric": "continuous_batching_speedup_vs_convoy",
        "engine": args.engine,
        "size": args.size, "slots": args.slots,
        "requests": args.requests,
        "budget_range": [args.min_new_tokens, args.max_new_tokens],
        "dtype": _dtype_tag(args),
        "value": round(speedup, 3), **results}))
    return 0


@command("bench-speculative")
def cmd_bench_speculative(argv) -> int:
    """Speculative-decoding latency bench (one 30 s chunk, greedy). It
    reports the acceptance spectrum: a random-weight draft almost never
    agrees with a random-weight target (the floor: the verify overhead), a
    self-draft always agrees (the ceiling: the K-token verify amortised);
    a distilled draft lands between. Each timed call ends with a device
    synchronize."""
    p = argparse.ArgumentParser(prog="audax_torch bench-speculative")
    p.add_argument("--size", default="base")
    p.add_argument("--draft-size", default="tiny")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--spec-tokens", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--kv-quant", action="store_true")
    p.add_argument("--quantize", nargs="?", const="int8", default=None,
                   choices=["int8", "int4"],
                   help="int8/int4 weight-only target (draft stays float)")
    _add_bench_model_flags(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from audax_torch.core.runtime import resolve_device
    from audax_torch.frontend.features import LogMelFrontend
    from audax_torch.infer.decode import generate
    from audax_torch.infer.speculative import generate_speculative
    from audax_torch.models.whisper import encode, init_whisper_params

    device = resolve_device(args.device)
    params, cfg, tok = _load_whisper(args.size, "", args.tokenizer_dir,
                                     device)
    if args.quantize:
        from audax_torch.models.quantize import quantize_tree
        params = quantize_tree(params, bits=4 if args.quantize == "int4"
                               else 8)
    dtype = _dtype(args.dtype)
    # the draft shares the target's token space (deployments pair a
    # distilled draft with the same tokenizer, e.g. large-v3 + turbo)
    dcfg = replace(_whisper_preset(args.draft_size),
                   vocab_size=cfg.vocab_size)
    draft = init_whisper_params(dcfg, torch.Generator().manual_seed(1),
                                device=device)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((1, 30 * 16000))).astype(np.float32)
    with torch.inference_mode():
        mel = LogMelFrontend.whisper(cfg.n_mels, device=device)(audio)
        dmel = (mel if dcfg.n_mels == cfg.n_mels else LogMelFrontend.whisper(
            dcfg.n_mels, device=device)(audio))
        enc = encode(params, cfg, mel, dtype)
        denc = encode(draft, dcfg, dmel, dtype)
    prompt = torch.tensor([tok.sot_sequence(lang="en", timestamps=False)],
                          dtype=torch.long, device=device)
    max_len = prompt.shape[1] + args.max_new_tokens
    sup = torch.tensor([i for i in tok.special_ids() if i != tok.eot],
                       dtype=torch.long, device=device)

    def timed(fn, reps=3):
        fn()                                     # warm-up
        best = float("inf")
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        return best, out

    t_plain, ref = timed(lambda: generate(
        params, cfg, enc, prompt, max_len=max_len, eos_id=tok.eot,
        suppress=sup, dtype=dtype, kv_quant=args.kv_quant))
    t_draft, _ = timed(lambda: generate(
        draft, dcfg, denc, prompt, max_len=max_len, eos_id=tok.eot,
        suppress=sup, dtype=dtype))
    t_floor, o1 = timed(lambda: generate_speculative(
        draft, params, dcfg, cfg, denc, enc, prompt, max_len=max_len,
        eos_id=tok.eot, spec_tokens=args.spec_tokens, suppress=sup,
        dtype=dtype, kv_quant=args.kv_quant))
    # self-draft = acceptance 1.0 with a full-cost draft; subtracting the
    # target's own per-token cost isolates the span-verify overhead, from
    # which the cheap-draft ceiling follows: ceil = t_draft + t_span/K
    t_self, o2 = timed(lambda: generate_speculative(
        params, params, cfg, cfg, enc, enc, prompt, max_len=max_len,
        eos_id=tok.eot, spec_tokens=args.spec_tokens, suppress=sup,
        dtype=dtype, kv_quant=args.kv_quant))
    n = int(ref.lengths[0])
    # exact in exact arithmetic; in bf16 the span and the 1-row step take
    # other shapes, which can flip an argmax at a near-tie (random weights
    # hit them often): report the agreement rate
    want = ref.tokens[0, :n].cpu()
    agree = min(float((o.tokens[0, :n].cpu() == want).float().mean())
                for o in (o1, o2))
    tok_plain = t_plain / n
    tok_draft = t_draft / n
    span_per_tok = max(t_self / n - tok_plain, 0.0)   # verify amortised/K
    ceil_tok = tok_draft + span_per_tok
    print(json.dumps({
        "metric": "speculative_decode_ms_per_token", "size": args.size,
        "draft": args.draft_size, "dtype": _dtype_tag(args),
        "spec_tokens": args.spec_tokens, "tokens": n,
        "plain": round(tok_plain * 1e3, 3),
        "draft_alone": round(tok_draft * 1e3, 3),
        "floor_random_draft": round(t_floor / n * 1e3, 3),
        "ceiling_full_acceptance": round(ceil_tok * 1e3, 3),
        "ceiling_speedup": round(tok_plain / max(ceil_tok, 1e-9), 2),
        "greedy_agreement": round(agree, 4)}))
    return 0


@command("bench-train")
def cmd_bench_train(argv) -> int:
    """Fine-tune step throughput on the card: the seq2seq train step
    (optionally LoRA) over 30 s windows. ``mfu`` counts the analytic model
    FLOPs (``utils/flops.py:whisper_train_step_flops``) against the H100's
    peak for ``--dtype`` (bf16 tensor cores, or float32). The key
    ``xla_counted_tflops`` keeps the JAX command line's name for a counted
    rate: here ``FlopCounterMode`` over one step
    (``utils/profiling.py:step_flops``), which cannot see the hand-written
    kernels (the flash attention among them), as XLA's count could not see
    inside its scan. The timed steps end with a device synchronize.

    ``--dp/--tp/--fsdp`` run the step over a (data, model) mesh of the
    ``torchrun`` ranks, as ``finetune`` does: the state cut by the TP rules
    (and with ``--fsdp`` over 'data', ``parallel/fsdp.py:shard_state``),
    each rank's rows of the batch (``shard_batch``), and the analytic
    FLOPs divided by the mesh size for the per-card rate. Every rank
    prints its line; ``xla_counted_tflops`` stays this rank's count."""
    p = argparse.ArgumentParser(prog="audax_torch bench-train")
    p.add_argument("--size", default="tiny")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--label-len", type=int, default=32)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (master weights stay f32)")
    p.add_argument("--remat", default="full",
                   choices=["full", "dots", "none"],
                   help="gradient checkpointing: full recompute / save "
                   "matmul outputs / off")
    _add_mesh_flags(p)
    _add_bench_model_flags(p)
    args = p.parse_args(argv)

    import math

    import numpy as np
    import torch

    from audax_torch.core.config import FineTuneConfig
    from audax_torch.core.runtime import resolve_device
    from audax_torch.parallel.fsdp import shard_state
    from audax_torch.parallel.mesh import shard_batch
    from audax_torch.train.seq2seq import (collate_seq2seq, init_finetune,
                                           make_finetune_step)
    from audax_torch.utils.flops import whisper_train_step_flops
    from audax_torch.utils.profiling import mfu, step_flops

    device = resolve_device(args.device)
    mesh, fsdp = _mesh_from_args(args, device)
    params, cfg, tok = _load_whisper(args.size, "", args.tokenizer_dir,
                                     device)
    ft = FineTuneConfig(learning_rate=1e-4, warmup_steps=1, max_steps=10,
                        lora_rank=args.lora_rank)
    state = init_finetune(params, ft)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp, heads=cfg.heads)
    step = make_finetune_step(
        cfg, remat={"full": True, "dots": "dots", "none": False}[args.remat],
        dtype=_dtype(args.dtype))

    rng = np.random.default_rng(0)
    b = args.batch_size
    mel = torch.from_numpy(rng.standard_normal(
        (b, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)).to(device)
    rows = [list(rng.integers(3, cfg.vocab_size - 1, args.label_len))
            for _ in range(b)]
    lab = collate_seq2seq(rows, decoder_start_id=1)
    batch = {"mel": mel,
             "decoder_input_ids": torch.from_numpy(
                 lab["decoder_input_ids"]).long().to(device),
             "labels": torch.from_numpy(lab["labels"]).long().to(device)}
    if mesh is not None:
        batch = shard_batch(mesh, batch, device)
    flops = whisper_train_step_flops(
        cfg, b, int(batch["decoder_input_ids"].shape[1]),
        remat=args.remat, lora=args.lora_rank > 0) \
        / (math.prod(mesh.shape) if mesh is not None else 1)

    box = {}

    def first_step():
        box["state"], box["m"] = step(state, batch)
    counted = step_flops(first_step)      # the warm-up step, counted
    state = box["state"]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch)
    _sync(device)
    dt = (time.perf_counter() - t0) / args.steps
    print(json.dumps({
        "metric": "finetune_examples_per_sec", "size": args.size,
        "lora_rank": args.lora_rank, "batch_size": b, "dtype": args.dtype,
        "value": round(b / dt, 2), "sec_per_step": round(dt, 4),
        "audio_seconds_per_sec": round(b * 30.0 / dt, 1),
        "mesh": (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else None),
        "fsdp": bool(fsdp), **mfu(flops, dt, peak=_peak(args.dtype)),
        "xla_counted_tflops": round(counted / dt / 1e12, 2)}))
    return 0


# ------------------------------------------------ memos and the browser demo
@command("memo2wav")
def cmd_memo2wav(argv) -> int:
    """Batch-convert voice memos (m4a/mp3/...) to 16 kHz mono 16-bit WAV
    (reference: AB/memoToWav.py; decoded in process, no ffmpeg
    subprocess). Exits 1 when no file converted."""
    p = argparse.ArgumentParser(prog="audax_torch memo2wav")
    p.add_argument("--src-dir", required=True)
    p.add_argument("--dst-dir", required=True)
    p.add_argument("--rate", type=int, default=16000)
    args = p.parse_args(argv)

    from audax_torch.data.audio_io import memo_to_wav
    exts = (".m4a", ".mp4", ".mp3", ".ogg", ".flac", ".webm", ".wav")
    n = 0
    for name in sorted(os.listdir(args.src_dir)):
        if not name.lower().endswith(exts):
            continue
        src = os.path.join(args.src_dir, name)
        try:
            dst = memo_to_wav(src, args.dst_dir, rate=args.rate)
            log.info("%s -> %s", name, dst)
            n += 1
        except (ValueError, struct.error) as e:   # undecodable: skip it
            log.warning("skip %s: %s", name, e)
    log.success("converted %d file(s) -> %s", n, args.dst_dir)
    return 0 if n else 1


@command("demo")
def cmd_demo(argv) -> int:
    """Record-and-compare browser demo (reference: AB/UI/Asmo.py)."""
    p = argparse.ArgumentParser(prog="audax_torch demo")
    p.add_argument("--size", default="tiny")
    p.add_argument("--ckpt", default="")
    p.add_argument("--ft-ckpt", default="")
    p.add_argument("--tokenizer-dir", default="")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ft-steps", type=int, default=50,
                   help="steps for the UI's Finetune button "
                        "(AB/fineTune.py:175 used 50)")
    p.add_argument("--ft-lora-rank", type=int, default=4,
                   help="LoRA rank for the UI fine-tune (0 = full)")
    _add_device_flag(p)
    args = p.parse_args(argv)

    from audax_torch.cli.demo_ui import serve
    from audax_torch.core.runtime import resolve_device
    from audax_torch.infer.transcribe import Transcriber

    device = resolve_device(args.device)
    params, cfg, tok = _load_whisper(args.size, args.ckpt, args.tokenizer_dir,
                                     device)
    tr = Transcriber(params, cfg, tok, device=device)
    ft_tr = None
    if args.ft_ckpt:
        ft_params, _, _ = _load_whisper(args.size, args.ft_ckpt,
                                        args.tokenizer_dir, device)
        ft_tr = Transcriber(ft_params, cfg, tok, device=device)
    server = serve(tr, ft_tr, port=args.port, host=args.host,
                   ft_steps=args.ft_steps, ft_lora_rank=args.ft_lora_rank)
    _serve_until_stopped(server, lambda: None)
    return 0


def main(argv=None) -> int:
    """Run one command. A ``.env`` file in the working directory fills the
    environment variables that are not set yet (``core/config.py:
    load_dotenv``), which the configs' ``from_env`` then read."""
    from audax_torch.core.config import load_dotenv

    argv = list(sys.argv[1:] if argv is None else argv)
    load_dotenv()
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
