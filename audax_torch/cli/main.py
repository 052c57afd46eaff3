"""audax_torch command line (port of ``audax/cli/main.py``'s registry,
``main``, the Whisper and LM presets and the ``infer-music`` subcommand).

    python -m audax_torch.cli.main infer-music --wav clip.wav \\
        --tokenizer-dir tok/ --ckpt trainable/ [--lm-ckpt lm/] [--constrained]
    python -m audax_torch.cli.main infer-music --wav-dir clips/ ... --slots 4

Each stage of the JAX command line is a subcommand of one entry point.
This port registers ``infer-music``; the other subcommands of the JAX
command line (preprocess, the trainers and testers, transcribe, serve,
convert-hf, the music data tools, ...) are not registered yet (ROADMAP
A12.2). The mesh flags (``--dp``/``--tp``/``--fsdp``) are accepted and
raise when set: tensor and data parallelism wait for the parallelism
slice. Two flags are the port's own: ``--device`` (default the CUDA card;
``cpu`` runs every kernel's plain version) and ``--out`` (a JSON record
of each request's tokens and text and of the run's decode steps and
seconds).
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch versions)")
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
