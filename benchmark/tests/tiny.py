"""A tiny Whisper and small engines for the CPU tests of the harness."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {"cfg.d_model": 64, "cfg.encoder_ffn_dim": 256,
        "cfg.decoder_ffn_dim": 256, "cfg.encoder_layers": 2,
        "cfg.decoder_layers": 2, "cfg.encoder_attention_heads": 2,
        "cfg.decoder_attention_heads": 2}


def overrides(cell: str) -> dict:
    ov = dict(TINY)
    if cell == "turbo-speech-backlog":
        ov.update({"mix.budget_tokens": [8, 16], "mix.check_tokens": 30,
                   "mix.engine": {"slots": 4, "steps_per_sync": 8}})
    elif cell == "small-finetune-bf16":
        dep = json.loads((ROOT / "benchmark/configs/whisper-small.json")
                         .read_text())["deployment"]
        ov["cfg.deployment"] = dict(dep, batch_size=4)
    return ov


def tiny_cfg(name: str = "whisper-large-v3-turbo") -> dict:
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    for k, v in TINY.items():
        cfg[k.split(".", 1)[1]] = v
    return cfg


def run(cell: str, seconds: float = 2.0, trace: bool = False, seed=4242,
        control: bool = False) -> dict:
    from benchmark.lib import harness
    return harness.run(ROOT, cell, seed, seconds, trace, device="cpu",
                       overrides=overrides(cell), control=control)
