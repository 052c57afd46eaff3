"""Single-card training-MFU study: port of ``tools/mfu_study.py``.

Measures, in one process on the card:

  1. a ROOFLINE yardstick: a chained bf16 ``torch.matmul`` (x <- x @ w,
     n = 8192, ``slope_timed_chained`` in CUDA graphs) -- what the card
     delivers to a large product right now. It is a yardstick, not a
     kernel of the port;
  2. a grid of fine-tune train-step configurations (``GRID``: Whisper-small
     and -medium, full-parameter and LoRA, bf16 and one float32 anchor,
     remat full / dots / none, batches toward saturation, gradient
     accumulation), each reporting step time, examples/s, achieved TFLOP/s
     and its share of the H100's bf16 peak (``H100_BF16_FLOPS``, at the full
     700 W power limit) and of the roofline, and peak device memory.

The rates use the ANALYTIC model FLOPs (``utils/flops.py``).
``torch_counted_tflops`` is PyTorch's ``FlopCounterMode`` count of one step
(``utils/profiling.py:step_flops``) over the same time: a partial count,
because the counter cannot see the port's own CUDA kernels (the flash
attention forward and backward of every layer are missing from it).
``peak_mem_gb`` is ``torch.cuda.max_memory_allocated`` over the timed steps
(after ``reset_peak_memory_stats``), where the JAX tool read XLA's planned
memory. ``first_step_s`` is the first step's wall time (the JAX tool's
``compile_s``: there is nothing to compile ahead here). Each step is the
port's in-place step (``train/seq2seq.py:make_finetune_step``); the clock
reads the host around steps that end in a device read of the loss.

A configuration that does not fit is a result: a
``torch.cuda.OutOfMemoryError`` is recorded as ``{"oom": true, "error":
...}``, the cache is emptied and the study goes on; every other exception
propagates. ``--out`` is written after every row, and a study resumes from
it: rows already measured (OOM rows included) are not run again. Nothing is
written into ``results/``.

On the CPU (``--device cpu``) every size is cut to a tiny width
(``train_step_breakdown.cpu_cut``) and the roofline product is 256 wide;
its times say nothing of the card.

    python -m audax_torch.tools.mfu_study [--only 0,10] [--steps 10]
        [--moments float32|bfloat16|int8] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from audax_torch.core.config import FineTuneConfig
from audax_torch.core.runtime import resolve_device
from audax_torch.models.whisper import init_whisper_params
from audax_torch.tools import device_name
from audax_torch.tools.train_step_breakdown import (SIZES, cpu_cut,
                                                   synthetic_batch)
from audax_torch.train.seq2seq import init_finetune, make_finetune_step
from audax_torch.utils.flops import whisper_train_step_flops
from audax_torch.utils.profiling import (H100_BF16_FLOPS, slope_timed_chained,
                                         step_flops)

__all__ = ["GRID", "roofline_tflops", "run_config", "main", "cli"]

#: size, LoRA rank, batch, dtype, remat, gradient-accumulation steps (the
#: JAX tool's grid, index for index)
GRID = [
    ("small", 0, 8, "bfloat16", "dots", 1),
    ("small", 0, 8, "bfloat16", "none", 1),
    ("small", 0, 8, "bfloat16", "full", 1),
    ("small", 0, 8, "float32", "dots", 1),      # dtype anchor
    ("small", 0, 16, "bfloat16", "dots", 1),
    ("small", 0, 16, "bfloat16", "full", 1),
    ("small", 0, 32, "bfloat16", "full", 1),
    ("small", 0, 32, "bfloat16", "full", 2),
    ("small", 0, 64, "bfloat16", "full", 2),
    ("small", 0, 8, "bfloat16", "full", 4),
    ("small", 8, 16, "bfloat16", "dots", 1),
    ("small", 8, 16, "bfloat16", "full", 1),
    ("small", 8, 32, "bfloat16", "full", 1),
    ("medium", 0, 4, "bfloat16", "full", 1),
    ("medium", 0, 8, "bfloat16", "full", 2),
    ("medium", 8, 8, "bfloat16", "full", 1),
    ("medium", 8, 16, "bfloat16", "full", 2),
    ("medium", 0, 16, "bfloat16", "full", 4),
    ("medium", 0, 32, "bfloat16", "full", 8),
]
_REMAT = {"full": True, "dots": "dots", "none": False}
_KEYS = ("size", "lora_rank", "batch", "dtype", "remat", "accum")


def roofline_tflops(n: int = 8192, iters=(20, 120), repeats: int = 3,
                    device=None) -> float:
    """The card's deliverable bf16 product rate: ``x <- x @ w`` chained
    (every product feeds the next, so each FLOP is needed), ``w`` scaled
    by 1/sqrt(n) so the carry stays finite; 2 n^3 FLOPs per call over the
    slope of two chain lengths (CUDA graphs on the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((n, n)) / np.sqrt(n)).astype(
        np.float32)).to(dev, torch.bfloat16)
    x0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        dt = slope_timed_chained(lambda x, w_: x @ w_, x0, (w,), iters=iters,
                                 repeats=repeats)
    return 2.0 * n ** 3 / dt / 1e12


def run_config(size: str, lora_rank: int, batch: int, dtype: str,
               remat: str, accum: int = 1, steps: int = 10,
               label_len: int = 32, roof_tflops: float = 0.0,
               moments: str = "float32", device=None) -> dict:
    """One grid row: ``steps`` timed train steps after one untimed step."""
    dev = resolve_device(device)
    cfg = SIZES[size]()
    if dev.type == "cpu":
        cfg = cpu_cut(cfg)
    # the seeded draw on the host is set-up, outside every timed region
    params = init_whisper_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    ft = FineTuneConfig(learning_rate=1e-4, warmup_steps=1, max_steps=10 ** 6,
                        lora_rank=lora_rank, moment_dtype=moments)
    state = init_finetune(params, ft)
    del params
    step = make_finetune_step(
        cfg, remat=_REMAT[remat],
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
        accum_steps=accum)
    data, _ = synthetic_batch(cfg, batch, label_len, dev)
    cuda = dev.type == "cuda"

    t0 = time.perf_counter()
    state, m = step(state, data)
    float(m["loss"])
    first = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, data)
    loss = float(m["loss"])                     # waits for the last step
    dt = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    counted = step_flops(step, state, data)
    flops = whisper_train_step_flops(
        cfg, batch, int(data["decoder_input_ids"].shape[1]), remat=remat,
        lora=lora_rank > 0)
    tflops = flops / dt / 1e12
    return {"size": size, "lora_rank": lora_rank, "batch": batch,
            "dtype": dtype, "remat": remat, "accum": accum,
            "moments": moments, "sec_per_step": dt,
            "examples_per_sec": batch / dt,
            "audio_seconds_per_sec": batch * 30.0 / dt,
            "achieved_tflops": tflops,
            "mfu_pct_of_peak": 100 * tflops * 1e12 / H100_BF16_FLOPS,
            "pct_of_session_roofline": (100 * tflops / roof_tflops
                                        if roof_tflops else None),
            "torch_counted_tflops": counted / dt / 1e12,
            "peak_mem_gb": peak, "loss": loss, "first_step_s": first}


def main(device=None, out: Optional[str] = None, steps: int = 10,
         only: str = "", moments: str = "float32") -> dict:
    """The roofline, then the ``GRID`` rows named by ``only`` (comma list
    of indices; all when empty) that ``out`` does not hold yet."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rep = {"tool": "mfu_study", "device": device_name(dev),
           "h100_bf16_peak_tflops": H100_BF16_FLOPS / 1e12, "configs": []}
    if out and os.path.exists(out):             # resume a partial study
        with open(out) as fh:
            rep = json.load(fh)

    def save():
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as fh:
                json.dump(rep, fh, indent=1)

    if not rep.get("roofline_tflops"):
        rep["roofline_tflops"] = (roofline_tflops(device=dev) if cuda else
                                  roofline_tflops(256, (1, 3), 1, dev))
        print(json.dumps({"roofline_tflops": rep["roofline_tflops"]}),
              flush=True)
        save()
    roof = rep["roofline_tflops"]
    done = {tuple(c[k] for k in _KEYS) for c in rep["configs"]}
    pick = {int(i) for i in only.split(",") if i.strip()}
    for i, g in enumerate(GRID):
        if (pick and i not in pick) or g in done:
            continue
        size, lora, b, dt, rm, acc = g
        try:
            row = run_config(size, lora, b, dt, rm, accum=acc, steps=steps,
                             roof_tflops=roof, moments=moments, device=dev)
        except torch.cuda.OutOfMemoryError as e:   # not fitting is a result
            row = {**dict(zip(_KEYS, g)), "moments": moments, "oom": True,
                   "error": str(e).splitlines()[0][:300]}
        if cuda:
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rep["configs"].append(row)
        save()
    rep["verdict"] = ("oom" if any(c.get("oom") for c in rep["configs"])
                      else "measured")
    save()
    return rep


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the study here as JSON, and resume from it")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--only", default="",
                    help="comma list of grid indices to run (default all)")
    ap.add_argument("--moments", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="Adam moment storage of every configuration run "
                         "here (train/optim.py adamw_lp); use a separate "
                         "--out for non-float32 studies")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the plain versions at "
                         "a tiny width")
    a = ap.parse_args(argv)
    return main(device=a.device, out=a.out, steps=a.steps, only=a.only,
                moments=a.moments)


if __name__ == "__main__":
    cli()
