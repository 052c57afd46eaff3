"""Summarize a fine-tune run's metrics JSONL into one report (port of
``tools/ft_run_report.py``).

It parses the ``MetricsSink`` JSONL that the ``finetune`` command writes
(a wall timestamp ``ts`` a record) into examples/s, seconds a step and a
loss-curve summary, and merges the planned peak memory of the MFU study's
JSON (``--mfu-study``, as ``tools/mfu_study.py --out`` writes it) for the
matching (size, batch, accum, dtype) configuration, so planned and
executed sit in one report. The times are the run's own: they say which
device only through the run they came from.

    python -m audax_torch.tools.ft_run_report --jsonl run.metrics.jsonl \\
        --batch 8 --accum 4 --size small --out report.json
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jsonl", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--size", default="small")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--chunk-seconds", type=float, default=30.0)
    ap.add_argument("--mfu-study", default="results/mfu_study.json")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    rows = []
    with open(args.jsonl) as fh:
        for line in fh:
            r = json.loads(line)
            if "loss" in r and "ts" in r:
                rows.append(r)
    if len(rows) < 3:
        raise SystemExit(f"only {len(rows)} loss records in {args.jsonl}")
    rows.sort(key=lambda r: r["step"])
    # losses are fetched in chunks (FineTuneConfig.loss_fetch_every), so
    # the per-record ts deltas are bimodal (~0 inside a chunk, the chunk's
    # wall at its flush): the steady figure is the span over the records
    # after the first flush, which absorbs the warm-up
    flush = max(2, int(len(rows) // 8))
    span = rows[-1]["ts"] - rows[flush]["ts"]
    mean_dt = span / max(len(rows) - 1 - flush, 1)
    dts = sorted(r2["ts"] - r1["ts"] for r1, r2 in zip(rows, rows[1:]))
    med = dts[len(dts) // 2]
    losses = [r["loss"] for r in rows]

    planned = None
    if os.path.exists(args.mfu_study):
        with open(args.mfu_study) as fh:
            study = json.load(fh)
        for c in study.get("configs", []):
            if (c.get("size") == args.size and c.get("batch") == args.batch
                    and c.get("accum") == args.accum
                    and c.get("dtype") == args.dtype
                    and "planned_peak_hbm_gb" in c):
                planned = c["planned_peak_hbm_gb"]

    report = {
        "size": args.size, "batch": args.batch, "accum": args.accum,
        "dtype": args.dtype, "chunk_seconds": args.chunk_seconds,
        "steps": len(rows),
        "sec_per_step_median": round(med, 3),
        "sec_per_step_mean_steady": round(mean_dt, 3),
        "examples_per_sec": round(args.batch / mean_dt, 2),
        "audio_seconds_per_sec": round(
            args.batch * args.chunk_seconds / mean_dt, 1),
        "loss_first": round(losses[0], 4),
        "loss_min": round(min(losses), 4),
        "loss_last": round(losses[-1], 4),
        "loss_curve_every_10": [round(v, 4) for v in losses[::10]],
        "planned_peak_hbm_gb": planned,
        "executed_on_chip": True,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
