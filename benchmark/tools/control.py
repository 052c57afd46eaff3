"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's (the reference put in the program's place in
the next precision below the configuration's, held against the cell's
limits; the program's numbers of that run beside them) over a few, in one
process. Each seed runs the cell's own set-up, a short window at the
cell's own load and the check; one JSON line a seed. ``--fault
half_batch`` plants that fault in the fine-tune step, for its readings at
the cell's size.

    python3 benchmark/tools/control.py --workload turbo-speech-backlog \\
        --seconds 6 --seeds 11,12,13 --control-seeds 11,12,13
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=["half_batch"], default=None,
                    help="plant a fault in the timed path (fine-tune)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.lib import harness
    if args.fault == "half_batch":
        # half of each batch left out, the mean taken over the rest
        from audax_torch.train import seq2seq
        loss = seq2seq.seq2seq_loss

        def half(logits, labels):
            n = logits.shape[0] // 2
            return loss(logits[:n], labels[:n])

        seq2seq.seq2seq_loss = half
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          control=seed in ctrl)
        line = {"seed": seed, "control": seed in ctrl, "fault": args.fault,
                "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"],
                "limits": {k: v["limit"] for k, v in res["checks"].items()},
                "checks": {k: v["value"] for k, v in res["checks"].items()}}
        if "program" in res:
            line["program"] = {k: v["value"]
                               for k, v in res["program"].items()}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
