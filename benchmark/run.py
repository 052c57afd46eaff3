#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
the same window under ``torch.profiler`` and reports its per-layer
metrics. The run needs the CUDA card(s) the cell asks for and exits
without a result when they are missing, and when any module of the JAX
package (or JAX itself) was loaded. The numbers compared to decide
``correct`` come last on standard error and last in the result line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: caches of the program and its libraries, at fixed places in the checkout
CACHE = ROOT / ".bench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "audax"}


def _environment() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from benchmark.lib import harness
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the process loaded {bad}; the port must run "
              "without JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
