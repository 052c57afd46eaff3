"""The port's multi-rank dry run (``audax_torch/tools/dryrun_multichip.py``)
at four CPU ranks: every stage of the JAX package's dry run, in its order,
prints OK against its run without a mesh."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("EP Qwen3-MoE forward", "EP all_to_all dispatch",
          "PP x DP LM train step", "multi-host mesh",
          "SP encoder (ring attention)", "PP encoder over 2 stages",
          "SP x DP fine-tune step", "DP x TP fine-tune", "accum_steps=2",
          "FSDP (ZeRO-3", "TP decode", "DP x TP continuous batching")


def test_dryrun_four_ranks():
    r = subprocess.run([sys.executable, "-m",
                        "audax_torch.tools.dryrun_multichip", "4"],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    for i, name in enumerate(STAGES, 1):
        assert any(line.startswith(f"[dryrun] stage {i}: {name}")
                   and line.endswith("OK") for line in lines), name
    assert lines[-1] == f"dryrun_multichip(4): all {len(STAGES)} stages OK"
