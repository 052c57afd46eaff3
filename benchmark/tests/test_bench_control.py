"""The control: the reference put in the program's place in the next
precision below the configuration's (fp8 e4m3 products with e5m2
gradients for bf16) must come out not correct. Its numbers stand in the
program's place under the cell's own limits; the program's own numbers
from the same run come beside them (``program``).

On the card, at each cell's own size and on three seeds, the control must
fail a limit (``tools/control.py``). On the CPU, at a tiny size, the
control must read well above the program on the same seed, for one of
the compared numbers at least."""

import json
import subprocess
import sys

import pytest

import tiny

CELLS = ["turbo-speech-backlog", "small-finetune-bf16"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_tiny(cell):
    res = tiny.run(cell, seconds=2.0, control=True)
    control = {k: v["value"] for k, v in res["checks"].items()}
    program = {k: v["value"] for k, v in res["program"].items()}
    assert control.keys() == program.keys()
    assert {k: v["limit"] for k, v in res["checks"].items()} == \
        {k: v["limit"] for k, v in res["program"].items()}
    assert any(control[k] > 3 * program[k] for k in control
               if program[k] is not None), (control, program)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the control runs at the cell's "
                    "own size")
    seeds = "5100000001,5100000002,5100000003"
    out = subprocess.run(
        [sys.executable, str(tiny.ROOT / "benchmark/tools/control.py"),
         "--workload", cell, "--seconds", "4", "--seeds", seeds,
         "--control-seeds", seeds], capture_output=True, text=True,
        timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in out.stdout.splitlines():
        res = json.loads(line)
        assert res["control"] and res["correct"] is False, res
        assert any(v > res["limits"][k] for k, v in res["checks"].items()
                   if v is not None), res
