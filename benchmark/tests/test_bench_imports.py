"""Importing the harness and every cell's files loads neither JAX nor the
JAX package (top-level names compared whole: ``audax_torch`` passes)."""

import json
import subprocess
import sys

from tiny import ROOT

SNIPPET = r"""
import json, sys, importlib, pathlib
root = pathlib.Path(sys.argv[1]); sys.path.insert(0, str(root))
from benchmark.lib import harness
bm = json.loads((root / "BENCHMARK.json").read_text())
for w in bm["workloads"]:
    h = harness.Harness(root, w["name"], 1, 1.0, True, device="cpu")
    importlib.import_module("benchmark.loops." + h.mix["loop"])
for m in bm["end_to_end"] + bm["per_layer"]:
    r = harness.metric_reader(m["name"])
    if getattr(r, "ROOFLINE", None):
        importlib.import_module("benchmark.rooflines." + r.ROOFLINE)
import benchmark.reference.compare, benchmark.lib.serve, benchmark.run
import audax_torch.infer.continuous, audax_torch.train.seq2seq
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "audax"})
print(json.dumps(bad))
"""


def test_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SNIPPET, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_harness_reads_no_file_outside_its_folder():
    text = "".join(p.read_text() for p in (ROOT / "benchmark").rglob("*.py")
                   if "tests" not in p.parts)
    for name in ("chip_smoke", "bench.py", "tools/", "tests/"):
        hits = [ln for ln in text.splitlines()
                if name in ln and "benchmark/tools" not in ln]
        assert not hits, hits


def test_manifest_names_and_cells():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    import re
    ok = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert ok.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$",
                                                 m["unit"])
    for w in bm["workloads"]:
        assert ok.match(w["name"]) and w["chips"] == 1
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    for m in bm["per_layer"]:
        mv = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in mv or cell in mv["workloads"]
