"""The port's three host tools (``audax_torch/tools/``) against the JAX
package's (``tools/``, imported by path): ``make_padded_tokenizer`` writes
the same vocabulary and merges, ``ft_run_report`` the same JSON from one
metrics JSONL, and ``preprocess_e2e_bench`` the same synthetic corpus and
the JAX pipeline's Parquet rows (log-mel within 2e-3) at 20 clips."""

import csv
import importlib.util
import json
import os
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest

from audax.core.config import MelConfig as JaxMel
from audax.core.config import UrbanSoundConfig as JaxUS
from audax.data.urbansound import preprocess_to_parquet as jax_preprocess
from audax_torch.tools import ft_run_report, make_padded_tokenizer
from audax_torch.tools import preprocess_e2e_bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOL_MEL = 2e-3


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    return _jax_tool(name).main()


def test_make_padded_tokenizer_matches_jax(tmp_path, monkeypatch, capsys):
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["filename", "labels"])
        w.writeheader()
        for i in range(12):
            w.writerow({"filename": f"{i}.wav", "labels":
                        f"<|MIDI|> C{i % 5} E{i % 4} G3 A{i % 3} <|/MIDI|>"})
    common = ["--labels-csv", str(labels), "--vocab-size", "700",
              "--bpe-vocab", "300"]
    assert make_padded_tokenizer.main(
        common + ["--out", str(tmp_path / "ours")]) == 0
    ours = capsys.readouterr().out
    assert _run_jax("make_padded_tokenizer",
                    common + ["--out", str(tmp_path / "theirs")],
                    monkeypatch) == 0
    theirs = capsys.readouterr().out
    assert ours.split(":", 1)[1] == theirs.split(":", 1)[1]
    assert "700 tokens" in ours
    for f in ("vocab.json", "merges.txt"):
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "theirs" / f).read_bytes()


def test_ft_run_report_matches_jax(tmp_path, monkeypatch, capsys):
    jsonl = tmp_path / "run.metrics.jsonl"
    rng = np.random.default_rng(0)
    ts = 1000.0
    with open(jsonl, "w") as fh:
        fh.write(json.dumps({"event": "start", "ts": ts}) + "\n")
        for step in range(1, 41):
            ts += 0.5 if step % 5 else 3.0 + rng.random()
            fh.write(json.dumps({"step": step, "ts": ts,
                                 "loss": 3.0 / step + rng.random() * 0.01})
                     + "\n")
    study = tmp_path / "mfu.json"
    study.write_text(json.dumps({"configs": [
        {"size": "small", "batch": 8, "accum": 4, "dtype": "bfloat16",
         "planned_peak_hbm_gb": 12.5},
        {"size": "small", "batch": 8, "accum": 1, "dtype": "bfloat16",
         "planned_peak_hbm_gb": 9.0}]}))
    common = ["--jsonl", str(jsonl), "--batch", "8", "--accum", "4",
              "--mfu-study", str(study)]
    assert ft_run_report.main(common + ["--out",
                                        str(tmp_path / "a.json")]) == 0
    assert _run_jax("ft_run_report", common + ["--out",
                                               str(tmp_path / "b.json")],
                    monkeypatch) == 0
    capsys.readouterr()
    a = json.loads((tmp_path / "a.json").read_text())
    assert a == json.loads((tmp_path / "b.json").read_text())
    assert a["planned_peak_hbm_gb"] == 12.5 and a["steps"] == 40
    with pytest.raises(SystemExit):
        ft_run_report.main(["--jsonl", str(study), "--batch", "8",
                            "--out", str(tmp_path / "c.json")])


def test_preprocess_e2e_bench_writes_jax_rows(tmp_path):
    ours_root, jax_root = tmp_path / "ours", tmp_path / "jax"
    rep = preprocess_e2e_bench.main(
        ["--clips", "20", "--batch", "8", "--root", str(ours_root),
         "--ref-sample", "4", "--device", "cpu",
         "--out", str(tmp_path / "rep.json")])
    assert rep["device"] == "cpu" and rep["parquet_rows"] == 20
    assert json.loads((tmp_path / "rep.json").read_text()) == rep
    assert rep["reference_style_clips_per_sec"] > 0
    # the JAX tool's corpus, featurized by the JAX pipeline
    _jax_tool("preprocess_e2e_bench").make_corpus(str(jax_root), 20)
    for d, _, names in os.walk(jax_root / "audio"):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), jax_root)
            assert (ours_root / rel).read_bytes() == (jax_root / rel
                                                      ).read_bytes()
    ref_path = jax_preprocess(
        JaxUS(dataset_root=str(jax_root), metadata_csv="UrbanSound8K.csv",
              parquet_dir=str(jax_root / "pq")),
        JaxMel.urbansound_v2(), str(jax_root / "ref.parquet"), batch_size=8)
    ours = pq.read_table(rep["parquet"]).to_pylist()
    ref = pq.read_table(ref_path).to_pylist()
    assert len(ours) == len(ref) == 20
    for a, b in zip(ours, ref):
        mel_a, mel_b = a.pop("log_mel"), b.pop("log_mel")
        assert a == b
        np.testing.assert_allclose(mel_a, mel_b, atol=TOL_MEL, rtol=0)
