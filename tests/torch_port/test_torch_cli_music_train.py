"""The music-training subcommands of the port's command line
(``audax_torch/cli/main.py``: the data tools, ``data-quality``,
``train-lm``, ``train-music``, ``music-proof``, ``finetune-proof``)
against the JAX package's, in process, on the CPU.

The data tools are deterministic: their files and printed reports are
held equal (WAVs within one 16-bit step). The trainers and proofs draw
their random initial weights in each package's own way, so they are held
on what does not depend on the draw: the corpus and the files they write,
the printed parameter report, the history's and metrics' keys and steps,
and the proofs' targets row by row.
"""

import contextlib
import csv
import io
import json
import os

import numpy as np
import pytest
import torch

from audax.cli import main as jax_cli
from audax_torch.cli import main as cli
from audax_torch.data.audio_io import read_wav

PCM = 1.0 / 32768


def _run(mod, argv, cwd):
    """(exit code, stdout) of ``mod.main(argv)`` run in ``cwd``."""
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main(list(argv))
    finally:
        os.chdir(old)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both command lines' data tools over the same settings: a MIDI
    dataset, the stages on its .mid files, and the quality report."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for tag, mod in (("p", cli), ("j", jax_cli)):
        d = root / tag
        d.mkdir()
        res = {"make": _run(mod, ["make-midi-dataset", "--num-items", "6",
                                  "--out-dir", str(d / "gen")], d)}
        for argv in (["midi2wav", "--midi-dir", str(d / "gen"), "--out-dir",
                      str(d / "wav"), "--chunk-seconds", "2", "--workers",
                      "1"],
                     ["midi2abc", "--midi-dir", str(d / "wav"), "--out-dir",
                      str(d / "abc"), "--workers", "1"],
                     ["gentokens-raw", "--abc-dir", str(d / "abc"), "--out",
                      str(d / "raw.json")],
                     ["gentokens-bpe", "--abc-dir", str(d / "abc"),
                      "--out-dir", str(d / "bpe"), "--vocab-size", "200"],
                     ["genparquet", "--wav-dir", str(d / "wav"), "--abc-dir",
                      str(d / "abc"), "--out", str(d / "music.parquet")],
                     ["abc2wav", str(d / "abc" / "midi_00001.abc"), "--out",
                      str(d / "one.wav")]):
            res[argv[0]] = _run(mod, argv, d)
        res["quality"] = _run(mod, ["data-quality", "--parquet",
                                    str(d / "music.parquet"), "--kind",
                                    "music"], d)
        out[tag] = (d, res)
    return out


def test_data_tools_match_jax(data):
    (p, pres), (j, jres) = data["p"], data["j"]
    for name, (rc, text) in pres.items():
        assert rc == jres[name][0] == 0, name
    assert pres["make"][1].strip() == str(p / "gen" / "mididataset.csv")
    assert pres["quality"][1] == jres["quality"][1]
    for sub in ("gen/wavs", "wav", "abc", "bpe"):
        assert sorted(os.listdir(p / sub)) == sorted(os.listdir(j / sub))
        for name in os.listdir(p / sub):
            a, b = p / sub / name, j / sub / name
            if name.endswith(".wav"):
                np.testing.assert_allclose(read_wav(str(a))[0],
                                           read_wav(str(b))[0], atol=PCM)
            else:
                assert a.read_bytes() == b.read_bytes(), f"{sub}/{name}"
    assert (p / "raw.json").read_bytes() == (j / "raw.json").read_bytes()
    np.testing.assert_allclose(read_wav(str(p / "one.wav"))[0],
                               read_wav(str(j / "one.wav"))[0], atol=PCM)


def test_soundfont_and_moe_flags_raise(data, tmp_path, monkeypatch):
    """A soundfont that does not parse raises (no fallback voice).
    ``train-lm --moe-experts 4 --moe-top-k 2``,
    which raised before the MoE slice, now trains: the port started from
    the JAX command line's own initial weights (its ``init_causal_lm`` is
    swapped for JAX's draw through the weight bridge) keeps JAX's loss
    history, and its checkpoint reloads as an MoE LM."""
    import jax

    from audax.models import causal_lm as JLM
    from audax.train import lm as JTrain
    from audax_torch.models import causal_lm as PLM
    from audax_torch.models.bridge import causal_lm_from_numpy
    from audax_torch.train.checkpoints import load_pytree

    d = data["p"][0]
    with pytest.raises(ValueError, match="soundfont"):
        _run(cli, ["abc2wav", "--abc-text", "X:1\nK:C\nCDE|", "--out",
                   str(tmp_path / "x.wav"), "--soundfont", "a.sf2"],
             tmp_path)
    monkeypatch.setattr(PLM, "init_causal_lm", lambda cfg, gen, device=None:
                        causal_lm_from_numpy(jax.tree.map(
                            np.asarray, JLM.init_causal_lm(
                                JLM.CausalLMConfig(**vars(cfg)),
                                jax.random.key(0))), cfg, device=device))
    jax_history = []
    fit = JTrain.fit_lm
    monkeypatch.setattr(JTrain, "fit_lm", lambda *a, **k: (
        lambda out: (jax_history.extend(out[1]), out)[1])(fit(*a, **k)))
    moe = ["--moe-experts", "4", "--moe-top-k", "2", "--lm-size", "tiny",
           "--steps", "3", "--batch-size", "4", "--seq-len", "16",
           "--eval-every", "1"]
    for tag, mod, extra in (("p", cli, ["--device", "cpu", "--out",
                                        str(tmp_path / "p.json")]),
                            ("j", jax_cli, [])):
        dd = data[tag][0]
        rc, _ = _run(mod, ["train-lm", "--corpus", str(dd / "abc"),
                           "--tokenizer-dir", str(dd / "bpe"), "--out-dir",
                           str(tmp_path / tag / "lm")] + moe + extra,
                     tmp_path)
        assert rc == 0
    history = json.loads((tmp_path / "p.json").read_text())["history"]
    assert [r["step"] for r in history] == [r["step"] for r in jax_history]
    for row, jrow in zip(history, jax_history):
        for key in ("loss", "eval_loss"):
            assert row[key] == pytest.approx(jrow[key], rel=1e-4), key
    cfg_json = json.loads((tmp_path / "p" / "lm" / "config.json")
                          .read_text())
    jcfg_json = json.loads((tmp_path / "j" / "lm" / "config.json")
                           .read_text())
    assert (cfg_json["num_experts"], cfg_json["experts_per_tok"],
            cfg_json["moe_ffn_dim"]) == (4, 2, 16) == (
        jcfg_json["num_experts"], jcfg_json["experts_per_tok"],
        jcfg_json["moe_ffn_dim"])
    cfg = PLM.CausalLMConfig(**cfg_json)
    params = load_pytree(str(tmp_path / "p" / "lm" / "best"))
    assert params["layers"]["experts"]["gate"]["kernel"].shape == (
        cfg.layers, 4, cfg.d_model, 16)
    logits, router = PLM.lm_forward(params, cfg, torch.zeros(
        1, 8, dtype=torch.long), return_router_logits=True)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert router.shape == (cfg.layers, 8, 4)


def test_train_lm_matches_jax(data, tmp_path):
    """Three steps of the command line's tiny LM on the ABC folder: the
    same corpus, steps and checkpoint files; the last row's keys."""
    rows = {}
    for tag, mod, extra in (("p", cli, ["--device", "cpu", "--out",
                                        str(tmp_path / "p.json")]),
                            ("j", jax_cli, [])):
        d = data[tag][0]
        argv = ["train-lm", "--corpus", str(d / "abc"), "--tokenizer-dir",
                str(d / "bpe"), "--out-dir", str(tmp_path / tag / "lm"),
                "--lm-size", "tiny", "--steps", "3", "--batch-size", "4",
                "--seq-len", "16", "--eval-every", "3"] + extra
        rc, text = _run(mod, argv, tmp_path)
        assert rc == 0
        last, out_dir = text.strip().splitlines()[-2:]
        assert out_dir == str(tmp_path / tag / "lm")
        rows[tag] = eval(last)                      # the printed dict
    assert set(rows["p"]) == set(rows["j"]) and rows["p"]["step"] == 3
    # a random tiny LM starts near ln(V) in both packages
    assert rows["p"]["loss"] == pytest.approx(rows["j"]["loss"], rel=0.1)
    rec = json.loads((tmp_path / "p.json").read_text())
    assert rec["steps"] == 3 and rec["history"][-1]["step"] == 3
    p_cfg = json.loads((tmp_path / "p" / "lm" / "config.json").read_text())
    j_cfg = json.loads((tmp_path / "j" / "lm" / "config.json").read_text())
    assert {k: p_cfg[k] for k in j_cfg if k in p_cfg} == \
        {k: j_cfg[k] for k in p_cfg if k in j_cfg}
    assert {"best", "3"} <= set(os.listdir(tmp_path / "p" / "lm"))


def test_train_music_matches_jax(data, tmp_path, monkeypatch):
    """One epoch of the command line's tiny LM over a Whisper-tiny tower:
    the same parameter report (but the diagram's kernel names) and the same
    checkpoint directories."""
    monkeypatch.setenv("WHISPER_SIZE", "tiny")
    monkeypatch.setenv("MAX_TARGET_TOKENS", "48")
    reports = {}
    for tag, mod, extra in (("p", cli, ["--device", "cpu"]),
                            ("j", jax_cli, [])):
        d = data[tag][0]
        ck = tmp_path / tag / "ck"
        rc, text = _run(mod, ["train-music", "--parquet",
                              str(d / "music.parquet"), "--tokenizer-dir",
                              str(d / "bpe"), "--ckpt-dir", str(ck),
                              "--epochs", "1", "--batch-size", "2",
                              "--chunk-seconds", "1", "--lm-size", "tiny"]
                        + extra, tmp_path)
        assert rc == 0
        assert text.strip().splitlines()[-1] == str(ck)
        reports[tag] = [ln for ln in text.splitlines()
                        if ln[:1] not in (" ", "") or ln.startswith("  ")
                        and "|" not in ln and "[" not in ln]
        assert sorted(os.listdir(ck)) == ["best_model", "epoch_000"]
    table = [ln for ln in reports["p"] if "," in ln or "%" in ln]
    assert table and table == [ln for ln in reports["j"]
                               if "," in ln or "%" in ln]


def _csv_rows(path, key):
    with open(path, newline="") as fh:
        return [(r["file"], r[key], r["split"]) for r in csv.DictReader(fh)]


def test_music_proof_matches_jax(tmp_path):
    """A two-epoch proof without the encoder pretrain: the same melodies,
    targets and metrics keys; then the port alone with the encoder and LM
    pretrains (two steps each)."""
    argv = ["music-proof", "--items", "4", "--epochs", "2",
            "--holdout-items", "1", "--pretrain-encoder-steps", "0",
            "--chunk-seconds", "1"]
    out = {}
    for tag, mod, extra in (("p", cli, ["--device", "cpu"]),
                            ("j", jax_cli, [])):
        rc, text = _run(mod, argv + ["--out", str(tmp_path / tag)] + extra,
                        tmp_path)
        assert rc in (0, 1)
        out[tag] = json.loads(text.strip().splitlines()[-1])
    assert _csv_rows(out["p"]["csv"], "target_abc") == \
        _csv_rows(out["j"]["csv"], "target_abc")
    pm = json.loads(open(out["p"]["metrics"]).read())
    jm = json.loads(open(out["j"]["metrics"]).read())
    assert set(pm) == set(jm)
    for k in ("items", "eval_items", "holdout_items", "epochs"):
        assert pm[k] == jm[k], k
    rc, text = _run(cli, argv[:7] + ["--pretrain-encoder-steps", "2",
                                     "--pretrain-items", "4",
                                     "--pretrain-lm-steps", "2",
                                     "--pretrain-lm-items", "8",
                                     "--max-poly", "2", "--chunk-seconds",
                                     "1", "--out", str(tmp_path / "p2"),
                                     "--device", "cpu"], tmp_path)
    assert rc in (0, 1)
    metrics = json.loads(open(json.loads(
        text.strip().splitlines()[-1])["metrics"]).read())
    assert metrics["lm_pretrained"] and metrics["max_poly"] == 2


def test_finetune_proof_matches_jax(tmp_path):
    argv = ["finetune-proof", "--items", "3", "--steps", "2",
            "--holdout-items", "1", "--chunk-seconds", "1", "--d-model",
            "32", "--layers", "1"]
    out = {}
    for tag, mod, extra in (("p", cli, ["--device", "cpu"]),
                            ("j", jax_cli, [])):
        rc, text = _run(mod, argv + ["--out", str(tmp_path / tag)] + extra,
                        tmp_path)
        assert rc in (0, 1)
        out[tag] = json.loads(text.strip().splitlines()[-1])
    assert set(out["p"]) == set(out["j"])
    assert _csv_rows(out["p"]["csv"], "target") == \
        _csv_rows(out["j"]["csv"], "target")
    pm = json.loads(open(out["p"]["metrics"]).read())
    jm = json.loads(open(out["j"]["metrics"]).read())
    assert set(pm) == set(jm) and pm["items"] == jm["items"] == 3
