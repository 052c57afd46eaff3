"""The Whisper and classifier commands on the CPU: each of the port's
fifteen new subcommands (``audax_torch/cli/main.py``) against the JAX
package's (``audax.cli.main._COMMANDS``), fed the same files.

Both command lines read the same JAX orbax checkpoints (the port through
its orbax reader and the weight bridge) with their ``.config.json``
sidecars, the same tokenizer directory and the same WAVs. A tiny Whisper
(d 32, 1+1 layers; 1 s windows, and a 30 s-window twin for the servers)
keeps each run to seconds. Random weights make the temperature fallback
sample, and each package samples from its own generator, so the
transcription cases run both Transcribers at temperature 0 only (the
fallback is the Transcriber's, held against JAX in its own tests): the
CSV text is then identical. ``finetune``'s loss history agrees at rel 1e-4,
``preprocess`` writes the same Parquet rows (log-mel within 2e-3), the
classifiers' histories agree at dropout 0 from the JAX init, and the
servers answer one request each with the same text. The mesh flags raise;
an mp3 (written by JAX's encoder) reads through the port's native decoder
in ``transcribe``, ``detect-language`` and ``sample`` with JAX's answers.
"""

import csv
import dataclasses
import functools
import json
import os
import re
import struct
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from audax.cli import main as jax_cli
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models.whisper import init_whisper_params as jax_init_whisper
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax.train.checkpoints import save_pytree as jax_save_pytree
from audax_torch.cli import main as cli
from audax_torch.data.audio_io import write_wav
from audax_torch.train.checkpoints import load_pytree

from .test_torch_streaming import _client_send, _connect

CORPUS = ["hello world how are you", "the cat sat on the mat"] * 3
TEXTS = ["hello world", "the cat sat", "how are you on the mat"]
SR = 16000


def _jax_whisper(root, name, n_audio_ctx, vocab, seed=0):
    jcfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=n_audio_ctx, d_model=32,
                            encoder_layers=1, decoder_layers=1, heads=2,
                            vocab_size=vocab, n_text_ctx=32)
    path = str(root / name)
    jax_save_pytree(path, jax_init_whisper(jcfg, jax.random.key(seed)))
    with open(path + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(jcfg), fh)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Tokenizer dir, a 1 s-window and a 30 s-window checkpoint, and three
    WAVs with transcript sidecars."""
    root = tmp_path_factory.mktemp("cli_whisper")
    bpe = jax_train_bpe(CORPUS, vocab_size=300)
    bpe.save(str(root / "tok"))
    vocab = JaxTokenizer(bpe).vocab_size
    wavs = root / "wavs"
    wavs.mkdir()
    r = np.random.default_rng(0)
    for i, text in enumerate(TEXTS):
        t = np.arange(int(2.5 * SR)) / SR
        x = (0.2 * np.sin(2 * np.pi * (200 + 100 * i) * t)
             + 0.05 * r.standard_normal(t.size)).astype(np.float32)
        write_wav(str(wavs / f"m{i}.wav"), x, SR)
        (wavs / f"m{i}.txt").write_text(text)
    return {"root": root, "tok": str(root / "tok"),
            "ckpt": _jax_whisper(root, "w1s", 50, vocab),
            "ckpt30": _jax_whisper(root, "w30s", 1500, vocab, seed=1),
            "wavs": sorted(str(p) for p in wavs.glob("*.wav"))}


@pytest.fixture
def greedy(monkeypatch):
    """Both Transcribers at temperature 0 only (no fallback sampling)."""
    from audax.infer import transcribe as JT
    from audax_torch.infer import transcribe as T
    for mod in (JT, T):
        monkeypatch.setattr(mod, "Transcriber", functools.partial(
            mod.Transcriber, temperature_fallback=False))


def _copies(files, tmp_path):
    """The WAVs copied into ``tmp_path``: ``transcribe`` writes a ``.txt``
    sidecar beside each input, which must not replace the fine-tune's
    transcripts."""
    import shutil
    d = tmp_path / "in"
    d.mkdir(exist_ok=True)
    return [shutil.copy(w, d) for w in files["wavs"]]


def _rows(path):
    with open(path, newline="") as fh:
        return {r["file"]: r for r in csv.DictReader(fh)}


@pytest.mark.parametrize("flags", [[], ["--beam-width", "2"],
                                   ["--timestamps"]],
                         ids=["greedy", "beam", "timestamps"])
def test_transcribe_csv_matches_jax(files, greedy, tmp_path, flags):
    common = (_copies(files, tmp_path) + ["--ckpt", files["ckpt"],
                                          "--tokenizer-dir", files["tok"]]
              + flags)
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "theirs.csv")
    assert cli.main(["transcribe"] + common + ["--csv", ours,
                                               "--device", "cpu"]) == 0
    assert jax_cli._COMMANDS["transcribe"](common + ["--csv", theirs]) == 0
    a, b = _rows(ours), _rows(theirs)
    assert a.keys() == b.keys() == {os.path.basename(w)
                                    for w in files["wavs"]}
    for k in b:
        assert "error" not in a[k]
        assert a[k]["text"] == b[k]["text"], k


def test_transcribe_output_formats_and_verbose(files, greedy, tmp_path,
                                               capsys):
    out_dir = str(tmp_path / "subs")
    wav = _copies(files, tmp_path)[0]
    assert cli.main(["transcribe", wav, "--ckpt", files["ckpt"],
                     "--tokenizer-dir", files["tok"], "--csv",
                     str(tmp_path / "a.csv"), "--output-format", "all",
                     "--output-dir", out_dir, "--verbose",
                     "--device", "cpu"]) == 0
    stem = os.path.splitext(os.path.basename(wav))[0]
    for ext in ("txt", "srt", "vtt", "tsv", "json"):
        assert os.path.exists(os.path.join(out_dir, f"{stem}.{ext}")), ext
    assert "-->" in capsys.readouterr().out


def test_detect_language_matches_jax(files, capsys):
    common = files["wavs"][:2] + ["--ckpt", files["ckpt"], "--tokenizer-dir",
                                  files["tok"], "--top", "3"]
    assert cli.main(["detect-language"] + common + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jax_cli._COMMANDS["detect-language"](common) == 0
    theirs = capsys.readouterr().out

    def parse(text):
        lines = [ln for ln in text.splitlines() if ln.startswith("m")]
        return [(ln.split()[0], ln.split()[1],
                 [(c, float(p)) for c, p in re.findall(r"(\w+)=([\d.]+)",
                                                       ln)])
                for ln in lines]
    a, b = parse(ours), parse(theirs)
    assert len(a) == len(b) == 2
    for (fa, la, pa), (fb, lb, pb) in zip(a, b):
        assert (fa, la) == (fb, lb)
        assert [c for c, _ in pa] == [c for c, _ in pb]
        np.testing.assert_allclose([p for _, p in pa], [p for _, p in pb],
                                   atol=1.5e-3)


def test_finetune_matches_jax_and_is_read_back(files, tmp_path, monkeypatch,
                                               greedy):
    """A full fine-tune (5 steps) by both command lines on the same WAVs:
    the loss histories agree at rel 1e-4; the port's checkpoint and
    sidecar are read back by ``transcribe --ckpt`` and ``export-hf``."""
    from audax.train import finetune_loop as JF
    from audax_torch.train import finetune_loop as F
    hist = {}
    for key, mod in (("jax", JF), ("torch", F)):
        real = mod.finetune_whisper

        def rec(*a, _real=real, _key=key, **k):
            state, h = _real(*a, **k)
            hist[_key] = h
            return state, h
        monkeypatch.setattr(mod, "finetune_whisper", rec)
    for k, v in dict(LEARNING_RATE="1e-3", WARMUP_STEPS="1", EVAL_EVERY="5",
                     LOSS_FETCH_EVERY="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    audio_dir = os.path.dirname(files["wavs"][0])
    common = ["--audio-dir", audio_dir, "--ckpt", files["ckpt"],
              "--tokenizer-dir", files["tok"], "--steps", "5",
              "--batch-size", "2", "--lora-rank", "0",
              "--chunk-seconds", "1.0"]
    ours = str(tmp_path / "ft_ours")
    assert cli.main(["finetune"] + common + ["--out", ours,
                                             "--device", "cpu"]) == 0
    assert jax_cli._COMMANDS["finetune"](
        common + ["--out", str(tmp_path / "ft_theirs")]) == 0
    np.testing.assert_allclose(hist["torch"]["loss"], hist["jax"]["loss"],
                               rtol=1e-4)
    with open(ours + ".config.json") as fh:
        with open(str(tmp_path / "ft_theirs.config.json")) as gh:
            assert json.load(fh) == json.load(gh)
    assert cli.main(["transcribe", _copies(files, tmp_path)[0], "--ckpt",
                     ours,
                     "--tokenizer-dir", files["tok"], "--csv",
                     str(tmp_path / "back.csv"), "--device", "cpu"]) == 0
    assert "error" not in next(iter(_rows(str(tmp_path / "back.csv"))
                                    .values()))
    assert cli.main(["export-hf", "--ckpt", ours, "--out",
                     str(tmp_path / "hf")]) == 0
    # LoRA: the merged serving weights, written and read back the same way
    lora = str(tmp_path / "ft_lora")
    lora_args = [a if a != "0" else "2" for a in common]    # --lora-rank 2
    assert cli.main(["finetune"] + lora_args + ["--out", lora,
                                                "--device", "cpu"]) == 0
    assert "decoder" in load_pytree(lora)
    assert cli.main(["export-hf", "--ckpt", lora, "--out",
                     str(tmp_path / "hf_lora")]) == 0


@pytest.fixture(scope="module")
def urbansound(tmp_path_factory):
    from audax_torch.data.synth import make_synthetic_urbansound
    root = str(tmp_path_factory.mktemp("us8k"))
    return make_synthetic_urbansound(root, per_fold=2)


def test_preprocess_writes_the_jax_rows(urbansound, tmp_path):
    from audax.data.urbansound import load_split as jax_load_split
    from audax_torch.data.urbansound import load_split
    ours, theirs = str(tmp_path / "ours.pq"), str(tmp_path / "theirs.pq")
    args = ["--dataset-root", urbansound, "--mels", "64", "--hop", "512"]
    assert cli.main(["preprocess"] + args + ["--out", ours,
                                             "--device", "cpu"]) == 0
    assert jax_cli._COMMANDS["preprocess"](args + ["--out", theirs]) == 0
    folds = list(range(1, 11))
    a, b = load_split(ours, folds), jax_load_split(theirs, folds)
    assert a["x"].shape == b["x"].shape == (20, 126, 64)
    np.testing.assert_array_equal(a["y"], b["y"])
    assert list(a["file"]) == list(b["file"])
    # the port's stated log-mel tolerance (tests/torch_port/
    # test_torch_urbansound.py)
    np.testing.assert_allclose(a["x"], b["x"], atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def parquet(urbansound, tmp_path_factory):
    from audax_torch.core.config import MelConfig, UrbanSoundConfig
    from audax_torch.data.urbansound import preprocess_to_parquet
    from audax_torch.frontend.features import LogMelFrontend
    mel = MelConfig.urbansound_v1()
    out = str(tmp_path_factory.mktemp("pq") / "us.parquet")
    return preprocess_to_parquet(UrbanSoundConfig(dataset_root=urbansound),
                                 mel, out, frontend=LogMelFrontend(
                                     mel, device="cpu"))


@pytest.mark.parametrize("kind", ["cnn", "transformer"])
def test_classifier_train_and_test_match_jax(parquet, tmp_path, monkeypatch,
                                             capsys, kind):
    """``train-<kind>`` by both command lines from the same initial
    weights at dropout 0: the epoch losses agree (atol 1e-4) and the eval
    metrics are equal; ``test-<kind>`` reads each one's checkpoint and
    prints the same report."""
    from flax.core import unfreeze

    from audax.data.urbansound import load_split as jax_load_split
    from audax.models.classifiers import CNNClassifier as JCNN
    from audax.models.classifiers import TransformerClassifier as JTC
    from audax.core.config import (CNNClassifierConfig as JCNNCfg,
                                   TransformerClassifierConfig as JTCCfg)
    from audax_torch.models.bridge import classifier_from_numpy
    monkeypatch.setenv("DROPOUT", "0.0")
    monkeypatch.setenv("EPOCHS", "2")
    monkeypatch.setenv("BATCH_SIZE", "8")
    monkeypatch.chdir(tmp_path)
    # the JAX loop initialises from key(seed) on its first train batch
    x0 = jax_load_split(parquet, list(range(1, 9)))["x"][:8]
    jm = (JCNN(JCNNCfg.from_env()) if kind == "cnn"
          else JTC(JTCCfg.from_env(), max_len=2048))
    v = unfreeze(jm.init({"params": jax.random.key(0),
                          "dropout": jax.random.key(0)},
                         jax.numpy.asarray(x0), train=True))
    real = cli._classifier_model

    def bridged(*a, **k):
        model = real(*a, **k)
        classifier_from_numpy(jax.tree.map(np.asarray, v), model)
        return model
    monkeypatch.setattr(cli, "_classifier_model", bridged)
    runs = {}
    for name, run in (("ours", lambda a: cli.main([f"train-{kind}"] + a
                                                  + ["--device", "cpu"])),
                      ("theirs", jax_cli._COMMANDS[f"train-{kind}"])):
        assert run(["--parquet", parquet, "--run-name", name,
                    "--ckpt-dir", str(tmp_path / f"ck_{name}")]) == 0
        with open(tmp_path / "artifacts" / "runs" /
                  f"{name}.metrics.jsonl") as fh:
            runs[name] = [r for r in map(json.loads, fh) if "epoch" in r]
    assert len(runs["ours"]) == len(runs["theirs"]) == 2
    for a, b in zip(runs["ours"], runs["theirs"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   atol=1e-4)
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], atol=1e-4)
        assert a["eval_accuracy"] == b["eval_accuracy"]
    capsys.readouterr()
    reports = []
    for name, run in (("ours", lambda a: cli.main([f"test-{kind}"] + a
                                                  + ["--device", "cpu"])),
                      ("theirs", jax_cli._COMMANDS[f"test-{kind}"])):
        assert run(["--parquet", parquet, "--run-name", name,
                    "--ckpt-dir", str(tmp_path / f"ck_{name}")]) == 0
        reports.append(capsys.readouterr().out)
        assert (tmp_path / "artifacts" /
                f"confusion_matrix_{name}.png").exists()
    assert reports[0].strip().splitlines()[:14] == \
        reports[1].strip().splitlines()[:14]
    assert cli.main([f"test-{kind}", "--parquet", parquet, "--run-name",
                     "ours", "--ckpt-dir", str(tmp_path / "ck_ours"),
                     "--no-plot", "--device", "cpu"]) == 0


def test_classifier_proof_runs_as_jax(tmp_path, monkeypatch):
    """``classifier-proof`` at a tiny size, by both command lines: the same
    metrics record (the accuracies from each package's own init)."""
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, run in (("ours", lambda a: cli.main(["classifier-proof"] + a
                                                  + ["--device", "cpu"])),
                      ("theirs", jax_cli._COMMANDS["classifier-proof"])):
        rc = run(["--out", str(tmp_path / name), "--per-fold", "2",
                  "--epochs", "1", "--model", "cnn",
                  "--work-dir", str(tmp_path / f"work_{name}")])
        with open(tmp_path / name / "synthetic_urbansound_metrics.json") as fh:
            out[name] = json.load(fh)
        assert rc == (0 if out[name]["test_accuracy"] >= 0.5 else 1)
        assert (tmp_path / name /
                "synthetic_urbansound_confusion.png").exists()
    assert out["ours"].keys() == out["theirs"].keys()
    for k in ("model", "per_fold", "epochs", "classes"):
        assert out["ours"][k] == out["theirs"][k]


def test_sample_writes_png(files, tmp_path):
    for name, run in (("ours", lambda a: cli.main(["sample"] + a
                                                  + ["--device", "cpu"])),
                      ("theirs", jax_cli._COMMANDS["sample"])):
        png = str(tmp_path / f"{name}.png")
        assert run(["--wav", files["wavs"][0], "--out", png]) == 0
        with open(png, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


# ---- the servers ----------------------------------------------------------
def _start(monkeypatch, module, attr, command, argv):
    """Run a server command on a thread; (holder with "server", thread)."""
    box = {}
    real = getattr(module, attr)

    def capture(*a, **k):
        box["server"] = real(*a, **k)
        return box["server"]
    monkeypatch.setattr(module, attr, capture)
    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", command(argv)), daemon=True)
    thread.start()
    deadline = time.time() + 300
    while "server" not in box:
        assert thread.is_alive() and time.time() < deadline, box
        time.sleep(0.05)
    return box, thread


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions", data=body,
        method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_serve_answers_as_jax(files, monkeypatch):
    from audax.cli import http_server as jax_http
    from audax_torch.cli import http_server
    with open(files["wavs"][1], "rb") as fh:
        body = fh.read()
    common = ["--ckpt", files["ckpt30"], "--tokenizer-dir", files["tok"],
              "--port", "0", "--slots", "2", "--max-tokens", "8",
              "--dtype", "float32", "--no-warmup"]
    answers = []
    for module, command, extra, stop in (
            (http_server, lambda a: cli.main(["serve"] + a), ["--device",
                                                              "cpu"], None),
            (jax_http, jax_cli._COMMANDS["serve"], [],
             lambda s: s.scheduler.shutdown())):
        box, thread = _start(monkeypatch, module, "serve_http", command,
                             common + extra)
        try:
            answers.append(_post(box["server"].server_address[1], body))
        finally:
            box["server"].shutdown()
            thread.join(60)
            if stop:
                stop(box["server"])
        assert not thread.is_alive() and box["rc"] == 0
    (code, ours), (jcode, theirs) = answers
    assert code == jcode == 200
    assert ours["tokens"] == theirs["tokens"]
    assert ours["text"] == theirs["text"]


def test_stream_serve_answers_as_jax(files, monkeypatch):
    from audax.cli import stream_server as jax_ws
    from audax_torch.cli import stream_server
    from audax_torch.cli.stream_server import OP_CLOSE, OP_TEXT, read_frame
    audio = (0.05 * np.random.default_rng(3).standard_normal(SR)).astype("<f4")
    common = ["--ckpt", files["ckpt30"], "--tokenizer-dir", files["tok"],
              "--port", "0", "--batch-slots", "2", "--dtype", "float32",
              "--no-warmup"]
    segs = []
    for module, command, extra in (
            (stream_server, lambda a: cli.main(["stream-serve"] + a),
             ["--device", "cpu"]),
            (jax_ws, jax_cli._COMMANDS["stream-serve"], [])):
        box, thread = _start(monkeypatch, module, "serve_streaming", command,
                             common + extra)
        try:
            sock = _connect(box["server"].server_address[1], "mic")
            _client_send(sock, 0x2, audio.tobytes())
            _client_send(sock, OP_TEXT, b"flush")
            op, payload = read_frame(sock)
            assert op == OP_TEXT
            segs.append(json.loads(payload))
            _client_send(sock, OP_CLOSE, struct.pack(">H", 1000))
            sock.close()
        finally:
            box["server"].shutdown()
            thread.join(60)
        assert not thread.is_alive() and box["rc"] == 0
    ours, theirs = segs
    assert ours["stream"] == theirs["stream"] == "mic"
    assert ours["text"] == theirs["text"]
    assert ours["audio_seconds"] == pytest.approx(theirs["audio_seconds"])


# ---- what is not ported yet raises ----------------------------------------
@pytest.mark.parametrize("cmd,extra", [
    ("transcribe", ["{wav}"]), ("serve", []), ("stream-serve", []),
    ("finetune", ["--audio-dir", "{dir}"]),
    ("train-cnn", ["--parquet", "x.pq"])])
@pytest.mark.parametrize("mesh", [["--dp", "2"], ["--tp", "2"],
                                  ["--dp", "2", "--fsdp"]])
def test_mesh_flags_raise(files, cmd, extra, mesh):
    """Each command builds its mesh over the ranks of a torchrun launch,
    and in one process a mesh of two ranks raises before any model is
    loaded."""
    extra = [e.format(wav=files["wavs"][0],
                      dir=os.path.dirname(files["wavs"][0])) for e in extra]
    with pytest.raises(ValueError, match="mesh"):
        cli.main([cmd] + extra + mesh + ["--device", "cpu"])


def test_sequence_parallel_raises(files, capsys):
    """``--sp 2`` in one process: the (data, seq) mesh needs two ranks,
    and argparse says so before any checkpoint or dataset is read."""
    with pytest.raises(SystemExit):
        cli.main(["finetune", "--audio-dir",
                  os.path.dirname(files["wavs"][0]), "--sp", "2",
                  "--device", "cpu"])
    assert "--sp 2 needs 2 devices; 1 available" in capsys.readouterr().err


@pytest.fixture(scope="module")
def memo(files):
    """An mp3 written by the JAX package's encoder, and a float32 WAV of the
    samples JAX's decoder reads from it (JAX's ``transcribe`` and
    ``sample`` read WAV only)."""
    from audax.data.audio_io import read_audio as jax_read_audio
    from audax.native.bindings import encode_audio_file
    root = files["root"]
    t = np.arange(int(2.5 * SR)) / SR
    x = (0.2 * np.sin(2 * np.pi * 330 * t)
         + 0.05 * np.random.default_rng(3).standard_normal(t.size))
    mp3, wav = root / "memo" / "memo.mp3", root / "memo_wav" / "memo.wav"
    mp3.parent.mkdir()
    wav.parent.mkdir()
    encode_audio_file(str(mp3), x.astype(np.float32), SR)
    y, rate = jax_read_audio(str(mp3))
    write_wav(str(wav), y, rate, bits=32)
    return {"mp3": str(mp3), "wav": str(wav)}


@pytest.mark.parametrize("cmd", ["transcribe", "detect-language", "sample"])
def test_compressed_input_matches_jax(files, memo, greedy, tmp_path,
                                      monkeypatch, capsys, cmd):
    """The same mp3 through the port's command (its native decoder) gives
    JAX's answer: ``detect-language`` reads the mp3 on both sides;
    JAX's ``transcribe`` and ``sample`` read WAV only, so they get the
    float32 WAV of the samples JAX's decoder gives."""
    model = ["--ckpt", files["ckpt"], "--tokenizer-dir", files["tok"]]
    if cmd == "transcribe":
        ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "theirs.csv")
        assert cli.main(["transcribe", memo["mp3"], *model, "--csv", ours,
                         "--device", "cpu"]) == 0
        assert jax_cli._COMMANDS["transcribe"](
            [memo["wav"], *model, "--csv", theirs]) == 0
        (a,), (b,) = _rows(ours).values(), _rows(theirs).values()
        assert a["file"] == "memo.mp3" and not a.get("error")
        assert a["text"] == b["text"]
    elif cmd == "detect-language":
        common = [memo["mp3"], *model, "--top", "3"]
        assert cli.main(["detect-language", *common, "--device", "cpu"]) == 0
        ours = capsys.readouterr().out.split()
        assert jax_cli._COMMANDS["detect-language"](common) == 0
        theirs = capsys.readouterr().out.split()
        assert ours[0] == "memo.mp3:" and ours[:2] == theirs[:2]
        assert [w.split("=")[0] for w in ours[2:]] == \
            [w.split("=")[0] for w in theirs[2:]]
        np.testing.assert_allclose(
            [float(w.split("=")[1]) for w in ours[2:]],
            [float(w.split("=")[1]) for w in theirs[2:]], atol=1.5e-3)
    else:
        from audax.eval import plots as jax_plots
        from audax_torch.eval import plots
        got = {}
        for name, mod in (("ours", plots), ("theirs", jax_plots)):
            monkeypatch.setattr(mod, "plot_sample", lambda x, f, *a, _n=name,
                                **k: got.__setitem__(_n, (np.asarray(x),
                                                          np.asarray(f))))
        assert cli.main(["sample", "--wav", memo["mp3"], "--out",
                         str(tmp_path / "a.png"), "--device", "cpu"]) == 0
        assert jax_cli._COMMANDS["sample"](
            ["--wav", memo["wav"], "--out", str(tmp_path / "b.png")]) == 0
        # the samples plotted are JAX's bit for bit; the log-mel beside
        # them is the frontend's, held against JAX in test_torch_frontend
        np.testing.assert_array_equal(got["ours"][0], got["theirs"][0])
        assert got["ours"][1].shape == got["theirs"][1].shape


def test_tokenizer_dir_without_vocab_raises(files, tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        cli.main(["transcribe", files["wavs"][0], "--tokenizer-dir",
                  str(tmp_path), "--device", "cpu"])


def test_registry_counts_the_ported_commands():
    """All 35 of the JAX command line's commands, and no other."""
    assert set(cli._COMMANDS) == set(jax_cli._COMMANDS)
    assert len(cli._COMMANDS) == 35
