"""``infer-music`` end to end on the CPU: the port's command line
(``audax_torch/cli/main.py``) against the JAX package's, and against the
port's own library calls.

Both command lines load the same files: a BPE trained on a small ABC
corpus and extended with 128 added ABC tokens, a trainable-only two-tower
checkpoint and a pretrained-LM tree, both written by the JAX package with
orbax (so the port reads them through its orbax reader), at the command
line's tiny LM with a Whisper-tiny audio tower. Each package draws its own
random audio tower, so the JAX parity runs keep the adapter's gates at
zero (the audio then cannot reach the logits): at temperature 0 the two
command lines print the same text for ``--wav`` and ``--wav-dir``. With the
gates open, ``--constrained`` and ``--prompt`` are held against the port's
``generate`` and ``ContinuousGenerator`` on the model the test rebuilds.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.cli import main as jax_cli
from audax.core.config import TwoTowerConfig as JaxTTConfig
from audax.models import causal_lm as JLM
from audax.models import two_tower as JT
from audax.train import checkpoints as JCK
from audax.train import two_tower as JTrain
from audax_torch.cli import main as cli
from audax_torch.core.config import TwoTowerConfig, WhisperConfig
from audax_torch.data.audio_io import read_wav, write_wav
from audax_torch.frontend.features import LogMelFrontend, pad_or_trim
from audax_torch.infer.continuous import ContinuousGenerator
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.models.two_tower import build_two_tower
from audax_torch.symbolic.bpe import BPE, train_bpe
from audax_torch.train.checkpoints import load_pytree
from audax_torch.train.two_tower import load_trainable_checkpoint

ABC = ["X:1\nT:Reel\nM:4/4\nK:D\n|:d2fd Adfd|e2ge Bege|dcde fgaf|gfed cdeB:|",
       "X:2\nM:6/8\nK:G\nGAB c2d|e2d B2G|ABc d2B|A3 G3|]",
       "X:3\nM:3/4\nK:Am\nA2 c2 e2|a4 g2|f2 e2 d2|c6|]"] * 3
ABC_TOKENS = (["<abc_start>", "<abc_end>", "<abc_pad>"]
              + [f"<abc_{i}>" for i in range(125)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(root, vocab size): tokenizer, JAX checkpoints (gates shut and
    open), and three wavs."""
    root = tmp_path_factory.mktemp("music")
    return root, write_music_files(root)


def write_music_files(root):
    """Write ``files``' tokenizer, checkpoints and wavs under ``root``;
    returns the vocabulary size."""
    bpe = train_bpe(ABC, vocab_size=300)
    bpe.add_tokens(ABC_TOKENS)
    bpe.save(str(root / "tok"))
    vocab = len(bpe)
    lm_cfg = JLM.CausalLMConfig(vocab_size=vocab, d_model=128, layers=4,
                                heads=4, kv_heads=2)
    lm = JLM.init_causal_lm(lm_cfg, jax.random.key(1))
    JCK.save_pytree(str(root / "lm"), lm)
    rng = np.random.default_rng(1)
    trained = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape),
                                         a.dtype), lm)
    adapter = JT.init_adapter(jax.random.key(2), 384, 128)
    shim = SimpleNamespace(cfg=JaxTTConfig(), lm_cfg=lm_cfg)
    JTrain.save_trainable_checkpoint(
        str(root / "shut"), SimpleNamespace(
            step=jnp.int32(0), params={"adapter": adapter, "lm": trained}),
        shim, save_optimizer=False)
    opened = dict(adapter)
    for gate in ("out", "ffn_out"):
        k = adapter[gate]["kernel"]
        opened[gate] = {**adapter[gate], "kernel": jnp.asarray(
            rng.standard_normal(k.shape) / np.sqrt(k.shape[0]), k.dtype)}
    JTrain.save_trainable_checkpoint(
        str(root / "open"), SimpleNamespace(
            step=jnp.int32(0), params={"adapter": opened, "lm": trained}),
        shim, save_optimizer=False)
    (root / "wavs").mkdir()
    t = np.arange(16000 * 3) / 16000.0
    for i in range(3):
        x = 0.3 * np.sin(2 * np.pi * (196 * 1.5 ** i) * t[: 16000 * (i + 1)])
        write_wav(str(root / "wavs" / f"clip{i}.wav"), x.astype(np.float32),
                  16000)
    return vocab


def _args(root, mode, ckpt, *extra):
    src = (["--wav", str(root / "wavs" / "clip1.wav")] if mode == "wav"
           else ["--wav-dir", str(root / "wavs")])
    return (["infer-music"] + src
            + ["--tokenizer-dir", str(root / "tok"), "--ckpt",
               str(root / ckpt), "--lm-ckpt", str(root / "lm"),
               "--lm-size", "tiny", "--max-tokens", "10", "--temperature",
               "0", "--slots", "2"] + list(extra))


@pytest.mark.parametrize("mode", ["wav", "wav-dir"])
def test_infer_music_matches_jax(files, mode, capsys, monkeypatch, tmp_path):
    root, _ = files
    monkeypatch.setenv("WHISPER_SIZE", "tiny")
    assert jax_cli.main(_args(root, mode, "shut")) == 0
    ref = capsys.readouterr().out
    out = tmp_path / "out.json"
    assert cli.main(_args(root, mode, "shut", "--device", "cpu",
                          "--out", str(out))) == 0
    assert capsys.readouterr().out == ref
    rec = json.loads(out.read_text())
    assert rec["mode"] == mode and rec["decode_steps"] > 0
    assert len(rec["requests"]) == (1 if mode == "wav" else 3)
    assert any(r["tokens"] for r in rec["requests"])


def _rebuilt(root, vocab):
    lm = load_pytree(str(root / "lm"))
    model = build_two_tower(
        TwoTowerConfig(whisper_size="tiny"), WhisperConfig.tiny(),
        CausalLMConfig(vocab_size=vocab, d_model=128, layers=4, heads=4,
                       kv_heads=2), vocab, torch.Generator().manual_seed(0),
        lm_params=lm, device="cpu")
    return load_trainable_checkpoint(str(root / "open"), model)


def test_infer_music_constrained_matches_library(files, monkeypatch,
                                                 tmp_path):
    root, vocab = files
    monkeypatch.setenv("WHISPER_SIZE", "tiny")
    model = _rebuilt(root, vocab)
    bpe = BPE.load(str(root / "tok"))
    allowed = bpe.added_token_ids()
    assert len(allowed) == 128 and len(bpe) == vocab
    start, end = bpe.vocab["<abc_start>"], bpe.vocab["<abc_end>"]
    prompt = "X:1\nK:D\n"
    out = tmp_path / "wav.json"
    assert cli.main(_args(root, "wav", "open", "--constrained", "--prompt",
                          prompt, "--device", "cpu", "--out",
                          str(out))) == 0
    fe = LogMelFrontend.whisper(80, device="cpu")
    x = torch.from_numpy(read_wav(str(root / "wavs" / "clip1.wav"))[0][:, 0])
    enc = model.encode_audio(fe(pad_or_trim(x, 160000)[None]))
    p_ids = bpe.encode(prompt)
    tok, _ = model.generate(model.params, enc, start_id=start, end_id=end,
                            max_len=10, temperature=0.0,
                            allowed_ids=allowed, prompt_ids=p_ids)
    rec = json.loads(out.read_text())["requests"][0]
    assert rec["all_tokens"] == tok[0].tolist()
    gen = rec["all_tokens"][1 + len(p_ids):]
    assert set(gen) <= set(allowed) | {end}

    out = tmp_path / "dir.json"
    assert cli.main(_args(root, "wav-dir", "open", "--constrained",
                          "--device", "cpu", "--out", str(out))) == 0
    g = ContinuousGenerator(model, bpe=bpe, start_id=start, end_id=end,
                            slots=2, max_new_tokens=9, temperature=0.0,
                            allowed_ids=allowed, device="cpu")
    for i in range(3):
        x = read_wav(str(root / "wavs" / f"clip{i}.wav"))[0][:, 0]
        g.submit(f"clip{i}.wav", x, seed=i)
    want = {r.request_id: r.tokens for r in g.run()}
    got = {r["id"]: r["tokens"] for r in json.loads(out.read_text())
           ["requests"]}
    assert got == want and any(want.values())


def test_cli_registry_and_mesh(files, capsys):
    root, _ = files
    assert cli.main(["--help"]) == 0
    assert capsys.readouterr().out.split() == ["audax_torch", "commands:"] \
        + sorted(["abc2wav", "data-quality", "finetune-proof", "genparquet",
                  "gentokens-bpe", "gentokens-raw", "infer-music",
                  "make-midi-dataset", "midi2abc", "midi2wav", "music-proof",
                  "train-lm", "train-music",
                  # the Whisper, classifier and weight I/O commands
                  "classifier-proof", "convert-hf", "detect-language",
                  "export-hf", "finetune", "preprocess", "sample", "serve",
                  "stream-serve", "test-cnn", "test-transformer",
                  "train-cnn", "train-transformer", "transcribe",
                  "verify-parity",
                  # the benches, memo2wav and the demo
                  "bench-continuous", "bench-rtf", "bench-speculative",
                  "bench-streaming", "bench-train", "demo", "memo2wav"])
    assert cli.main(["no-such-command"]) == 2
    assert "infer-music" in capsys.readouterr().err
    # a mesh serves --wav-dir (the continuous generator), not --wav
    for flag in (["--tp", "2"], ["--dp", "2"], ["--fsdp"]):
        with pytest.raises(SystemExit):
            cli.main(_args(root, "wav", "shut", "--device", "cpu", *flag))
    assert "qwen3-0.6b" in cli.LM_SIZES
    assert cli._lm_preset("qwen3-0.6b", 2048).vocab_size == 151936
    assert cli._lm_preset("tiny", 2048) == CausalLMConfig(
        vocab_size=2048, d_model=128, layers=4, heads=4, kv_heads=2)
