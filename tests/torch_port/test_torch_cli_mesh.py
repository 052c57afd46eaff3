"""The mesh on the port's product surfaces vs the JAX package, on the CPU
(the port's counterpart of ``tests/test_cli_mesh.py``).

One four-rank gloo world runs, on every rank as ``torchrun`` would:
``infer-music --wav-dir --dp 2 --tp 2`` over four slots on the files of
``test_torch_cli_music.py`` (the text JAX's single-device command prints);
``finetune --dp 2 --tp 2`` and ``finetune --dp 4 --fsdp --lora-rank 2``
through ``cli.main`` on the same JAX checkpoint, tokenizer and WAVs as the
JAX command line's single-device ``finetune`` (with ``--lora-rank 2``
for the second, both starting from the JAX draw of the adapters' A);
``fit_lm`` over a (2, 2)
mesh with and without FSDP from the JAX draw; data-parallel
``fit_classifier`` (a CNN with BatchNorm, batches of 15 padded to 16 by
repeating row 0, as JAX's ``shard_batch`` pads) from the JAX init; and the
``serve`` construction (``shard_params`` + ``ContinuousBatcher(mesh=)``
behind the HTTP server, the other ranks in lockstep) answering one
request. Bounds are the JAX tests': losses rtol 1e-3 (atol 1e-5), the
saved checkpoints within 5e-3, the classifier's losses within 1e-4, the
served text exact. The ranks' world-size check runs here too: a mesh
larger than the world raises before any rank waits.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

from audax.cli import main as jax_cli
from audax.cli.http_server import serve_http as jax_serve_http
from audax.core.config import ClassifierTrainConfig as JaxTrainConfig
from audax.core.config import MeshConfig as JaxMeshConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.continuous import ContinuousBatcher as JaxBatcher
from audax.models import causal_lm as JLM
from audax.models.lora import init_lora as jax_init_lora
from audax.models.whisper import init_whisper_params as jax_init_whisper
from audax.parallel.mesh import make_mesh as jmake_mesh
from audax.symbolic.bpe import train_bpe as jax_train_bpe
from audax.symbolic.tokenizer import WhisperTokenizer as JaxTokenizer
from audax.train.checkpoints import load_pytree as jax_load_pytree
from audax.train.checkpoints import save_pytree as jax_save_pytree
from audax.train.lm import LMTrainConfig as JaxLMTrainConfig
from audax.train.lm import fit_lm as jax_fit_lm
from audax.train.loops import fit_classifier as jax_fit_classifier
from audax_torch.cli import main as cli
from audax_torch.core.config import ClassifierTrainConfig, WhisperConfig
from audax_torch.data.audio_io import write_wav
from audax_torch.models.bridge import (causal_lm_from_numpy,
                                       classifier_from_numpy,
                                       params_from_numpy)
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.symbolic.bpe import train_bpe
from audax_torch.symbolic.tokenizer import WhisperTokenizer
from audax_torch.train.checkpoints import load_pytree
from audax_torch.train.lm import LMTrainConfig

from .mesh_world import run_world
from .music_pair import CHUNK_S, build_pair, music_dataset
from .test_torch_classifiers import _data, _init, _pair
from .test_torch_cli_music import _args as _music_args
from .test_torch_cli_music import write_music_files

SR = 16000
TINY = dict(n_mels=80, n_audio_ctx=100, d_model=32, encoder_layers=1,
            decoder_layers=1, heads=2, vocab_size=300, n_text_ctx=32)
FT_ENV = dict(LEARNING_RATE="1e-3", WARMUP_STEPS="1", EVAL_EVERY="100",
              LOSS_FETCH_EVERY="1")
LM = dict(vocab_size=96, d_model=32, layers=2, heads=4, kv_heads=2,
          ffn_dim=64)
LM_TRAIN = dict(max_steps=3, batch_size=4, seq_len=16, eval_every=1,
                eval_windows=2, warmup_steps=0)
#: fit_two_tower's keyword arguments, and train-music's environment
TT_KW = dict(chunk_seconds=CHUNK_S, val_fraction=0.25)
MT_ENV = {"WHISPER_SIZE": "tiny", "MAX_TARGET_TOKENS": "48"}


def _losses(run_dir, name="whisper_ft", key="loss"):
    rows = []
    with open(os.path.join(run_dir,
                           f"artifacts/runs/{name}.metrics.jsonl")) as fh:
        for line in fh:
            r = json.loads(line)
            if key in r:
                rows.append(r[key])
    return rows


def _music_train_files(root):
    """The port's data tools over six MIDI items (as
    ``test_torch_cli_music_train.py`` runs them), and ``train-music``'s
    arguments over their Parquet and BPE."""
    root.mkdir()
    old = os.getcwd()
    os.chdir(root)
    try:
        for argv in (["make-midi-dataset", "--num-items", "6", "--out-dir",
                      "gen"],
                     ["midi2wav", "--midi-dir", "gen", "--out-dir", "wav",
                      "--chunk-seconds", "2", "--workers", "1"],
                     ["midi2abc", "--midi-dir", "wav", "--out-dir", "abc",
                      "--workers", "1"],
                     ["gentokens-bpe", "--abc-dir", "abc", "--out-dir",
                      "bpe", "--vocab-size", "200"],
                     ["genparquet", "--wav-dir", "wav", "--abc-dir", "abc",
                      "--out", "music.parquet"]):
            assert cli.main(argv) == 0
    finally:
        os.chdir(old)
    return {"argv": ["train-music", "--parquet", str(root / "music.parquet"),
                     "--tokenizer-dir", str(root / "bpe"), "--epochs", "2",
                     "--batch-size", "2", "--chunk-seconds", "1",
                     "--lm-size", "tiny", "--device", "cpu"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    rng = np.random.default_rng(0)
    # the finetune inputs: tokenizer, a JAX checkpoint, 8 two-second WAVs
    bpe = jax_train_bpe(["hello world how are you"] * 3, vocab_size=300)
    bpe.save(str(root / "tok"))
    jcfg = JaxWhisperConfig(**{**TINY,
                               "vocab_size": JaxTokenizer(bpe).vocab_size})
    ckpt = str(root / "w2s")
    jparams = jax_init_whisper(jcfg, jax.random.key(0))
    jax_save_pytree(ckpt, jparams)
    # JAX's finetune draws the adapters from key(seed 0): the same A here
    lora_draw = {k: np.asarray(ab["a"]) for k, ab in jax_init_lora(
        jparams, 2, targets=("attn/q", "attn/v"),
        rng=jax.random.key(0)).items()}
    with open(ckpt + ".config.json", "w") as fh:
        json.dump(dataclasses.asdict(jcfg), fh)
    wavs = root / "wavs"
    wavs.mkdir()
    for i in range(8):
        write_wav(str(wavs / f"c{i}.wav"), 0.05 * rng.standard_normal(
            2 * SR).astype(np.float32), SR)
    common = ["--audio-dir", str(wavs), "--transcript", "hello world",
              "--ckpt", ckpt, "--tokenizer-dir", str(root / "tok"),
              "--steps", "3", "--batch-size", "4", "--chunk-seconds", "2",
              "--device", "cpu"]
    runs = [(["finetune"] + common + ["--lora-rank", "0", "--out",
                                      str(root / "out_tp"), "--dp", "2",
                                      "--tp", "2"], str(root / "run_tp")),
            (["finetune"] + common + ["--lora-rank", "2", "--out",
                                      str(root / "out_fsdp"), "--dp", "4",
                                      "--fsdp"], str(root / "run_fsdp")),
            (["finetune"] + common + ["--lora-rank", "0", "--out",
                                      str(root / "out_sp"), "--dp", "2",
                                      "--sp", "2", "--accum-steps", "2"],
             str(root / "run_sp"))]
    # train-music over (data 2, model 2) with FSDP, on the port's own data
    # tools' files; its single-device twin runs in the parent
    music_train = _music_train_files(root / "music_train")
    runs.append((music_train["argv"] + ["--dp", "2", "--tp", "2", "--fsdp",
                                        "--ckpt-dir", str(root / "mt_ck")],
                 str(root / "run_mt"), MT_ENV))
    # fit_lm and fit_classifier from the JAX draws
    jlm = JLM.init_causal_lm(JLM.CausalLMConfig(**LM), jax.random.key(0))
    lm_params = causal_lm_from_numpy(jax.tree.map(np.asarray, jlm),
                                     CausalLMConfig(**LM), device="cpu")
    corpus = np.arange(4000, dtype=np.int32) % 96
    jm, pm, shape = _pair("cnn", dropout=0.0)
    train, ev = _data(rng, 45, shape), _data(rng, 21, shape)
    jtc = JaxTrainConfig(batch_size=15, epochs=2, learning_rate=1e-3,
                         weight_decay=1e-4, seed=0)
    variables = _init(jm, train["x"][:15], seed=jtc.seed)
    classifier_from_numpy(variables, pm)
    tt_data = music_dataset(n=8, seed=3)
    jtt, ptt = build_pair(len(tt_data.tokenizer), seed=1)
    fit = dict(lm_params=lm_params, lm_cfg=CausalLMConfig(**LM),
               train_cfg=LMTrainConfig(**LM_TRAIN), corpus=corpus,
               model_cls=pm, data=train, eval_data=ev,
               cls_cfg=ClassifierTrainConfig(**jtc.asdict()),
               two_tower=(ptt, tt_data, TT_KW))
    # the server: a 1 s window Whisper, one request
    stok = jax_train_bpe(["hello world"] * 3, vocab_size=280)
    scfg = JaxWhisperConfig(n_mels=80, n_audio_ctx=50, d_model=32,
                            encoder_layers=1, decoder_layers=1, heads=2,
                            vocab_size=JaxTokenizer(stok).vocab_size,
                            n_text_ctx=32)
    sparams = jax_init_whisper(scfg, jax.random.key(0))
    wav = root / "clip.wav"
    write_wav(str(wav), 0.01 * rng.standard_normal(SR).astype(np.float32),
              SR)
    tok = WhisperTokenizer(train_bpe(["hello world"] * 3, vocab_size=280))
    serve = dict(params=params_from_numpy(
        jax.tree.map(np.asarray, sparams), WhisperConfig(**scfg.asdict()),
        device="cpu"), cfg=WhisperConfig(**scfg.asdict()), tok=tok,
        wav_bytes=wav.read_bytes(), port_file=str(root / "port"))
    # infer-music over the mesh: the adapter's gates shut, as in the
    # single-device parity test (each package draws its own audio tower)
    mroot = root / "music"
    mroot.mkdir()
    write_music_files(mroot)
    music = (_music_args(mroot, "wav-dir", "shut", "--slots", "4",
                         "--device", "cpu", "--dp", "2", "--tp", "2",
                         "--out", str(root / "music.json")),
             str(root / "run_music"), {"WHISPER_SIZE": "tiny"})
    outs = run_world(4, "tests.torch_port.mesh_cases:cli_world", dict(
        music=music, runs=runs, tiny_cfg=WhisperConfig(**TINY), env=FT_ENV,
        lora_draw=lora_draw, fit=fit, serve=serve), root / "world",
        timeout=400)
    return dict(outs=outs, root=root, common=common, jcfg=jcfg, jlm=jlm,
                corpus=corpus, jm=jm, train=train, ev=ev, jtc=jtc,
                variables=variables, serve=(sparams, scfg, stok, wav),
                mroot=mroot, lora_draw=lora_draw, tt=(jtt, tt_data),
                music_train=music_train)


def _jax_finetune(world, run, lora_rank):
    """JAX's single-device ``finetune`` on the same inputs: (losses, the
    saved checkpoint)."""
    from audax.train import seq2seq as jax_seq2seq

    drawn = {}
    orig = jax_seq2seq.init_lora

    def init_lora(*a, **kw):
        lora = orig(*a, **kw)            # the step donates it: keep a copy
        drawn.update({k: np.asarray(ab["a"]) for k, ab in lora.items()})
        return lora

    with pytest.MonkeyPatch.context() as mp:
        for k, v in FT_ENV.items():
            mp.setenv(k, v)
        mp.setattr(JaxWhisperConfig, "tiny",
                   classmethod(lambda cls: JaxWhisperConfig(**TINY)))
        mp.setattr(jax_seq2seq, "init_lora", init_lora)
        mp.chdir(run)
        args = [a for a in world["common"] if a not in ("--device", "cpu")]
        assert jax_cli._COMMANDS["finetune"](
            args + ["--lora-rank", str(lora_rank), "--out",
                    str(run / "out")]) == 0
    # the adapters the children were given are the ones JAX drew
    assert set(drawn) == set(world["lora_draw"]) if lora_rank else not drawn
    for k, a in drawn.items():
        np.testing.assert_array_equal(a, world["lora_draw"][k])
    return _losses(str(run)), str(run / "out")


@pytest.fixture(scope="module")
def jax_finetune(world, tmp_path_factory):
    return _jax_finetune(world, tmp_path_factory.mktemp("jax_ft"), 0)


@pytest.fixture(scope="module")
def jax_finetune_lora(world, tmp_path_factory):
    return _jax_finetune(world, tmp_path_factory.mktemp("jax_ft_lora"), 2)


def _same_checkpoint(world, ref_ckpt, ours_dir):
    """The port's saved (whole) checkpoint is JAX's, within 5e-3."""
    cfg = WhisperConfig(**dataclasses.asdict(world["jcfg"]))
    theirs = params_from_numpy(jax.tree.map(np.asarray,
                                            jax_load_pytree(ref_ckpt)),
                               cfg, device="cpu")
    mine = load_pytree(ours_dir)

    def walk(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k])
        else:
            assert float((a.float() - b).abs().max()) < 5e-3

    walk(mine, theirs)


def test_commands_exit_zero(world):
    for out in world["outs"]:
        assert out["codes"] == [0, 0, 0, 0, 0]


def test_infer_music_mesh_matches_jax(world, capsys, monkeypatch):
    """``infer-music --wav-dir`` over a (2, 2) mesh, two of the four slots
    a rank and the LM cut over 'model': rank 0's record prints JAX's
    single-device text, request for request."""
    monkeypatch.setenv("WHISPER_SIZE", "tiny")
    assert jax_cli.main(_music_args(world["mroot"], "wav-dir", "shut",
                                    "--slots", "4")) == 0
    ref = capsys.readouterr().out
    rec = json.loads((world["root"] / "music.json").read_text())
    assert rec["mode"] == "wav-dir" and len(rec["requests"]) == 3
    assert any(r["tokens"] for r in rec["requests"])
    assert "".join(f"== {r['id']} (avg_logprob {r['avg_logprob']:.3f})\n"
                   f"{r['text']}\n" for r in rec["requests"]) == ref


def test_finetune_dp_tp_matches_jax(world, jax_finetune):
    ref, ref_ckpt = jax_finetune
    ours = _losses(str(world["root"] / "run_tp"))
    assert len(ours) == len(ref) == 3
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-5)
    _same_checkpoint(world, ref_ckpt, str(world["root"] / "out_tp"))


def test_finetune_fsdp_lora_trains(world, jax_finetune_lora):
    """``--dp 4 --fsdp --lora-rank 2`` against JAX's single-device
    ``--lora-rank 2`` from the same adapters: the losses and the saved
    (merged) checkpoint, at the DP x TP case's bounds."""
    ref, ref_ckpt = jax_finetune_lora
    ours = _losses(str(world["root"] / "run_fsdp"))
    assert len(ours) == len(ref) == 3
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-5)
    _same_checkpoint(world, ref_ckpt, str(world["root"] / "out_fsdp"))


@pytest.mark.parametrize("fsdp", [0, 1], ids=["tp", "tp_fsdp"])
def test_fit_lm_mesh_matches_jax(world, fsdp):
    _, ref = jax_fit_lm(world["jlm"], JLM.CausalLMConfig(**LM),
                        JaxLMTrainConfig(**LM_TRAIN), world["corpus"])
    for out in world["outs"]:
        hist = out["fit"][f"lm_fsdp{fsdp}"]
        assert len(hist) == len(ref)
        for a, b in zip(hist, ref):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3)
            np.testing.assert_allclose(a["eval_loss"], b["eval_loss"],
                                       rtol=1e-3)


def test_fit_classifier_data_parallel_matches_jax(world):
    """Data 4 over batches of 15: padded by row 0 on both sides; the
    synchronised BatchNorm sees the whole batch as JAX's does."""
    jm = world["jm"]
    mesh = jmake_mesh(JaxMeshConfig(), devices=jax.devices()[:4])
    _, jhist = jax_fit_classifier(jm, world["train"], world["ev"],
                                  world["jtc"], num_classes=4, mesh=mesh)
    for out in world["outs"]:
        ours = out["fit"]["cls"]
        np.testing.assert_allclose(ours["train_loss"], jhist["train_loss"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours["eval_loss"],
                                   [e["loss"] for e in jhist["eval"]],
                                   atol=1e-4)
        assert ours["eval_acc"] == [e["accuracy"] for e in jhist["eval"]]


def test_serve_tp_matches_jax(world):
    sparams, scfg, stok, wav = world["serve"]
    tok = JaxTokenizer(stok)
    srv = jax_serve_http(JaxBatcher(sparams, scfg, tok, slots=2,
                                    window_seconds=1.0, max_new_tokens=5,
                                    steps_per_sync=4), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}"
            "/v1/audio/transcriptions?max_tokens=5", data=wav.read_bytes(),
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            ref = json.load(r)["text"]
    finally:
        srv.scheduler.shutdown()
        srv.shutdown()
    assert world["outs"][0]["serve"] == ref


def test_mesh_larger_than_the_world_raises():
    for flags in (["--dp", "2"], ["--tp", "2"], ["--dp", "2", "--tp", "2"]):
        with pytest.raises(ValueError, match="devices, only 1 present"):
            cli.main(["train-lm", "--corpus", "x", "--tokenizer-dir", "t",
                      "--device", "cpu"] + flags)


def test_finetune_sp_accum_matches_jax(world, jax_finetune):
    """``finetune --dp 2 --sp 2 --accum-steps 2``: the ring over the mel
    frames, the microbatches outside it, against JAX's single-device
    ``finetune`` (``tests/test_cli_mesh.py``'s bounds)."""
    ref, ref_ckpt = jax_finetune
    ours = _losses(str(world["root"] / "run_sp"))
    assert len(ours) == len(ref) == 3
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-5)
    _same_checkpoint(world, ref_ckpt, str(world["root"] / "out_sp"))


def test_finetune_sp_flag_validation():
    """``--sp`` composes with ``--dp`` only, and an infeasible ``--dp x
    --sp`` stops at argparse time (``tests/test_cli_mesh.py:362-380``)."""
    for bad in (["--sp", "2", "--tp", "2"], ["--sp", "2", "--fsdp"],
                ["--dp", "8", "--sp", "8"]):
        with pytest.raises(SystemExit):
            cli.main(["finetune", "--audio-dir", "/nonexistent",
                      "--device", "cpu"] + bad)


@pytest.mark.parametrize("fsdp", [0, 1], ids=["tp", "tp_fsdp"])
def test_fit_two_tower_mesh_matches_jax(world, fsdp):
    """``fit_two_tower`` over (data 2, model 2), with and without FSDP:
    the loss history of JAX's single-device loop from the same weights
    (``tests/test_cli_mesh.py``'s rtol 1e-3), on every rank."""
    from audax.train import two_tower_loop as JLoop
    jm, data = world["tt"]
    jm = jm._replace(params=jax.tree.map(jax.numpy.copy, jm.params))
    _, ref = JLoop.fit_two_tower(jm, data, **TT_KW)
    for out in world["outs"]:
        got = out["fit"][f"two_tower_fsdp{fsdp}"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], ref[key],
                                       rtol=1e-3, err_msg=key)
        assert got["step"] == 2
    np.testing.assert_array_equal(
        world["outs"][1]["fit"][f"two_tower_fsdp{fsdp}"]["adapter_q"],
        world["outs"][0]["fit"][f"two_tower_fsdp{fsdp}"]["adapter_q"])


def test_train_music_mesh_matches_one_device(world, tmp_path, monkeypatch):
    """``train-music --dp 2 --tp 2 --fsdp`` against the same command in
    one process (the port draws the same weights from the seed; JAX's
    own draw differs, so ``test_torch_cli_music_train.py`` holds the
    command against JAX on its report and files): the per-epoch losses
    and the checkpoint directories."""
    for k, v in MT_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(WhisperConfig, "tiny",
                        classmethod(lambda cls: WhisperConfig(**TINY)))
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    assert cli.main(world["music_train"]["argv"]
                    + ["--ckpt-dir", str(ck)]) == 0
    for key in ("train_loss", "val_loss"):
        ref = _losses(str(tmp_path), "two_tower", key)
        ours = _losses(str(world["root"] / "run_mt"), "two_tower", key)
        assert len(ours) == len(ref) == 2
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    assert sorted(os.listdir(world["root"] / "mt_ck")) == sorted(
        os.listdir(ck))
