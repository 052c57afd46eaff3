"""The five ``bench-*`` commands of the port's command line against the
JAX package's, on the CPU.

Both packages' ``_load_whisper`` are monkeypatched to return one
JAX-initialised tiny Whisper (d 64, 1 + 2 layers, 30 s windows, the
published 51,865-token layout), bridged into the port as
``whisper_pair.py`` does; the draft preset of ``bench-speculative`` is the
same small shape. Each bench runs with the same argv in float32, with
``--no-fallback`` and short audio or few requests. Compared: the JSON key
sets (the port adds none); ``bench-rtf``'s FLOP count (the transcript's
token count enters it) and exit-code rule; ``bench-streaming``'s segments
(count and texts); ``bench-continuous``'s ``decode_steps``,
``slot_efficiency`` and per-request tokens for both schedules (greedy,
token-exact; the music engine at ``--lm-preset tiny`` for its schema only,
since t = 0.7 draws from each package's own generator);
``bench-speculative``'s ``tokens`` and ``greedy_agreement``;
``bench-train``'s analytic FLOPs (``whisper_train_step_flops``) and one
step's loss within 1e-4, also over a two-rank gloo mesh (``--dp 2``, with
and without ``--fsdp``) against JAX's command with the same flags. Times
are the CPU's and are not compared.
"""

import dataclasses
import json

import numpy as np
import pytest

from audax.cli import main as jax_cli
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax_torch.cli import main as cli
from audax_torch.core.config import WhisperConfig

from .mesh_world import run_world
from .whisper_pair import model as make_model
from .whisper_pair import tokenizers

TOL_LOSS = 1e-4
DIMS = dict(d_model=64, heads=2, encoder_layers=1, decoder_layers=2,
            n_audio_ctx=1500, n_text_ctx=64)


@pytest.fixture(scope="module")
def pair():
    jtok, tok = tokenizers()
    jcfg, jparams, _, cfg, params = make_model(seed=4, **DIMS)
    return {"jax": (jparams, jcfg, jtok), "torch": (params, cfg, tok)}


@pytest.fixture
def patched(pair, monkeypatch):
    """Both command lines load the pair's Whisper, and a draft preset of
    the same small shape; ``mfu`` records the FLOPs it is given."""
    from audax.utils import profiling as JP
    from audax_torch.utils import profiling as P
    import jax
    import jax.numpy as jnp
    jparams, jcfg, jtok = pair["jax"]
    # a copy each call: JAX's train step donates what it is given
    monkeypatch.setattr(jax_cli, "_load_whisper", lambda *a, **k: (
        jax.tree.map(jnp.copy, jparams), jcfg, jtok))
    monkeypatch.setattr(cli, "_load_whisper", lambda *a, **k: pair["torch"])
    small = {k: v for k, v in DIMS.items()} | {"decoder_layers": 1}
    monkeypatch.setattr(jax_cli, "_whisper_preset",
                        lambda size: JaxWhisperConfig(**small))
    monkeypatch.setattr(cli, "_whisper_preset",
                        lambda size: WhisperConfig(**small))
    flops = {"jax": [], "torch": []}
    for key, mod in (("jax", JP), ("torch", P)):
        real = mod.mfu

        def rec(f, sec, *a, _real=real, _key=key, **k):
            flops[_key].append(f)
            return _real(f, sec, *a, **k)
        monkeypatch.setattr(mod, "mfu", rec)
    return flops


def _run_both(argv, capsys):
    """(port rc, port JSON, JAX rc, JAX JSON) of one bench command."""
    rc = cli.main(argv + ["--device", "cpu"])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrc = jax_cli._COMMANDS[argv[0]](argv[1:])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs)
    return rc, ours, jrc, theirs


def test_bench_rtf(patched, capsys):
    argv = ["bench-rtf", "--dtype", "float32", "--seconds", "2", "--runs",
            "1", "--max-new-tokens", "6", "--batch-chunks", "1",
            "--no-fallback"]
    rc, ours, jrc, theirs = _run_both(argv, capsys)
    for code, rec in ((rc, ours), (jrc, theirs)):
        assert code == (0 if rec["value"] <= 0.05 else 1)
        assert rec["target"] == 0.05 and rec["fallback_ladder"] is False
    for k in ("metric", "size", "dtype", "seconds", "target"):
        assert ours[k] == theirs[k]
    # the FLOP rule counts the transcript's tokens: equal texts
    assert patched["torch"] == patched["jax"] and patched["torch"][0] > 0


def test_bench_streaming(patched, capsys, monkeypatch):
    from audax.infer import streaming as JS
    from audax_torch.infer import streaming as S
    segs = {}
    for key, mod in (("jax", JS), ("torch", S)):
        real = mod.StreamingTranscriber.drain

        def rec(self, _real=real, _key=key):
            out = _real(self)
            segs.setdefault(_key, []).append(
                sorted((s.stream_id, s.index, s.text) for s in out))
            return out
        monkeypatch.setattr(mod.StreamingTranscriber, "drain", rec)
    argv = ["bench-streaming", "--dtype", "float32", "--streams", "3",
            "--windows", "1", "--batch-slots", "2", "--max-new-tokens", "6"]
    rc, ours, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == 0
    for k in ("metric", "streams", "batch_slots", "audio_seconds"):
        assert ours[k] == theirs[k]
    assert len(segs["torch"]) == len(segs["jax"]) == 2   # warm-up, timed
    assert segs["torch"] == segs["jax"]
    assert len(segs["torch"][1]) == 3


def test_bench_continuous_asr(patched, capsys, monkeypatch):
    from audax.infer import continuous as JC
    from audax_torch.infer import continuous as C
    runs = {}
    for key, mod in (("jax", JC), ("torch", C)):
        real = mod.ContinuousBatcher.run

        def rec(self, _real=real, _key=key):
            out = _real(self)
            got = {r.request_id: [int(t) for t in r.tokens] for r in out
                   if not r.request_id.startswith("__warmup")}
            if got:                      # the warm-ups are each engine's own
                runs.setdefault(_key, []).append(got)
            return out
        monkeypatch.setattr(mod.ContinuousBatcher, "run", rec)
    argv = ["bench-continuous", "--engine", "asr", "--dtype", "float32",
            "--requests", "5", "--slots", "2", "--max-new-tokens", "8",
            "--min-new-tokens", "2", "--steps-per-sync", "4"]
    rc, ours, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == 0
    for name in ("continuous", "convoy"):
        for k in ("decode_steps", "slot_efficiency"):
            assert ours[name][k] == theirs[name][k], (name, k)
    assert ours["continuous"]["decode_steps"] <= \
        ours["convoy"]["decode_steps"]
    for k in ("metric", "engine", "slots", "requests", "budget_range",
              "dtype"):
        assert ours[k] == theirs[k]
    # continuous, then three convoy batches: each request's tokens
    assert runs["torch"] == runs["jax"] and len(runs["torch"]) == 4


def test_bench_continuous_music_schema(patched, capsys):
    argv = ["bench-continuous", "--engine", "music", "--lm-preset", "tiny",
            "--size", "tiny", "--dtype", "float32", "--requests", "3",
            "--slots", "2", "--max-new-tokens", "6", "--min-new-tokens",
            "2", "--steps-per-sync", "4", "--window-seconds", "2"]
    rc, ours, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == 0
    assert set(ours["continuous"]) == set(theirs["continuous"])
    assert ours["engine"] == "music" and ours["requests"] == 3
    assert ours["budget_range"] == theirs["budget_range"]


def test_bench_speculative(patched, capsys):
    argv = ["bench-speculative", "--dtype", "float32", "--max-new-tokens",
            "8", "--spec-tokens", "3"]
    rc, ours, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == 0
    assert ours["tokens"] == theirs["tokens"] > 0
    assert ours["greedy_agreement"] == theirs["greedy_agreement"] == 1.0
    for k in ("metric", "spec_tokens", "draft", "dtype"):
        assert ours[k] == theirs[k]


TRAIN_ARGV = ["bench-train", "--batch-size", "2", "--steps", "1",
              "--label-len", "8", "--remat", "dots"]
#: bench-train over a two-rank mesh: the flags of each run
MESH_RUNS = {"dp2": ["--dp", "2"], "dp2_fsdp": ["--dp", "2", "--fsdp"]}


def _record_jax_losses(monkeypatch, losses):
    """JAX's bench-train appends each step's loss to ``losses`` (its step
    is AOT-compiled: the compiled call is wrapped)."""
    from audax.train import seq2seq as JS
    jreal = JS.make_finetune_step

    def jax_step(*a, **k):
        jitted = jreal(*a, **k)

        class Lowered:
            def __init__(self, low):
                self.low = low

            def compile(self):
                compiled = self.low.compile()

                def call(state, batch):
                    state, m = compiled(state, batch)
                    losses.append(float(m["loss"]))
                    return state, m
                call.cost_analysis = compiled.cost_analysis
                return call

        class Step:
            def lower(self, *aa):
                return Lowered(jitted.lower(*aa))
        return Step()
    monkeypatch.setattr(JS, "make_finetune_step", jax_step)


def test_bench_train(patched, capsys, monkeypatch):
    from audax_torch.train import seq2seq as S
    from audax_torch.utils import profiling as P
    losses = {"jax": [], "torch": []}
    counted = []
    real_count = P.step_flops

    def count(*a, **k):
        counted.append(real_count(*a, **k))
        return counted[-1]
    # the counted FLOPs themselves: the printed rate is rounded to 0.01
    # TFLOP/s, which a slow CPU step rounds to 0
    monkeypatch.setattr(P, "step_flops", count)
    real = S.make_finetune_step

    def port_step(*a, **k):
        step = real(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            losses["torch"].append(float(m["loss"]))
            return state, m
        return run
    monkeypatch.setattr(S, "make_finetune_step", port_step)
    _record_jax_losses(monkeypatch, losses["jax"])
    rc, ours, jrc, theirs = _run_both(TRAIN_ARGV, capsys)
    assert rc == jrc == 0
    for k in ("metric", "size", "lora_rank", "batch_size", "dtype", "mesh",
              "fsdp"):
        assert ours[k] == theirs[k]
    # the analytic model FLOPs of one step
    assert patched["torch"] == patched["jax"] and patched["torch"][0] > 0
    # one step's loss (LoRA adds zero at its init, so both agree then too)
    np.testing.assert_allclose(losses["torch"][0], losses["jax"][0],
                               rtol=TOL_LOSS)
    assert len(counted) == 1 and counted[0] > 0
    rate = ours["xla_counted_tflops"]
    assert isinstance(rate, float) and np.isfinite(rate) and rate >= 0


@pytest.fixture(scope="module")
def train_world(pair, tmp_path_factory):
    """The port's bench-train of each ``MESH_RUNS`` entry over a two-rank
    gloo world (``mesh_cases.bench_train_world``), by rank."""
    params, cfg, tok = pair["torch"]
    runs = {k: TRAIN_ARGV + v + ["--device", "cpu"]
            for k, v in MESH_RUNS.items()}
    return run_world(2, "tests.torch_port.mesh_cases:bench_train_world",
                     dict(params=params, cfg=cfg, tok=tok, runs=runs),
                     tmp_path_factory.mktemp("bench_train"))


@pytest.mark.parametrize("run", sorted(MESH_RUNS))
def test_bench_train_mesh(patched, capsys, monkeypatch, train_world, run):
    """``bench-train --dp 2 [--fsdp]`` over two ranks: each rank exits 0
    and prints JAX's keys, with the "mesh" and "fsdp" JAX prints for the
    same flags (over two of its virtual CPU devices) and JAX's analytic
    FLOPs divided by the mesh size; the first step's loss (each rank's
    rows summed over both) is JAX's single-device run's."""
    losses = []
    _record_jax_losses(monkeypatch, losses)
    assert jax_cli._COMMANDS["bench-train"](TRAIN_ARGV[1:]) == 0
    assert jax_cli._COMMANDS["bench-train"](TRAIN_ARGV[1:]
                                            + MESH_RUNS[run]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert theirs["mesh"] == {"data": 2, "model": 1}
    assert theirs["fsdp"] == ("--fsdp" in MESH_RUNS[run])
    single, meshed = patched["jax"]
    assert meshed == single / 2
    for out in train_world:
        got = out[run]
        ours = got["json"]
        assert got["rc"] == 0 and set(ours) == set(theirs)
        for k in ("metric", "size", "lora_rank", "batch_size", "dtype",
                  "mesh", "fsdp"):
            assert ours[k] == theirs[k], k
        assert got["flops"] == [meshed]
        np.testing.assert_allclose(got["losses"][0], losses[0],
                                   rtol=TOL_LOSS)
        np.testing.assert_allclose(got["losses"][0], losses[1],
                                   rtol=TOL_LOSS)


def test_benches_default_to_the_card(monkeypatch):
    """Without ``--device`` a bench resolves the CUDA card, and raises on
    a host without one rather than running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench-rtf", "--size", "tiny"])
