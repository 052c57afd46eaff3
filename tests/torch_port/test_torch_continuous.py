"""Port ``ContinuousBatcher`` vs the JAX package's, on the CPU.

The same JAX-initialised Whisper (d_model 64, 2 heads, 1+2 layers, the
51,865-token vocabulary, a 1 s window) serves the same requests in both
packages: five requests through two slots, so slots are refilled
mid-flight while their neighbours decode. Results must be token-exact, with
equal text and avg_logprob to 1e-4, for float weights, int4 weights with
int8 KV, and int8 weights; and with per-request ``max_new_tokens`` and
``lang``, with ``suppress_blank``, and after ``warmup`` (the full admit,
and ``all_buckets=False``'s one dummy request, as JAX's). A request
cancelled before admission never runs. ``Transcriber(quantize="int4",
kv_quant=True)`` is token-exact against the JAX ``Transcriber`` too.
"""

import numpy as np
import pytest
import torch

from audax.infer.continuous import ContinuousBatcher as JaxBatcher
from audax.infer.transcribe import Transcriber as JaxTranscriber
from audax.models.quantize import quantize_tree as jax_quantize_tree
from audax_torch.infer.continuous import ContinuousBatcher
from audax_torch.infer.transcribe import Transcriber
from audax_torch.models.quantize import quantize_tree
from audax_torch.ops import launch_counts, reset_launches

from .whisper_pair import model as make_model
from .whisper_pair import tokenizers


@pytest.fixture(scope="module")
def setup():
    jtok, tok = tokenizers()
    return (jtok, tok) + make_model(d_model=64, heads=2, encoder_layers=1,
                                    decoder_layers=2, n_audio_ctx=50,
                                    n_text_ctx=32, seed=3)


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000.0
    return {f"r{i}": (0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t)
                      + 0.05 * rng.standard_normal(t.size)
                      ).astype(np.float32)[: 8000 + 2000 * i]
            for i in range(5)}


SCENARIOS = {
    "float": dict(bits=None, kv_quant=False),
    "int4-int8kv": dict(bits=4, kv_quant=True),
    "int8": dict(bits=8, kv_quant=False),
    "budgets-lang": dict(bits=None, kv_quant=False,
                         budgets={"r0": 2, "r2": 4}, langs={"r1": "de"}),
    "suppress_blank": dict(bits=None, kv_quant=False,
                           engine=dict(suppress_blank=True)),
    "warmup": dict(bits=4, kv_quant=True, warmup={}),
    "warmup-one-bucket": dict(bits=None, kv_quant=False,
                              warmup={"all_buckets": False}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_continuous_matches_jax(setup, name):
    sc = SCENARIOS[name]
    jtok, tok, jcfg, jparams, _, cfg, params = setup
    if sc["bits"]:
        jparams = jax_quantize_tree(jparams, bits=sc["bits"])
        params = quantize_tree(params, bits=sc["bits"])
    kw = dict(slots=2, window_seconds=1.0, max_new_tokens=6,
              steps_per_sync=4, kv_quant=sc["kv_quant"],
              **sc.get("engine", {}))
    jcb = JaxBatcher(jparams, jcfg, jtok, **kw)
    cb = ContinuousBatcher(params, cfg, tok, device="cpu", **kw)
    if sc.get("warmup") is not None:
        served = {}
        for key, engine in (("jax", jcb), ("torch", cb)):
            run = engine.run

            def counted(_run=run, _key=key):
                out = _run()
                served.setdefault(_key, []).extend(r.request_id for r in out)
                return out
            engine.run = counted
            engine.warmup(**sc["warmup"])
            del engine.run
        assert cb.steps_run == cb.chunks_run == 0 and cb.live() == 0
        assert jcb.steps_run == jcb.chunks_run == 0
        # the port's full admit is ``slots`` dummies; one bucket is one
        # dummy in both packages
        one = sc["warmup"].get("all_buckets") is False
        assert len(served["torch"]) == (1 if one else kw["slots"])
        if one:
            assert len(served["jax"]) == 1
    reqs = _requests()
    budgets, langs = sc.get("budgets", {}), sc.get("langs", {})
    for engine in (jcb, cb):
        for rid, x in reqs.items():
            extra = {"lang": langs[rid]} if rid in langs else {}
            engine.submit(rid, x, max_new_tokens=budgets.get(rid), **extra)
        engine.submit("dropped", reqs["r0"])
        assert engine.pending() == 6
        assert engine.cancel("dropped") and not engine.cancel("dropped")
    reset_launches()
    ref = {r.request_id: r for r in jcb.run()}
    ours = {r.request_id: r for r in cb.run()}
    assert set(ours) == set(ref) == set(reqs)
    assert cb.chunks_run >= 2 and cb.live() == cb.pending() == 0
    for rid, r in ref.items():
        assert ours[rid].tokens == r.tokens, rid
        assert ours[rid].text == r.text
        assert ours[rid].audio_seconds == r.audio_seconds == \
            len(reqs[rid]) / 16000
        assert ours[rid].avg_logprob == pytest.approx(r.avg_logprob,
                                                      abs=1e-4)
        if rid in budgets:
            assert len(ours[rid].tokens) <= budgets[rid]
    assert any(r.tokens for r in ours.values())
    counts = launch_counts()
    assert all(c["cuda"] == 0 for c in counts.values())   # the CPU path
    int8 = counts["decode_attention_stacked_int8"]["plain"]
    assert (int8 > 0) == sc["kv_quant"]
    assert (counts["int4_matmul"]["plain"] > 0) == (sc["bits"] == 4)


def test_engine_device_and_mesh(setup, mesh_of_one):
    """``mesh=`` serves (one rank: the engine without a mesh, token for
    token; ``test_torch_tp.py`` and the dry run hold more ranks)."""
    jtok, tok, jcfg, jparams, _, cfg, params = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousBatcher(params, cfg, tok, window_seconds=1.0)
    served = []
    for mesh in (None, mesh_of_one):
        cb = ContinuousBatcher(params, cfg, tok, window_seconds=1.0,
                               slots=2, max_new_tokens=4, mesh=mesh,
                               device="cpu")
        for rid, x in list(_requests().items())[:3]:
            cb.submit(rid, x)
        served.append({r.request_id: r.tokens for r in cb.run()})
    assert served[0] == served[1] and len(served[0]) == 3
    with pytest.raises(ValueError, match="n_audio_ctx"):
        ContinuousBatcher(params, cfg, tok, window_seconds=2.0, device="cpu")


def test_transcriber_int4_kv_quant_matches_jax(setup):
    jtok, tok, jcfg, jparams, _, cfg, params = setup
    kw = dict(max_new_tokens=8, temperature_fallback=False)
    jtr = JaxTranscriber(jparams, jcfg, jtok, backend="xla", quantize="int4",
                         kv_quant=True, **kw)
    tr = Transcriber(params, cfg, tok, device="cpu", quantize="int4",
                     kv_quant=True, **kw)
    assert "kernel_q4" in tr.params["decoder"]["layers"]["attn"]["q"]
    audio = _requests(1)["r4"]                  # one full 1 s window
    ref, ours = jtr.transcribe(audio), tr.transcribe(audio)
    assert ours.text == ref.text
    chunks = np.stack([audio, np.pad(_requests(2)["r3"], (0, 2000))])
    ref_res, _ = jtr._decode_chunk_batch(chunks)
    ours_res = tr._decode_chunk_batch(chunks)
    assert [r[0] for r in ours_res] == [r[0] for r in ref_res]
    assert any(r[0] for r in ours_res)
    with pytest.raises(ValueError, match="quantize"):
        Transcriber(params, cfg, tok, device="cpu", quantize="int3")
