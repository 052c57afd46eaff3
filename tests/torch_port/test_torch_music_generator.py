"""Port ``ContinuousGenerator`` (the two-tower's slot-refill engine) vs the
JAX package's, on the CPU.

The model of ``test_torch_two_tower.py`` (JAX-built, gates opened, bridged)
serves five clips of a 1 s window through two slots, so slots are refilled
while their neighbours decode: at temperature 0 every request's tokens
equal JAX's, with the same avg_logprob to 1e-4, with and without the
allowed-id mask and with per-request ``max_new_tokens``. Sampling at a
temperature is reproducible per request: a request's tokens depend on its
``seed`` alone, not on its slot or its neighbours.

Over a (data 2, model 2) mesh in a four-rank gloo world, the engine cuts
its four slots over 'data' (two a rank, so admission, harvest and refill
cross ranks) and its LM over 'model' itself; every rank's greedy tokens
equal JAX's engine without a mesh exactly (avg_logprob to 1e-4), and its
sampled tokens the port's engine without a mesh on the same seeds.
"""

import numpy as np
import pytest
import torch

from audax.infer.continuous import ContinuousGenerator as JaxGenerator
from audax_torch.infer.continuous import ContinuousGenerator
from audax_torch.ops import launch_counts, reset_launches

from .mesh_world import run_world
from .test_torch_two_tower import build


@pytest.fixture(scope="module")
def pair():
    return build("qwen3", seed=4)


def _clips(n=5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000.0
    return {f"c{i}": (0.3 * np.sin(2 * np.pi * (220 + 55 * i) * t)
                      + 0.05 * rng.standard_normal(t.size)
                      ).astype(np.float32)[: 9000 + 1500 * i]
            for i in range(n)}


SCENARIOS = {"free": {}, "allowed": dict(allowed_ids=[7, 11, 13, 200]),
             "budgets": dict(budgets={"c1": 2, "c3": 4})}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_generator_matches_jax(pair, name):
    jm, pm = pair
    sc = dict(SCENARIOS[name])
    budgets = sc.pop("budgets", {})
    kw = dict(start_id=0, end_id=2, slots=2, window_seconds=1.0,
              max_new_tokens=7, temperature=0.0, steps_per_sync=3, **sc)
    jg = JaxGenerator(jm, **kw)
    g = ContinuousGenerator(pm, device="cpu", **kw)
    clips = _clips()
    for engine in (jg, g):
        for rid, x in clips.items():
            engine.submit(rid, x, max_new_tokens=budgets.get(rid))
    reset_launches()
    ref = {r.request_id: r for r in jg.run()}
    ours = {r.request_id: r for r in g.run()}
    assert set(ours) == set(ref) == set(clips)
    assert g.chunks_run >= 3 and g.live() == g.pending() == 0
    assert 0 < g.decode_steps <= g.steps_run
    for rid, r in ref.items():
        assert ours[rid].tokens == r.tokens, rid
        assert ours[rid].avg_logprob == pytest.approx(r.avg_logprob,
                                                      abs=1e-4)
        if rid in budgets:
            assert len(ours[rid].tokens) <= budgets[rid]
        if "allowed_ids" in sc:
            assert set(r.tokens) <= set(sc["allowed_ids"])
    assert any(r.tokens for r in ours.values())
    counts = launch_counts()
    assert all(c["cuda"] == 0 for c in counts.values())   # the CPU path
    assert counts["decode_attention_stacked"]["plain"] > 0


def test_sampling_streams_follow_the_request(pair):
    """At temperature 0.8 a request's tokens depend on its seed only: the
    same clip and seed alone in one slot, or third among neighbours in
    another, gives the same tokens; another seed gives others."""
    _, pm = pair
    clips = _clips(3, seed=1)
    kw = dict(start_id=0, end_id=2, window_seconds=1.0, max_new_tokens=8,
              temperature=0.8, steps_per_sync=3, device="cpu")
    alone = ContinuousGenerator(pm, slots=1, **kw)
    alone.submit("x", clips["c2"], seed=11)
    solo = alone.run()[0].tokens
    busy = ContinuousGenerator(pm, slots=2, **kw)
    busy.submit("a", clips["c0"], seed=5)
    busy.submit("b", clips["c1"], seed=6, max_new_tokens=2)
    busy.submit("x", clips["c2"], seed=11)
    crowd = {r.request_id: r.tokens for r in busy.run()}
    assert crowd["x"] == solo
    other = ContinuousGenerator(pm, slots=1, **kw)
    other.submit("x", clips["c2"], seed=12)
    assert other.run()[0].tokens != solo


def test_generator_device_and_mesh(pair, mesh_of_one):
    """``mesh=`` serves (one rank: the tokens of the engine without one)."""
    _, pm = pair
    kw = dict(start_id=0, end_id=2, window_seconds=1.0)
    rng = np.random.default_rng(5)
    clip = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    tokens = []
    for mesh in (None, mesh_of_one):
        g = ContinuousGenerator(pm, mesh=mesh, device="cpu", slots=2,
                                max_new_tokens=6, **kw)
        g.submit("a", clip, seed=3)
        tokens.append(g.run()[0].tokens)
    assert tokens[0] == tokens[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousGenerator(pm, **kw)


MESH_KW = dict(start_id=0, end_id=2, slots=4, window_seconds=1.0,
               max_new_tokens=7, temperature=0.0, steps_per_sync=3)
MESH_BUDGETS = {"c1": 2, "c3": 4}


def test_generator_mesh_matches_jax(pair, tmp_path):
    jm, pm = pair
    clips = _clips(6)
    outs = run_world(4, "tests.torch_port.mesh_cases:generator_mesh", dict(
        model=pm, clips=clips, kw=MESH_KW, budgets=MESH_BUDGETS, seed=21),
        tmp_path, timeout=300)
    jg = JaxGenerator(jm, **MESH_KW)
    for rid, x in clips.items():
        jg.submit(rid, x, max_new_tokens=MESH_BUDGETS.get(rid))
    ref = {r.request_id: r for r in jg.run()}
    sampler = ContinuousGenerator(pm, device="cpu",
                                  **{**MESH_KW, "temperature": 0.8})
    for i, (rid, x) in enumerate(clips.items()):
        sampler.submit(rid, x, seed=21 + i)
    sampled = {r.request_id: r.tokens for r in sampler.run()}
    lm = pm.params["lm"]
    for out in outs:
        assert out["local_slots"] == 2 and out["chunks"] >= 3
        q = lm["layers"]["q"]["kernel"].shape
        assert out["lm_q"] == (q[0], q[1], q[2] // 2)
        assert out["embed"][0] == lm["embed"].shape[0] // 2
        assert set(out["greedy"]) == set(ref) == set(clips)
        for rid, r in ref.items():
            tokens, avg = out["greedy"][rid]
            assert tokens == r.tokens, rid
            assert avg == pytest.approx(r.avg_logprob, abs=1e-4)
        assert out["sampled"] == sampled
    assert any(r.tokens for r in ref.values())
    assert any(sampled.values())
