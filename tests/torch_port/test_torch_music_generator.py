"""Port ``ContinuousGenerator`` (the two-tower's slot-refill engine) vs the
JAX package's, on the CPU.

The model of ``test_torch_two_tower.py`` (JAX-built, gates opened, bridged)
serves five clips of a 1 s window through two slots, so slots are refilled
while their neighbours decode: at temperature 0 every request's tokens
equal JAX's, with the same avg_logprob to 1e-4, with and without the
allowed-id mask and with per-request ``max_new_tokens``. Sampling at a
temperature is reproducible per request: a request's tokens depend on its
``seed`` alone, not on its slot or its neighbours.
"""

import numpy as np
import pytest
import torch

from audax.infer.continuous import ContinuousGenerator as JaxGenerator
from audax_torch.infer.continuous import ContinuousGenerator
from audax_torch.ops import launch_counts, reset_launches

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


def test_generator_device_and_mesh(pair):
    _, pm = pair
    kw = dict(start_id=0, end_id=2, window_seconds=1.0)
    with pytest.raises(NotImplementedError, match="parallelism"):
        ContinuousGenerator(pm, mesh="mesh", device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousGenerator(pm, **kw)
