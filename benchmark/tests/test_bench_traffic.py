"""The traffic generator: reproducible from the seed, the same work for
every seed."""

import json

from benchmark.lib import gen
from tiny import ROOT

BACKLOG = json.loads((ROOT / "benchmark/traffic/speech-backlog.json")
                     .read_text())


def key(reqs):
    return [(r.offset, r.n_samples, r.budget) for r in reqs]


def test_same_seed_same_requests_large_seed():
    seed = 2 ** 31 + 12345
    a = gen.requests(BACKLOG, seed, 300)
    assert key(a) == key(gen.requests(BACKLOG, seed, 300))
    assert key(a) != key(gen.requests(BACKLOG, seed + 1, 300))


def test_every_seed_offers_the_same_work_in_another_order():
    a, b = gen.requests(BACKLOG, 1, 400), gen.requests(BACKLOG, 2, 400)
    for field in ("n_samples", "budget"):
        assert sorted(getattr(r, field) for r in a) == \
            sorted(getattr(r, field) for r in b)
    assert [r.budget for r in a] != [r.budget for r in b]
    lo, hi = BACKLOG["budget_tokens"]
    assert min(r.budget for r in a) == lo and max(r.budget for r in a) == hi


def test_backlog_stream_is_the_same_drawn_in_blocks():
    whole = gen.requests(BACKLOG, 5, 600, block=256)
    parts = (gen.requests(BACKLOG, 5, 256, first=0, block=256)
             + gen.requests(BACKLOG, 5, 256, first=256, block=256)
             + gen.requests(BACKLOG, 5, 88, first=512, block=256))
    assert key(whole) == key(parts)
    assert [r.index for r in whole] == list(range(600))


def test_train_batches_differ_and_repeat():
    prompt = [50258, 50259, 50359, 50363]
    mix = json.loads((ROOT / "benchmark/traffic/finetune-b16.json")
                     .read_text())
    o1, r1 = gen.train_batch(mix, 3, 0, 16, prompt, 50257)
    o2, r2 = gen.train_batch(mix, 3, 1, 16, prompt, 50257)
    assert len(set(o1)) == 16 and not set(o1) & set(o2)
    assert gen.train_batch(mix, 3, 0, 16, prompt, 50257)[1] == r1
    lens = sorted(len(r) for r in r1)
    assert lens[0] >= 16 and lens[-1] <= 96
    assert all(r[:4] == prompt and r[-1] == 50257 for r in r1)
