"""``audax_torch/core/rng.py`` holds the contract of ``audax/core/rng.py``
on ``torch.Generator``s: the same parent gives the same streams, a name's
stream does not depend on the other names or their order, distinct names
and steps give distinct streams, and deriving never advances the parent.
JAX's threefry numbers are not reproduced (the port's random streams are
its own, a difference by design), so the contract is checked on both
sides, not their numbers."""

import itertools

import jax
import numpy as np
import pytest
import torch

from audax.core import rng as jax_rng
from audax_torch.core import rng

NAMES = ("dropout", "specaugment", "init", "sampling")


def _draw(gen, n=8):
    return torch.rand(n, generator=gen).tolist()


def _jdraw(key, n=8):
    return np.asarray(jax.random.uniform(key, (n,))).tolist()


def test_key_is_seeded():
    assert _draw(rng.key(3)) == _draw(rng.key(3))
    assert _draw(rng.key(3)) != _draw(rng.key(4))
    assert rng.key(3).device == torch.device("cpu")


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))),
                         ids=lambda o: "".join(map(str, o)))
def test_split_named_is_order_independent(order):
    names = [NAMES[i] for i in order]
    ours = {k: _draw(g) for k, g in rng.split_named(rng.key(0), names).items()}
    ref = {k: _draw(g) for k, g in rng.split_named(rng.key(0),
                                                   NAMES[:3]).items()}
    assert ours == ref
    # the JAX package keeps the same contract
    j = {k: _jdraw(v) for k, v in jax_rng.split_named(jax_rng.key(0),
                                                      names).items()}
    jref = {k: _jdraw(v) for k, v in jax_rng.split_named(
        jax_rng.key(0), NAMES[:3]).items()}
    assert j == jref


def test_adding_a_consumer_reshuffles_nothing():
    parent = rng.key(11)
    before = {k: _draw(g) for k, g in rng.split_named(parent,
                                                      NAMES[:2]).items()}
    after = {k: _draw(g) for k, g in rng.split_named(parent, NAMES).items()}
    assert {k: after[k] for k in before} == before


def test_streams_are_distinct():
    parent = rng.key(0)
    named = [_draw(g) for g in rng.split_named(parent, NAMES).values()]
    steps = [_draw(rng.per_step(parent, i)) for i in range(6)]
    draws = named + steps + [_draw(rng.key(0))]
    assert len({tuple(d) for d in draws}) == len(draws)
    # another parent, other streams
    assert _draw(rng.split_named(rng.key(1), ["init"])["init"]) != \
        _draw(rng.split_named(parent, ["init"])["init"])
    # a name and a step that print alike stay apart
    assert _draw(rng.split_named(parent, ["0"])["0"]) != \
        _draw(rng.per_step(parent, 0))


def test_deriving_does_not_advance_the_parent():
    parent = rng.key(5)
    state = parent.get_state().clone()
    rng.split_named(parent, NAMES)
    rng.per_step(parent, 3)
    next(rng.stream(parent))
    assert torch.equal(parent.get_state(), state)


def test_per_step_and_stream_are_deterministic():
    parent = rng.key(2)
    assert _draw(rng.per_step(parent, 7)) == _draw(rng.per_step(rng.key(2),
                                                                7))
    got = [_draw(g) for g in itertools.islice(rng.stream(parent), 4)]
    assert got == [_draw(rng.per_step(parent, i)) for i in range(4)]
    # the JAX stream is per_step of 0, 1, 2... too
    jgot = [_jdraw(k) for k in itertools.islice(
        jax_rng.stream(jax_rng.key(2)), 3)]
    assert jgot == [_jdraw(jax_rng.per_step(jax_rng.key(2), i))
                    for i in range(3)]


def test_a_derived_generator_keeps_the_parent_device():
    child = rng.per_step(rng.key(0, device="cpu"), 1)
    assert child.device == torch.device("cpu")
    assert 0 <= child.initial_seed() < 2 ** 63
