"""Deterministic random-generator plumbing (port of ``audax/core/rng.py``).

The JAX package passes explicit PRNG keys and folds names and step numbers
into them. The port's random streams are ``torch.Generator``s, so these
helpers derive generators instead: each derived generator is seeded from a
stable hash (BLAKE2b) of its parent's seed and the name or step folded in.
A parent is never advanced by a derivation, so the order in which
consumers ask does not matter, and adding a consumer never reshuffles the
others -- the contract of JAX's ``fold_in``. JAX's key arithmetic itself
(threefry) is not reproduced: the same seed gives other numbers in the two
packages, the "random streams" difference by design of the port.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Sequence, Union

import torch

__all__ = ["key", "split_named", "per_step", "stream"]

_MASK = (1 << 63) - 1


def key(seed: int = 0, device: Union[str, torch.device] = "cpu"
        ) -> torch.Generator:
    """A generator on ``device`` seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _fold(gen: torch.Generator, data: Union[int, str]) -> torch.Generator:
    """A new generator on ``gen``'s device whose seed hashes ``gen``'s seed
    with ``data`` (an int and a str never collide: they are tagged)."""
    tag = f"i:{data}" if isinstance(data, int) else f"s:{data}"
    digest = hashlib.blake2b(f"{gen.initial_seed()}|{tag}".encode(),
                             digest_size=8).digest()
    return key(int.from_bytes(digest, "little") & _MASK, gen.device)


def split_named(gen: torch.Generator, names: Sequence[str]
                ) -> Dict[str, torch.Generator]:
    """One generator per name, each from a stable hash of the name (order
    independent; adding a name never changes another name's stream)."""
    return {name: _fold(gen, str(name)) for name in names}


def per_step(gen: torch.Generator, step: int) -> torch.Generator:
    """The generator of step ``step``."""
    return _fold(gen, int(step))


def stream(gen: torch.Generator) -> Iterator[torch.Generator]:
    """An endless stream of fresh generators: ``per_step`` of 0, 1, 2..."""
    i = 0
    while True:
        yield per_step(gen, i)
        i += 1
