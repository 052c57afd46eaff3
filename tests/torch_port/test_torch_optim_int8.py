"""``adamw_lp(moments="int8")`` against the JAX package's on the CPU.

m is stored blockwise-absmax int8 (256-element blocks, one float32 scale
each), v in bfloat16. Both sides get the same numpy gradients for 3 steps
on a tree whose leaves are not multiples of 256 (the last block padded).
The int8 codes must be equal, except +-1 where the two float32 m values
land on either side of a rounding tie (at most 1 code in 1,000); the
scales agree within 1e-6 relative, the bfloat16 v within one bfloat16 step
(2^-7 relative), and the updates within 1e-6 of their largest value (the
float32 update's own rounding; measured: 1.2e-7, no code flipped) -- or,
in a step where a code flipped, within 1e-2 of it (one int8 step of m is
1/127 of its block's max). ``moment_bytes_per_param`` is equal in every
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.train import optim as JO
from audax_torch.models.whisper import tree_leaves, tree_map
from audax_torch.train import optim as O

#: keys in sorted order, so that both packages flatten the tree alike
SHAPES = {"b": (300,), "blk": {"k": (3,), "q": (16, 16)}, "w": (7, 45)}


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)

    def one(shape):
        return (r.standard_normal(shape) * scale).astype(np.float32)
    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in SHAPES.items()}


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [t.float().numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_int8_moments_match_jax_over_three_steps(grad_clip):
    params = _tree(0)
    jtx = JO.adamw_lp(1e-3, weight_decay=1e-4, moments="int8",
                      grad_clip=grad_clip)
    ttx = O.adamw_lp(1e-3, weight_decay=1e-4, moments="int8",
                     grad_clip=grad_clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    jstate = js[-3]                  # the chain's Adam state
    tstate = ts
    # leaf shapes of the int8 state as in JAX: [blocks, 256] codes
    for jq, tq in zip(jax.tree.leaves(jstate.mu["q"]),
                      tree_leaves(tstate.mu["q"])):
        assert tuple(jq.shape) == tuple(tq.shape) and tq.dtype == torch.int8
    flips, codes = 0, 0
    for step in range(3):
        g = _tree(10 + step, scale=0.3)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts, tp)
        jstate = js[-3]
        flipped = 0
        for jq, tq in zip(_leaves(jstate.mu["q"]),
                          _torch_leaves(ts.mu["q"])):
            diff = np.abs(jq - tq)
            assert diff.max() <= 1
            flipped += int((diff > 0).sum())
            codes += diff.size
        flips += flipped
        for a, b in zip(_leaves(jstate.mu["s"]), _torch_leaves(ts.mu["s"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        for a, b in zip(_leaves(jstate.nu), _torch_leaves(ts.nu)):
            np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=1e-30)
        for a, b in zip(_leaves(ju), _torch_leaves(tu)):
            np.testing.assert_allclose(
                b, a, rtol=0, atol=(1e-2 if flipped else 1e-6)
                * np.abs(a).max())
        # the same updates applied to both parameter trees
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        O.apply_updates(tp, tu)
    assert flips <= codes // 1000


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_moment_bytes_per_param(moments):
    assert O.moment_bytes_per_param(moments) == \
        JO.moment_bytes_per_param(moments)


def test_int8_state_is_smaller_and_decodes_zero():
    params = tree_map(torch.from_numpy, _tree(1))
    st = O.scale_by_adam_lp(moments="int8").init(params)
    assert all(bool((q == 0).all()) for q in tree_leaves(st.mu["q"]))
    assert all(s.dtype == torch.float32 for s in tree_leaves(st.mu["s"]))
    assert all(n.dtype == torch.bfloat16 for n in tree_leaves(st.nu))
    n = sum(p.numel() for p in tree_leaves(params))
    stored = sum(t.numel() * t.element_size() for t in tree_leaves(st.mu)
                 + tree_leaves(st.nu))
    # the padding of the last block of each leaf sits above the 3.02 B/param
    assert O.moment_bytes_per_param("int8") * n <= stored < 4 * n


def test_int8_m_of_a_cut_leaf_needs_the_layout():
    """An int8 m is laid out over the whole leaf; a rank's block of the
    gradient passed without its ``layout=`` raises rather than decode the
    first elements of the whole m as this rank's."""
    tx = O.scale_by_adam_lp(moments="int8")
    st = tx.init({"w": torch.zeros(4, 256)})            # 4 blocks
    with pytest.raises(ValueError, match="needs layout="):
        tx.update({"w": torch.ones(2, 256)}, st)        # a rank's half
    upd, _ = tx.update({"w": torch.ones(4, 256)}, st)   # whole: runs
    assert upd["w"].shape == (4, 256)
