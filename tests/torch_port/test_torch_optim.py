"""The port's fine-tune optimizer and EMA vs the JAX package on the CPU.

``adamw_lp`` with ``seq2seq_schedule`` and clipping, fed the same numpy
gradient sequence as the JAX chain: float32 moments agree at rtol 1e-6
(the first update has lr 0, one gradient is above the clip norm and the
others below it); bfloat16 moments track JAX's bfloat16 mode at atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audax.train import optim as JO
from audax_torch.models.whisper import tree_leaves, tree_map
from audax_torch.train import optim as O
from audax_torch.train.ema import ema_init, ema_update


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((7, 5)).astype(np.float32),
            "b": r.standard_normal((5,)).astype(np.float32),
            "attn": {"q": r.standard_normal((4, 4)).astype(np.float32),
                     "k": r.standard_normal((4, 4)).astype(np.float32)}}


def _grads(step, big):
    r = np.random.default_rng(100 + step)
    scale = 1.0 if step == big else 0.01     # norm ~8.7 vs ~0.09
    return {k: ((r.standard_normal(v.shape) * scale).astype(np.float32)
                if not isinstance(v, dict) else
                {kk: (r.standard_normal(vv.shape) * scale).astype(np.float32)
                 for kk, vv in v.items()})
            for k, v in _tree().items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.array(v)})
    return out


def _run_pair(moments, steps, sched_args, big=2):
    jtx = JO.adamw_lp(JO.seq2seq_schedule(*sched_args), grad_clip=1.0,
                      moments=moments)
    ttx = O.adamw_lp(O.seq2seq_schedule(*sched_args), grad_clip=1.0,
                     moments=moments)
    jp = jax.tree.map(jnp.asarray, _tree())
    tp = tree_map(torch.from_numpy, _tree())
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(steps):
        g = _grads(step, big)
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts, tp)
        O.apply_updates(tp, tu)
        yield step, _flat(jp), _flat(tree_map(lambda t: t.numpy(), tp)), ts


def test_f32_adamw_matches_jax_chain():
    first = None
    for step, jp, tp, ts in _run_pair("float32", 6, (1e-3, 2, 20)):
        assert ts.count == step + 1
        assert jp.keys() == tp.keys()
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=0,
                                       err_msg=f"step {step} {k}")
        if first is None:
            first = tp
    # update 0 has lr = schedule(0) = 0: only the moments moved
    for k, v in _flat(_tree()).items():
        np.testing.assert_array_equal(first[k], v)


def test_bf16_moments_track_jax_bf16():
    *_, last = _run_pair("bfloat16", 20, (1e-3, 2, 40))
    _, jp, tp, ts = last
    for leaf in tree_leaves(ts.mu) + tree_leaves(ts.nu):
        assert leaf.dtype == torch.bfloat16
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-3, err_msg=k)


def test_schedule_matches_optax():
    for args in ((1e-3, 2, 20), (5e-4, 0, 7), (1e-2, 10, 50)):
        ours, ref = O.seq2seq_schedule(*args), JO.seq2seq_schedule(*args)
        for c in range(args[2] + 3):
            assert ours(c) == float(ref(c)), (args, c)


def test_clip_matches_optax_and_int8_waits():
    g = _grads(0, big=0)
    clip = optax.clip_by_global_norm(1.0)
    ref, _ = clip.update(jax.tree.map(jnp.asarray, g), clip.init(None))
    tx = O.adamw_lp(0.0, weight_decay=0.0, grad_clip=1.0, moments="float32")
    tg = tree_map(torch.from_numpy, g)
    state = tx.init(tg)
    # lr 0: the update is zero, but the clipped gradient reaches mu as
    # (1 - b1) * g_clipped
    _, state = tx.update(tg, state, tg)
    for k, v in _flat(tree_map(lambda t: t.numpy(), state.mu)).items():
        np.testing.assert_allclose(v, 0.1 * _flat(ref)[k], rtol=1e-6)
    assert abs(float(O.global_norm(tg)) - float(optax.global_norm(
        jax.tree.map(jnp.asarray, g)))) < 1e-5
    # int8 moments no longer wait for a later slice: m is blockwise int8
    # (test_torch_optim_int8.py holds it against JAX)
    mu = O.adamw_lp(1e-3, moments="int8").init(tg).mu
    assert set(mu) == {"q", "s"}
    assert all(q.dtype == torch.int8 for q in tree_leaves(mu["q"]))
    with pytest.raises(ValueError):
        O.scale_by_adam_lp(moments="float16")


def test_ema_update_matches_numpy_oracle():
    """Debiased EMA (the min(decay, (1+t)/(10+t)) ramp) against the plain
    numpy recurrence of the JAX package's test."""
    r = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(r.standard_normal((4, 3)).astype(np.float32)),
            "b": {"c": torch.from_numpy(
                r.standard_normal(5).astype(np.float32))}}
    ema = ema_init(tree)
    ref = tree_map(lambda t: t.numpy().copy(), tree)
    decay = 0.9
    for t in range(12):
        new = tree_map(lambda x: x + 0.1 * torch.from_numpy(
            np.random.default_rng(t).standard_normal(x.shape)
            .astype(np.float32)), tree)
        ema = ema_update(ema, new, decay, t)
        d = min(decay, (1.0 + t) / (10.0 + t))
        ref = tree_map(lambda e, p: e * d + p.numpy() * (1 - d), ref, new)
        tree = new
    for got, want in zip(tree_leaves(ema), tree_leaves(ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
