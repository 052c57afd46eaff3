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


# ---- the leaf-by-leaf, in-place update against the whole-tree chain -------
def _whole_tree_adamw(lr, moments, grad_clip, wd=1e-4, b1=0.9, b2=0.999,
                      eps=1e-8):
    """The earlier ``adamw_lp`` update, every operation over the whole tree
    at once into new tensors (the state is not written): the formula the
    leaf-by-leaf update must reproduce bit for bit."""
    store = O._STORE[moments]
    int8 = moments == "int8"

    @torch.no_grad()
    def update(grads, state, params):
        if grad_clip:
            grads = O.clip_by_global_norm(grads, grad_clip)
        rate = float(np.float32(lr(state.count)))
        count = state.count + 1
        c1 = float(np.float32(1) - np.power(np.float32(b1), np.float32(count)))
        c2 = float(np.float32(1) - np.power(np.float32(b2), np.float32(count)))
        gs = [g.float() for g in tree_leaves(grads)]
        if int8:
            ms = [O._q8_decode(q, s, g.shape) for q, s, g in zip(
                tree_leaves(state.mu["q"]), tree_leaves(state.mu["s"]), gs)]
        else:
            ms = [m.float() for m in tree_leaves(state.mu)]
        ns = [n.float() for n in tree_leaves(state.nu)]
        ms = torch._foreach_mul(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1.0 - b2)
        ns = torch._foreach_mul(ns, b2)
        torch._foreach_add_(ns, sq)
        den = torch._foreach_div(ns, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        out = torch._foreach_div(ms, c1)
        torch._foreach_div_(out, den)
        out = [o.to(g.dtype) for o, g in zip(out, tree_leaves(grads))]
        torch._foreach_add_(out, [p.detach() for p in tree_leaves(params)],
                            alpha=wd)
        torch._foreach_mul_(out, -rate)
        if int8:
            codes = [O._q8_encode(m) for m in ms]
            mu = {"q": O.tree_unflatten(state.mu["q"], [c[0] for c in codes]),
                  "s": O.tree_unflatten(state.mu["s"], [c[1] for c in codes])}
        else:
            mu = O.tree_unflatten(state.mu, [m.to(store) for m in ms])
        nu = O.tree_unflatten(state.nu, [n.to(store) for n in ns])
        return (O.tree_unflatten(grads, out),
                O.ScaleByAdamLPState(count, mu, nu))
    return update


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_leafwise_inplace_update_is_the_whole_tree_chain(moments, clip):
    """Three steps (the second gradient above the clip norm): parameters,
    updates and moments bit-equal to the whole-tree formula; the state's
    moment tensors are the ones ``init`` made (written in place); the
    caller's gradients are left as they were; and the parameters match
    JAX's ``adamw_lp`` (f32 rtol 1e-6, bf16 and int8 atol 2e-3)."""
    sched = O.seq2seq_schedule(1e-3, 1, 20)
    tx = O.adamw_lp(sched, grad_clip=clip, moments=moments)
    old = _whole_tree_adamw(sched, moments, clip)
    jtx = JO.adamw_lp(JO.seq2seq_schedule(1e-3, 1, 20), grad_clip=clip,
                      moments=moments)
    tp = tree_map(torch.from_numpy, _tree())
    rp = tree_map(torch.from_numpy, _tree())
    jp = jax.tree.map(jnp.asarray, _tree())
    ts, rs, js = tx.init(tp), tx.init(rp), jtx.init(jp)
    first = [id(t) for t in tree_leaves(ts.mu) + tree_leaves(ts.nu)]
    for step in range(3):
        g = _grads(step, big=1)
        tg = tree_map(torch.from_numpy, g)
        kept = tree_map(lambda t: t.clone(), tg)
        tu, ts = tx.update(tg, ts, tp)
        ru, rs = old(tree_map(torch.from_numpy, g), rs, rp)
        for a, b in zip(tree_leaves(tg), tree_leaves(kept)):
            assert torch.equal(a, b), "the caller's gradients changed"
        for a, b in zip(tree_leaves(tu), tree_leaves(ru)):
            assert torch.equal(a, b), f"step {step}: update differs"
        O.apply_updates(tp, tu)
        O.apply_updates(rp, ru)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
    assert ts.count == rs.count == 3
    assert [id(t) for t in tree_leaves(ts.mu) + tree_leaves(ts.nu)] == first
    for a, b in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                    tree_leaves(rs.mu) + tree_leaves(rs.nu)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(tp), tree_leaves(rp)):
        assert torch.equal(a, b)
    got = _flat(tree_map(lambda t: t.numpy(), tp))
    want = _flat(jp)
    for k in want:
        if moments == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=2e-3, err_msg=k)
