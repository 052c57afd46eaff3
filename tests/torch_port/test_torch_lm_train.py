"""Causal-LM pretraining (``audax_torch/train/lm.py``) vs the JAX
package's ``audax/train/lm.py``, on the CPU.

A JAX-initialised Qwen3-style LM (2 layers, d 64, 4/2 heads, head_dim 16)
carried into the port through the weight bridge; the same numpy windows.
The packed windows have no padding mask, so the port's causal attention
takes the flash path (the plain versions of K2/K7/K8 on CPU tensors).
Tolerances: ``pack_corpus`` exact; the warmup-cosine schedule at rtol 1e-6
or two float32 ulps of the peak rate (one float32 cosine, which numpy
and XLA may round one ulp apart);
parameters after three steps at rtol 1e-4, atol 1e-6
(``test_torch_finetune.py``'s bound) and losses at 1e-5 in float32; a
bfloat16 step's loss at 2e-2 (the two packages round bfloat16 at other
places); the ``fit_lm`` history at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audax.models import causal_lm as JLM
from audax.train import lm as JTrain
from audax_torch.models.bridge import causal_lm_from_numpy
from audax_torch.models.causal_lm import (CausalLMConfig, load_balance_loss,
                                          lm_forward)
from audax_torch.train import lm as T
from audax_torch.train.optim import warmup_cosine_decay_schedule

from .music_pair import flat

CFG = dict(vocab_size=96, d_model=64, layers=2, heads=4, kv_heads=2,
           qk_norm=True, max_seq=64)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def lm():
    jcfg = JLM.CausalLMConfig(**CFG)
    jparams = JLM.init_causal_lm(jcfg, jax.random.key(0))
    cfg = CausalLMConfig(**CFG)
    return jcfg, jparams, cfg, causal_lm_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _corpus(n=700, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], n,
                                                dtype=np.int32)


@pytest.mark.parametrize("seq_len", [16, 33, 100])
def test_pack_corpus_matches_jax(seq_len):
    ids = _corpus(301)
    np.testing.assert_array_equal(T.pack_corpus(ids, seq_len),
                                  JTrain.pack_corpus(ids, seq_len))


def test_pack_corpus_too_short_raises():
    with pytest.raises(ValueError):
        T.pack_corpus(np.arange(10), 16)


@pytest.mark.parametrize("warmup,steps", [(3, 10), (0, 5), (100, 1000),
                                          (1, 2)])
def test_warmup_cosine_schedule_matches_optax(warmup, steps):
    decay = max(steps, warmup + 1)
    ours = warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    for c in range(decay + 3):
        assert ours(c) == pytest.approx(float(ref(jnp.int32(c))), rel=1e-6,
                                        abs=3e-4 * 2.0 ** -22)


STEP_CASES = {"accum1": dict(), "accum2": dict(accum_steps=2),
              "remat-full": dict(remat="full"),
              "remat-dots": dict(remat="dots"),
              "accum2-full": dict(accum_steps=2, remat="full")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax(lm, case):
    """Three in-place steps at batch 4 (warmup 2, clip 1.0, decay 0.01):
    losses, token counts and every parameter against JAX's jitted step."""
    jcfg, jparams, cfg, params = lm
    kw = dict(warmup_steps=2, max_steps=3, batch_size=4, seq_len=16,
              **STEP_CASES[case])
    jstep = JTrain.make_lm_train_step(jcfg, JTrain.LMTrainConfig(**kw),
                                      donate=False)
    step = T.make_lm_train_step(cfg, T.LMTrainConfig(**kw))
    jstate = JTrain.init_lm_state(jparams, JTrain.LMTrainConfig(**kw))
    state = T.init_lm_state({k: v for k, v in flat_copy(params).items()},
                            T.LMTrainConfig(**kw))
    windows = T.pack_corpus(_corpus(), 16)
    for i in range(3):
        w = windows[4 * i: 4 * i + 4]
        w[0, 5] = -100                      # a masked label (and input 0)
        jstate, jm = jstep(jstate, jnp.asarray(w))
        state, m = step(state, torch.from_numpy(w))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert int(m["tokens"]) == int(jm["tokens"]) == 4 * 16 - 1
    assert state.step == 3
    ref = flat(jax.tree.map(np.asarray, jstate.params))
    for k, v in flat(state.params).items():
        np.testing.assert_allclose(v, ref[k], err_msg=k, **TOL)


def flat_copy(params):
    return jax.tree.map(lambda t: t.clone(), params,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_bf16_step_matches_jax(lm):
    jcfg, jparams, cfg, params = lm
    kw = dict(warmup_steps=0, max_steps=2, batch_size=4, seq_len=16,
              dtype="bfloat16")
    jstep = JTrain.make_lm_train_step(jcfg, JTrain.LMTrainConfig(**kw),
                                      donate=False)
    step = T.make_lm_train_step(cfg, T.LMTrainConfig(**kw))
    jstate = JTrain.init_lm_state(jparams, JTrain.LMTrainConfig(**kw))
    state = T.init_lm_state(flat_copy(params), T.LMTrainConfig(**kw))
    w = T.pack_corpus(_corpus(), 16)[:4]
    _, jm = jstep(jstate, jnp.asarray(w))
    state, m = step(state, torch.from_numpy(w))
    assert m["loss"].dtype == torch.float32
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert all(p.dtype == torch.float32 for p in jax.tree.leaves(
        state.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_fit_lm_history_matches_jax(lm, tmp_path):
    """Six steps, an eval every 2 over the held-out tail windows, and the
    checkpoints (latest steps, ``best/``, ``config.json``)."""
    jcfg, jparams, cfg, params = lm
    kw = dict(warmup_steps=2, max_steps=6, batch_size=4, seq_len=16,
              eval_every=2, eval_windows=4, seed=3)
    ids = _corpus(900)
    _, jh = JTrain.fit_lm(jparams, jcfg, JTrain.LMTrainConfig(**kw), ids)
    trained, h = T.fit_lm(params, cfg, T.LMTrainConfig(**kw), ids,
                          ckpt_dir=str(tmp_path), device="cpu")
    assert [r["step"] for r in h] == [r["step"] for r in jh] == [2, 4, 6]
    for row, jrow in zip(h, jh):
        assert set(row) == set(jrow)
        for key in ("loss", "eval_loss", "eval_ppl"):
            assert row[key] == pytest.approx(jrow[key], rel=1e-4), key
    names = {p.name for p in tmp_path.iterdir()}
    assert {"best", "config.json", "6"} <= names
    # the caller's parameters are untouched
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jparams["embed"]))
    assert not torch.equal(trained["embed"], params["embed"])


MOE = dict(num_experts=4, experts_per_tok=2, moe_ffn_dim=48)


def _moe_steps(case):
    """Three MoE train steps with the Switch aux term (``aux_loss_coef``
    0.001, scaled by each microbatch's token count) against JAX's: losses
    and every parameter, the router's and the experts' included. Returns
    (the port's step config, JAX's step, the JAX parameters, the windows)."""
    jcfg = JLM.CausalLMConfig(**CFG, **MOE)
    mcfg = CausalLMConfig(**CFG, **MOE)
    jparams = JLM.init_causal_lm(jcfg, jax.random.key(2))
    mparams = causal_lm_from_numpy(jax.tree.map(np.asarray, jparams), mcfg,
                                   device="cpu")
    kw = dict(warmup_steps=2, max_steps=3, batch_size=4, seq_len=16,
              **STEP_CASES[case])
    assert T.LMTrainConfig().aux_loss_coef == JTrain.LMTrainConfig(
        ).aux_loss_coef == 0.001
    jstep = JTrain.make_lm_train_step(jcfg, JTrain.LMTrainConfig(**kw),
                                      donate=False)
    step = T.make_lm_train_step(mcfg, T.LMTrainConfig(**kw))
    jstate = JTrain.init_lm_state(jparams, JTrain.LMTrainConfig(**kw))
    state = T.init_lm_state(mparams, T.LMTrainConfig(**kw))
    windows = T.pack_corpus(_corpus(seed=4), 16)
    for i in range(3):
        w = windows[4 * i: 4 * i + 4]
        jstate, jm = jstep(jstate, jnp.asarray(w))
        state, m = step(state, torch.from_numpy(w))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    ref = flat(jax.tree.map(np.asarray, jstate.params))
    got = flat(state.params)
    assert "layers/router/kernel" in got
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[k], err_msg=k, **TOL)
    return mcfg, kw, jstep, jparams, windows


@pytest.mark.parametrize("case", ["accum2", "remat-full"])
def test_moe_steps_match_jax(case):
    _moe_steps(case)


def test_moe_raises(lm):
    """The MoE train step, which raised before the MoE slice, held against
    JAX's (``_moe_steps``), and its aux term shown to be in the loss. What
    still raises: router logits of a dense config, and FSDP without a mesh
    (``fit_lm(mesh=)`` itself is held by ``test_torch_cli_mesh.py``)."""
    _, _, cfg, params = lm
    mcfg, kw, jstep, jparams, windows = _moe_steps("accum1")
    # the aux term is in the loss: without it the first loss differs
    plain = T.make_lm_train_step(mcfg, T.LMTrainConfig(aux_loss_coef=0.0,
                                                       **kw))
    fresh = T.init_lm_state(causal_lm_from_numpy(
        jax.tree.map(np.asarray, jparams), mcfg, device="cpu"),
        T.LMTrainConfig(**kw))
    _, m0 = plain(fresh, torch.from_numpy(windows[:4]))
    _, jm0 = jstep(JTrain.init_lm_state(jparams, JTrain.LMTrainConfig(**kw)),
                   jnp.asarray(windows[:4]))
    assert float(m0["loss"]) < float(jm0["loss"])
    with pytest.raises(ValueError):
        lm_forward(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                   return_router_logits=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        T.fit_lm(params, cfg, T.LMTrainConfig(), _corpus(), fsdp=True,
                 device="cpu")
    # uniform routing: each of the top-k slots adds 1 (the JAX value)
    assert float(load_balance_loss(torch.zeros(2, 8, 4), 4, 2)) == \
        pytest.approx(float(JLM.load_balance_loss(jnp.zeros((2, 8, 4)), 4,
                                                  2))) == 2.0
