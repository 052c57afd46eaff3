"""The two-tower with a mixture-of-experts decoder (``audax_torch/models/
two_tower.py``, ``audax_torch/train/two_tower.py``,
``audax_torch/infer/continuous.py``) vs the JAX package's, on the CPU:
``tests/test_moe.py``'s three two-tower cases held against JAX instead of
run alone, and the slot-refill generator over int4 experts.

``test_torch_two_tower.py``'s audio tower (Whisper of d_model 64, one
encoder layer, a 1 s window) and vocabulary; the LM ``MOE_TINY``-like (d
32, 2 layers, 4 experts, top 2, expert FFN 48) at 300 tokens. The JAX
package builds the model, the adapter's zero gates are opened from a numpy
seed, and the trees are carried into the port through the weight bridge.
float32 within 1e-4; greedy tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import TwoTowerConfig as JaxTTConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.infer.continuous import ContinuousGenerator as JaxGenerator
from audax.models import quantize as JQ
from audax.models import two_tower as JT
from audax.models.causal_lm import CausalLMConfig as JaxLMConfig
from audax.train import two_tower as JTrain
from audax_torch.core.config import TwoTowerConfig, WhisperConfig
from audax_torch.infer.continuous import ContinuousGenerator
from audax_torch.models import quantize as PQ
from audax_torch.models import two_tower as PT
from audax_torch.models.bridge import params_from_numpy, two_tower_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten
from audax_torch.ops import launch_counts, reset_launches
from audax_torch.train import two_tower as T

from .music_pair import flat
from .test_torch_two_tower import AUDIO, VOCAB

TOL = 1e-4
MOE_LM = dict(vocab_size=300, d_model=32, layers=2, heads=4, kv_heads=2,
              ffn_dim=64, qk_norm=True, num_experts=4, experts_per_tok=2,
              moe_ffn_dim=48)
TT = dict(adapter_heads=4, top_k_unfrozen_layers=1, max_target_tokens=16,
          adapter_lr=3e-3, lm_lr=1e-3)


def build(seed=0, **tt):
    """(JAX model, port model on the CPU) with the same weights."""
    tt = dict(TT, **tt)
    jm = JT.build_two_tower(JaxTTConfig(**tt), JaxWhisperConfig(**AUDIO),
                            JaxLMConfig(**MOE_LM), VOCAB,
                            jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jm.params)
    for gate in ("out", "ffn_out"):          # open the zero gates
        k = params["adapter"][gate]["kernel"]
        params["adapter"][gate]["kernel"] = (
            rng.standard_normal(k.shape) / np.sqrt(k.shape[0])
        ).astype(np.float32)
    jm = jm._replace(params=jax.tree.map(jnp.asarray, params))
    lm_cfg = CausalLMConfig(**dict(MOE_LM, vocab_size=VOCAB))
    audio_cfg = WhisperConfig(**AUDIO)
    pm = PT.TwoTowerModel(
        params_from_numpy(jax.tree.map(np.asarray, jm.audio_params),
                          audio_cfg, device="cpu"),
        audio_cfg, two_tower_from_numpy(params, lm_cfg, device="cpu"),
        lm_cfg, TwoTowerConfig(**tt))
    return jm, pm


def _mel(b=2, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, 100, 80)).astype(np.float32)


def test_two_tower_composes_with_moe_decoder():
    """The teacher-forced logits and greedy ``generate`` (its KV-cached MoE
    decode steps) equal JAX's; ``build_two_tower`` takes the MoE config."""
    jm, pm = build()
    mel = _mel()
    jenc, enc = jm.encode_audio(jnp.asarray(mel)), pm.encode_audio(
        torch.from_numpy(mel))
    ids = np.random.default_rng(6).integers(1, VOCAB, (2, 6))
    ref = jm.forward(jm.params, jenc, jnp.asarray(ids))
    ours = pm.forward(pm.params, enc, torch.from_numpy(ids))
    assert ours.shape == (2, 6, VOCAB)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    jt, jl = jm.generate(jm.params, jenc, start_id=1, end_id=2, max_len=8,
                         temperature=0.0)
    t, ln = pm.generate(pm.params, enc, start_id=1, end_id=2, max_len=8,
                        temperature=0.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
    built = PT.build_two_tower(pm.cfg, pm.audio_cfg, pm.lm_cfg, VOCAB,
                               torch.Generator().manual_seed(0),
                               device="cpu")
    assert built.params["lm"]["layers"]["experts"]["gate"][
        "kernel"].shape == (2, 4, 32, 48)


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    b = {"mel": _mel(seed=seed), "input_ids": rng.integers(1, VOCAB, (2, 6)),
         "attention_mask": mask}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_two_tower_train_step_with_moe_decoder():
    """The gradients through the MoE decoder (the ragged impl's backward)
    against JAX's, each leaf within 1e-4 of its largest, then one train
    step of each: the same loss, and the top-K unfreeze mask broadcasts
    over the 4-D expert leaves, so the top layer's experts move and the
    bottom layer's stay bit-identical. (Parameters after Adam are not
    compared: its first step is lr x sign(g) where |g| is near its eps, so
    a gradient of 1e-9 that rounds differently moves a weight by lr.)"""
    jm, pm = build(1)
    jb, b = _batch()

    def jloss(p):
        return jm.loss(p, jm.encode_audio(jb["mel"]), jb["input_ids"],
                       jb["attention_mask"])

    jg = flat(jax.tree.map(np.asarray, jax.grad(jloss)(jm.params)))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      pm.params)
    loss = pm.loss(params, pm.encode_audio(b["mel"]), b["input_ids"],
                   b["attention_mask"])
    grads = tree_unflatten(params, list(torch.autograd.grad(
        loss, tree_leaves(params))))
    for k, v in flat(grads).items():
        np.testing.assert_allclose(v, jg[k], rtol=0,
                                   atol=TOL * np.abs(jg[k]).max() + 1e-9,
                                   err_msg=k)
    assert np.abs(jg["lm/layers/experts/down/kernel"]).max() > 0
    jtx, jmask = JTrain.init_two_tower_optimizer(jm)
    jstate = JTrain.TwoTowerState(step=jnp.int32(0), params=jm.params,
                                  opt_state=jtx.init(jm.params), tx=jtx,
                                  layer_mask=jmask)
    jstep, _ = JTrain.make_two_tower_step(jm)
    jstate, jmet = jstep(jstate, jb)
    before = pm.params["lm"]["layers"]["experts"]["gate"]["kernel"].clone()
    step, _ = T.make_two_tower_step(pm)
    state, met = step(T.init_two_tower_state(pm), b)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=1e-5)
    after = state.params["lm"]["layers"]["experts"]["gate"]["kernel"]
    assert float((after[-1] - before[-1]).detach().abs().max()) > 0
    torch.testing.assert_close(after[0], before[0], atol=0, rtol=0)


def test_two_tower_moe_aux_loss_reachable():
    """``moe_aux_coef`` brings ``load_balance_loss`` into the two-tower loss
    (over the non-pad positions): the loss and the router's gradient equal
    JAX's at coef 0 and 0.5, and the coefficient changes both."""
    losses, grads = {}, {}
    for coef in (0.0, 0.5):
        jm, pm = build(2, moe_aux_coef=coef)
        jb, b = _batch(8)

        def jloss(p):
            return jm.loss(p, jm.encode_audio(jb["mel"]), jb["input_ids"],
                           jb["attention_mask"])

        jl, jg = jax.value_and_grad(jloss)(jm.params)
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          pm.params)
        loss = pm.loss(params, pm.encode_audio(b["mel"]), b["input_ids"],
                       b["attention_mask"])
        g = tree_unflatten(params, list(torch.autograd.grad(
            loss, tree_leaves(params))))
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
        jr = np.asarray(jg["lm"]["layers"]["router"]["kernel"])
        np.testing.assert_allclose(
            g["lm"]["layers"]["router"]["kernel"].numpy(), jr,
            atol=TOL * np.abs(jr).max(), rtol=0)
        losses[coef], grads[coef] = float(loss.detach()), jr
    aux = (losses[0.5] - losses[0.0]) / 0.5
    assert aux >= 0.99, aux
    assert np.abs(grads[0.5] - grads[0.0]).max() > 0


def _clips(n=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000.0
    return {f"c{i}": (0.3 * np.sin(2 * np.pi * (220 + 55 * i) * t)
                      + 0.05 * rng.standard_normal(t.size)
                      ).astype(np.float32)[: 9000 + 1500 * i]
            for i in range(n)}


def test_generator_over_int4_experts_matches_jax():
    """``ContinuousGenerator`` over the int4-quantized MoE LM (2 slots x top
    2 = 4 <= 4 experts: every decode step takes the selected scan), four
    clips refilling the slots: every request's tokens equal JAX's engine's
    on the same quantized weights, and K9's plain version serves it."""
    jm, pm = build(3)
    jq = {"adapter": jm.params["adapter"],
          "lm": JQ.quantize_tree(jm.params["lm"], bits=4)}
    q = {"adapter": pm.params["adapter"],
         "lm": PQ.quantize_tree(pm.params["lm"], bits=4)}
    kw = dict(start_id=0, end_id=2, slots=2, window_seconds=1.0,
              max_new_tokens=6, temperature=0.0, steps_per_sync=3)
    jg = JaxGenerator(jm, params=jq, **kw)
    g = ContinuousGenerator(pm, params=q, device="cpu", **kw)
    for engine in (jg, g):
        for rid, x in _clips().items():
            engine.submit(rid, x)
    reset_launches()
    ref = {r.request_id: r for r in jg.run()}
    ours = {r.request_id: r for r in g.run()}
    assert set(ours) == set(ref)
    for rid, r in ref.items():
        assert ours[rid].tokens == r.tokens, rid
    assert any(r.tokens for r in ours.values())
    counts = launch_counts()
    assert counts["int4_matmul"]["plain"] > 0
    assert all(c["cuda"] == 0 for c in counts.values())
