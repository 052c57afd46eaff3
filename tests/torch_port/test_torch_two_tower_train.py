"""Two-tower training (``audax_torch/train/two_tower.py``,
``two_tower_loop.py``) vs the JAX package's, on the CPU.

The same JAX-initialised two-tower (``music_pair.build_pair``: LM 2 layers,
d 64, 4/2 heads; audio tower 2 layers) and the same numpy batches. The
adapter's cross-attention runs the port's flash path (the plain versions
of K2/K7/K8), JAX its materialised twin; the LM's padded attention takes
the materialised twin in both. Tolerances: one step's gradients at rtol
1e-4, atol 1e-6, and one optimizer update at rtol 1e-5, atol 1e-8 (float32
arithmetic in another order); parameters after several steps at rtol
1e-4, atol 1e-6 (``test_torch_finetune.py``'s bound) at the reference's
learning rates (adapter 1e-4, LM 2e-5: Adam divides each gradient element
by its own running RMS, so an element whose gradient is small against its
rounding moves by up to the learning rate either way, and the bound on
such elements scales with the rate); losses and histories at 1e-4; frozen
layers and the generated tokens at temperature 0 exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.train import two_tower as JTrain
from audax.train import two_tower_loop as JLoop
from audax_torch.frontend.features import LogMelFrontend
from audax_torch.models.whisper import tree_leaves, tree_map, tree_unflatten
from audax_torch.train import two_tower as T
from audax_torch.train import two_tower_loop as L
from .music_pair import CHUNK_S, build_pair, flat, music_dataset, with_cfg

TOL = dict(rtol=1e-4, atol=1e-6)
#: the adapter's key bias adds the same q.b to every score of a query row,
#: which the softmax cancels: its gradient is zero up to rounding, so Adam
#: moves it by rounding noise in both packages (~1e-6 here) -- held at zero
#: within ZERO_GRAD_ATOL instead of against JAX's noise
ZERO_GRAD = "adapter/k/bias"
ZERO_GRAD_ATOL = 1e-4


@pytest.fixture(scope="module")
def data():
    return music_dataset(n=8, seed=3)


@pytest.fixture(scope="module")
def pair(data):
    return build_pair(len(data.tokenizer), seed=1)


def _batches(data, rows, seed=0):
    """(JAX batch, port batch) over the given example rows: the port's
    CPU log-mel feeds both, so the step is compared on equal inputs."""
    fe = LogMelFrontend.whisper(80, device="cpu")
    b = L.collate_music([data[i] for i in rows], fe, CHUNK_S)
    return ({k: jnp.asarray(v.numpy()) for k, v in b.items()}, b)


def _assert_params(ours, ref, **tol):
    """Every leaf of ``ours`` against ``ref`` ({path: array}); the key bias
    (zero gradient) held at zero instead."""
    for k, v in flat(ours).items():
        if k == ZERO_GRAD:
            assert np.abs(v).max() < ZERO_GRAD_ATOL
            assert np.abs(ref[k]).max() < ZERO_GRAD_ATOL
            continue
        np.testing.assert_allclose(v, ref[k], err_msg=k, **tol)


def _jax_state(jm):
    tx, mask = JTrain.init_two_tower_optimizer(jm)
    return JTrain.TwoTowerState(step=jnp.int32(0), params=jm.params,
                                opt_state=tx.init(jm.params), tx=tx,
                                layer_mask=mask)


@pytest.mark.parametrize("n_layers,top_k", [(4, 2), (4, 0), (4, 9), (1, 1)])
def test_layer_mask_matches_jax(n_layers, top_k):
    np.testing.assert_array_equal(
        T.layer_unfreeze_mask(n_layers, top_k).numpy(),
        np.asarray(JTrain.layer_unfreeze_mask(n_layers, top_k)))


def test_dual_lr_adamw_matches_optax(pair):
    """One update of the clipped dual-LR AdamW (decay 1e-4 on every leaf)
    on random gradients large enough to clip, masked as the step masks."""
    jm, pm = pair
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda p: (3.0 * rng.standard_normal(p.shape)
                                    ).astype(np.float32), jm.params)
    jtx, jmask = JTrain.init_two_tower_optimizer(jm)
    jg = JTrain._mask_lm_grads(jax.tree.map(jnp.asarray, grads), jmask)
    jup, _ = jtx.update(jg, jtx.init(jm.params), jm.params)
    tx, mask = T.init_two_tower_optimizer(pm)
    g = T._mask_lm_grads(jax.tree.map(torch.from_numpy, grads), mask)
    up, st = tx.update(g, tx.init(pm.params), pm.params)
    assert st.learning_rate["lm"].dtype == torch.float32
    ref = flat(jax.tree.map(np.asarray, jup))
    for k, v in flat(up).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_step_grads_match_jax(pair, data):
    jm, pm = pair
    jb, b = _batches(data, [0, 1, 2, 3])

    def jloss(p):
        return jm.loss(p, jm.encode_audio(jb["mel"]), jb["input_ids"],
                       jb["attention_mask"])
    jl, jg = jax.value_and_grad(jloss)(jm.params)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      pm.params)
    loss = pm.loss(params, pm.encode_audio(b["mel"]), b["input_ids"],
                   b["attention_mask"])
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    ref = flat(jax.tree.map(np.asarray, jg))
    for k, v in flat(tree_unflatten(params, list(grads))).items():
        np.testing.assert_allclose(v, ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_steps_match_jax(pair, data, accum):
    """Three steps, the plateau scaling, one more step: losses and every
    trainable leaf; the frozen LM layers bit-identical."""
    jm, pm = with_cfg(*pair, accum_steps=accum, adapter_lr=1e-4,
                      lm_lr=2e-5)
    jstep, jeval = JTrain.make_two_tower_step(jm, accum_steps=accum)
    step, evals = T.make_two_tower_step(pm, accum_steps=accum)
    jstate, state = _jax_state(jm), T.init_two_tower_state(pm)
    frozen = flat(pm.params["lm"]["layers"])
    for i in range(4):
        if i == 3:
            jstate = jstate.replace(opt_state=JTrain.scale_learning_rates(
                jstate.opt_state, 0.5))
            state = state.replace(opt_state=T.scale_learning_rates(
                state.opt_state, 0.5))
        jb, b = _batches(data, [(2 * i + r) % len(data) for r in range(4)])
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, b)
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-4)
    assert state.step == 4
    _assert_params(state.params, flat(jax.tree.map(np.asarray,
                                                   jstate.params)), **TOL)
    for k, v in flat(state.params["lm"]["layers"]).items():
        np.testing.assert_array_equal(v[:-1], frozen[k][:-1], err_msg=k)
        assert not np.array_equal(v[-1], frozen[k][-1]), k
    lr = float(state.opt_state.learning_rate["adapter"])
    assert lr == np.float32(np.float32(pm.cfg.adapter_lr) * np.float32(0.5))
    jb, b = _batches(data, [0, 1])
    assert float(evals(state, b)["loss"]) == pytest.approx(
        float(jeval(jstate, jb)["loss"]), rel=1e-4)


def test_trainable_param_counts_match_jax(pair):
    jm, pm = pair
    _, jmask = JTrain.init_two_tower_optimizer(jm)
    _, mask = T.init_two_tower_optimizer(pm)
    assert T.trainable_param_counts(pm, mask) == \
        JTrain.trainable_param_counts(jm, jmask)


def _jax_rates(opt_state):
    """The injected learning rates of a JAX two-tower optimizer state."""
    if hasattr(opt_state, "hyperparams"):
        return [float(opt_state.hyperparams["learning_rate"])]
    if isinstance(opt_state, dict):
        return [r for k in sorted(opt_state) for r in _jax_rates(opt_state[k])]
    if isinstance(opt_state, (list, tuple)):
        return [r for x in opt_state for r in _jax_rates(x)]
    return []


#: "learning": the proof's rates, the loss falls every epoch; "plateau":
#: rates so small that no epoch improves the val loss by 1e-6, so the
#: plateau scaling fires at every epoch after the first (patience 1)
FIT_RATES = {"learning": dict(adapter_lr=3e-3, lm_lr=1e-3),
             "plateau": dict(adapter_lr=1e-9, lm_lr=1e-9)}


@pytest.mark.parametrize("case", list(FIT_RATES))
def test_fit_two_tower_history_matches_jax(pair, data, tmp_path, case):
    """Four epochs: the per-epoch losses and the final learning rates agree
    with JAX's, and the checkpoints keep the last ``keep_epochs``."""
    jm, pm = with_cfg(*pair, epochs=4, **FIT_RATES[case])
    # the JAX loop donates its parameters: give it its own copy
    jm = jm._replace(params=jax.tree.map(jnp.copy, jm.params))
    kw = dict(chunk_seconds=CHUNK_S, val_fraction=0.25, plateau_patience=1)
    jstate, jh = JLoop.fit_two_tower(jm, data, **kw)
    state, h = L.fit_two_tower(pm, data, device="cpu",
                               ckpt_dir=str(tmp_path), keep_epochs=2, **kw)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(h[key], jh[key], rtol=1e-4, err_msg=key)
    rates = [float(state.opt_state.learning_rate[g])
             for g in ("adapter", "lm")]
    assert rates == _jax_rates(jstate.opt_state)
    scale = 0.125 if case == "plateau" else 1.0
    assert rates == [np.float32(pm.cfg.adapter_lr) * scale,
                     np.float32(pm.cfg.lm_lr) * scale]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_model", "epoch_002", "epoch_003"]


def test_resume_continues_the_run(pair, data, tmp_path):
    """Two epochs, then a resumed run to four, equal an uninterrupted four
    (one batch an epoch: the shuffle only permutes the batch's rows)."""
    _, pm = pair
    kw = dict(chunk_seconds=CHUNK_S, val_fraction=0.5, device="cpu")
    full, hf = L.fit_two_tower(pm._replace(cfg=pm.cfg.__class__(
        **{**pm.cfg.asdict(), "epochs": 4})), data, **kw)
    L.fit_two_tower(pm._replace(cfg=pm.cfg.__class__(
        **{**pm.cfg.asdict(), "epochs": 2})), data,
        ckpt_dir=str(tmp_path), **kw)
    resumed, hr = L.fit_two_tower(pm._replace(cfg=pm.cfg.__class__(
        **{**pm.cfg.asdict(), "epochs": 4})), data, ckpt_dir=str(tmp_path),
        resume=True, **kw)
    assert resumed.step == full.step == 4
    np.testing.assert_allclose(hr["train_loss"], hf["train_loss"][2:],
                               rtol=1e-5)
    _assert_params(resumed.params, flat(full.params), **TOL)


def test_eval_note_f1_matches_jax(pair, data):
    """Greedy (t = 0) generations token-exact, so the scores are equal."""
    jm, pm = pair
    from audax.frontend import LogMelFrontend as JaxFrontend
    idx = np.arange(4)
    ref = JLoop.eval_note_f1(jm, _jax_state(jm), data, idx,
                             JaxFrontend.whisper(80), CHUNK_S, max_len=24,
                             temperature=0.0, return_samples=True)
    ours = L.eval_note_f1(pm, T.init_two_tower_state(pm), data, idx,
                          LogMelFrontend.whisper(80, device="cpu"), CHUNK_S,
                          max_len=24, temperature=0.0, return_samples=True)
    assert ours == ref


def test_mesh_raises(pair, data):
    """FSDP without a mesh raises (the mesh runs are held in
    ``test_torch_cli_mesh.py``'s world)."""
    with pytest.raises(ValueError, match="needs a mesh"):
        L.fit_two_tower(pair[1], data, fsdp=True, device="cpu")
