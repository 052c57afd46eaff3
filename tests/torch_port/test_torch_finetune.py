"""The port's fine-tune step vs the JAX package's, on the CPU.

Same JAX-initialised parameters (through the weight bridge), same numpy
inputs. A width with head_dim 16 and 16-token label rows puts every
attention site of the port on the flash path (plain versions of K2/K7/K8
on CPU tensors), while JAX on the CPU takes its materialised twin. Float32
logits agree at 1e-4; one step's loss at rel 1e-5 and every gradient leaf
at rtol 1e-4, atol 1e-6, for full-parameter and LoRA training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import lora as JL
from audax.models import whisper as JW
from audax.train import seq2seq as JS
from audax_torch.core.config import FineTuneConfig, WhisperConfig
from audax_torch.models import whisper as W
from audax_torch.models.bridge import lora_from_numpy, params_from_numpy
from audax_torch.models.lora import (apply_lora, init_lora, lora_param_count,
                                     merge_lora)
from audax_torch.train import seq2seq as S
from audax_torch.train.optim import GradientTransformation

SMALL = dict(n_mels=8, n_audio_ctx=16, d_model=32, encoder_layers=1,
             decoder_layers=1, heads=2, vocab_size=50, n_text_ctx=24)
TINY = WhisperConfig(n_mels=8, n_audio_ctx=16, d_model=16, encoder_layers=1,
                     decoder_layers=1, heads=2, vocab_size=50, n_text_ctx=16)
#: a 15-token row pads the batch to L = 16: the decoder's causal
#: self-attention and its cross-attention take the flash path too
ROWS = [[1] + list(range(4, 18)) + [2], [1, 8, 9, 2]]
TARGETS = ("attn/q", "attn/v", "mlp_in")


@pytest.fixture(scope="module")
def model():
    jcfg = JaxWhisperConfig(**SMALL)
    jparams = JW.init_whisper_params(jcfg, jax.random.key(0))
    cfg = WhisperConfig(**SMALL)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _batch(rng, rows=ROWS, n_audio_ctx=16, n_mels=8):
    mel = rng.standard_normal((len(rows), 2 * n_audio_ctx, n_mels)
                              ).astype(np.float32)
    coll = JS.collate_seq2seq(rows, decoder_start_id=1)
    np_batch = {"mel": mel, **coll}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _jax_tree_to_port_layout(grads):
    """JAX gradients as numpy in the port's layout (conv kernels are
    [C_out, C_in, 3] in the port)."""
    out = {}
    for k, v in _flat(grads).items():
        v = np.asarray(v)
        out[k] = v.transpose(2, 1, 0) if "/conv" in k and k.endswith(
            "kernel") else v
    return out


def _recording_state(trainable, use_lora=False, base=None, alpha=16.0):
    """A train state whose optimizer records the gradients it is given and
    leaves the parameters unchanged."""
    seen = []

    def update(grads, state, params):
        seen.append(W.tree_map(lambda g: g.clone(), grads))
        return W.tree_map(torch.zeros_like, grads), state

    tx = GradientTransformation(lambda p: None, update)
    trainable = W.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                           trainable)
    return S.FTState(step=0, base_params=base or {}, trainable=trainable,
                     opt_state=None, tx=tx, use_lora=use_lora,
                     lora_alpha=alpha), seen


def test_collate_matches_jax():
    for rows, kw in (([[7, 5, 6, 9], [7, 5, 9]], dict(pad_multiple=4)),
                     ([[5, 6]], {}), (ROWS, {}), ([[1, 2, 3]] * 3,
                                                   dict(pad_to=12)),
                     ([[1] + list(range(30))], dict(pad_to=8))):
        ref = JS.collate_seq2seq(rows, decoder_start_id=7, **kw)
        ours = S.collate_seq2seq(rows, decoder_start_id=7, **kw)
        assert ref.keys() == ours.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def test_seq2seq_loss_matches_jax(rng):
    logits = (3 * rng.standard_normal((3, 8, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 8)).astype(np.int32)
    labels[0, 5:] = S.LABEL_PAD
    labels[2, :] = S.LABEL_PAD
    ref = float(JS.seq2seq_loss(jnp.asarray(logits), jnp.asarray(labels)))
    ours = S.seq2seq_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(ours) == pytest.approx(ref, rel=1e-6)
    total, count = S.seq2seq_loss_sum(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    assert int(count) == 13
    # everything masked: 0 / max(0, 1)
    pad = torch.full((1, 4), S.LABEL_PAD)
    assert float(S.seq2seq_loss(torch.zeros(1, 4, 50), pad)) == 0.0


def test_whisper_forward_matches_jax(model, rng):
    jcfg, jparams, cfg, params = model
    jb, tb = _batch(rng)
    ref = np.asarray(JW.whisper_forward(jparams, jcfg, jb["mel"],
                                        jb["decoder_input_ids"]))
    ours = W.whisper_forward(params, cfg, tb["mel"], tb["decoder_input_ids"])
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_step_grads_match_jax(model, rng, lora):
    """One step of the port's ``make_finetune_step`` (per-layer remat, the
    fine-tune default) against ``jax.value_and_grad`` of the JAX loss."""
    jcfg, jparams, cfg, params = model
    jb, tb = _batch(rng)
    if lora:
        jl = JL.init_lora(jparams, 8, targets=TARGETS, rng=jax.random.key(3))
        # a non-zero B, so both adapters get gradients
        jl = jax.tree.map(lambda x: x + 0.1, jl)

        def jloss(tr):
            p = JL.apply_lora(jax.lax.stop_gradient(jparams), tr, 16.0)
            return JS.seq2seq_loss(JW.whisper_forward(
                p, jcfg, jb["mel"], jb["decoder_input_ids"], remat=True
            ).astype(jnp.float32), jb["labels"])
        loss, jg = jax.value_and_grad(jloss)(jl)
        want = {f"{path}/{k}": np.asarray(ab[k]) for path, ab in jg.items()
                for k in ("a", "b")}
        state, seen = _recording_state(
            lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu"),
            use_lora=True, base=params)
    else:
        def jloss(p):
            return JS.seq2seq_loss(JW.whisper_forward(
                p, jcfg, jb["mel"], jb["decoder_input_ids"], remat=True
            ).astype(jnp.float32), jb["labels"])
        loss, jg = jax.value_and_grad(jloss)(jparams)
        want = _jax_tree_to_port_layout(jg)
        state, seen = _recording_state(params)

    step = S.make_finetune_step(cfg, remat=True)
    state, m = step(state, tb)
    assert state.step == 1
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-5)
    got = {k: v.numpy() for k, v in _flat(seen[0]).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if lora:
        for t in W.tree_leaves(state.base_params):
            assert not t.requires_grad


def _sgd_state(params, lr=1e-2):
    tx = GradientTransformation(
        lambda p: None,
        lambda g, s, p: (W.tree_map(lambda x: -lr * x, g), s))
    return S.FTState(step=0, base_params={}, trainable=W.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), params),
        opt_state=None, tx=tx)


def test_grad_accum_matches_full_batch(model, rng):
    """accum_steps=K gives the full-batch update on ragged label rows under
    SGD (linear in the gradient), and an indivisible batch raises."""
    *_, cfg, params = model
    _, tb = _batch(rng, rows=[[1, 4, 5, 6, 2], [1, 8, 2], [1, 3, 4, 5, 6, 2],
                              [1, 9, 2]])
    outs = {}
    for k in (1, 2, 4):
        step = S.make_finetune_step(cfg, remat=False, accum_steps=k)
        state, m = step(_sgd_state(params), tb)
        outs[k] = (float(m["loss"]), _flat(state.trainable))
    for k in (2, 4):
        assert outs[k][0] == pytest.approx(outs[1][0], rel=1e-5)
        for name, a in outs[1][1].items():
            np.testing.assert_allclose(outs[k][1][name].detach().numpy(),
                                       a.detach().numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        S.make_finetune_step(cfg, remat=False, accum_steps=3)(
            _sgd_state(params), tb)


def test_remat_policies_agree(model, rng):
    """remat True (recompute each layer), "dots" (keep the projection
    outputs) and False: the same loss and the same AdamW update."""
    *_, cfg, params = model
    _, tb = _batch(rng)
    ft = FineTuneConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10)
    outs = {}
    for remat in (True, "dots", False):
        state = S.init_finetune(params, ft)
        step = S.make_finetune_step(cfg, remat=remat)
        for _ in range(2):                  # update 0 has lr 0
            state, m = step(state, tb)
        outs[remat] = (float(m["loss"]), _flat(state.trainable))
    for remat in ("dots", False):
        assert outs[remat][0] == pytest.approx(outs[True][0], rel=1e-6)
        for name, a in outs[True][1].items():
            np.testing.assert_allclose(outs[remat][1][name].detach().numpy(),
                                       a.detach().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    # the caller's params were copied, not trained in place
    for a, b in zip(W.tree_leaves(params),
                    W.tree_leaves(S.init_finetune(params, ft).trainable)):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b.detach())


def test_lora_init_is_identity_and_merge(model, rng):
    _, _, cfg, params = model
    lora = init_lora(params, 2, targets=("attn/q", "attn/v"),
                     generator=torch.Generator().manual_seed(1))
    assert set(lora) == {"decoder/layers/attn/q/kernel",
                         "decoder/layers/attn/v/kernel",
                         "encoder/layers/attn/q/kernel",
                         "encoder/layers/attn/v/kernel"}
    a = lora["decoder/layers/attn/q/kernel"]["a"]
    assert a.shape == (1, 2, 32) and lora_param_count(lora) == 4 * 2 * 64
    _, tb = _batch(rng)
    mel, toks = tb["mel"], tb["decoder_input_ids"]
    base = W.whisper_forward(params, cfg, mel, toks)
    adapted = W.whisper_forward(apply_lora(params, lora), cfg, mel, toks)
    torch.testing.assert_close(adapted, base, atol=1e-6, rtol=0)
    lora2 = W.tree_map(lambda x: x + 0.1, lora)
    applied = W.whisper_forward(apply_lora(params, lora2), cfg, mel, toks)
    merged = W.whisper_forward(merge_lora(params, lora2), cfg, mel, toks)
    assert not torch.allclose(base, applied)
    torch.testing.assert_close(applied, merged, atol=1e-6, rtol=0)


def test_lora_conv_target_raises(model):
    jcfg, jparams, _, params = model
    with pytest.raises(ValueError, match="conv"):
        init_lora(params, 2, targets=("conv1",),
                  generator=torch.Generator().manual_seed(0))
    jl = JL.init_lora(jparams, 2, targets=("conv2",), rng=jax.random.key(0))
    with pytest.raises(ValueError, match="conv"):
        lora_from_numpy(jax.tree.map(np.asarray, jl), device="cpu")


@pytest.mark.parametrize("lora_rank,dtype",
                         [(0, "float32"), (2, "float32"), (0, "bfloat16")])
def test_finetune_overfits_tiny(lora_rank, dtype):
    """Full fine-tune, LoRA and bf16 compute (float32 master weights) each
    drive the loss below half its start on one batch (the JAX package's
    overfit check)."""
    params = W.init_whisper_params(TINY, torch.Generator().manual_seed(0),
                                   device="cpu")
    if lora_rank:
        # frozen, tied random embeddings (std 0.02) cap the logits; trained
        # checkpoints have larger ones
        params["decoder"]["embed"] = params["decoder"]["embed"] * 30.0
    ft = FineTuneConfig(learning_rate=1e-2 if lora_rank else 5e-3,
                        warmup_steps=2, max_steps=120, lora_rank=lora_rank,
                        dtype=dtype)
    state = S.init_finetune(params, ft, lora_targets=(
        "attn/q", "attn/v", "mlp_in", "mlp_out"))
    step = S.make_finetune_step(
        TINY, remat=True,
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 2 * TINY.n_audio_ctx, TINY.n_mels)
                              ).astype(np.float32)
    coll = S.collate_seq2seq([[4, 5, 6, 2], [8, 9, 2]], decoder_start_id=1)
    batch = {"mel": torch.from_numpy(mel),
             **{k: torch.from_numpy(v) for k, v in coll.items()}}
    snapshot = W.tree_map(lambda t: t.clone(), params)
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    for a, b in zip(W.tree_leaves(params), W.tree_leaves(snapshot)):
        assert torch.equal(a, b)                  # the caller's tree
    if lora_rank:
        for a, b in zip(W.tree_leaves(state.base_params),
                        W.tree_leaves(snapshot)):
            assert torch.equal(a, b)
