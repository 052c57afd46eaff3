"""Port two-tower model and its trainable-only checkpoints
(``audax_torch/models/two_tower.py``, ``audax_torch/train/two_tower.py``)
vs the JAX package's, on the CPU.

The JAX package builds the model (a Whisper of d_model 64 with one encoder
layer as the audio tower, the command line's tiny LM as Qwen3 or Qwen2, the
vocabulary resized by ten rows); the adapter's zero-initialised gates are
filled from a numpy seed so the audio reaches the logits, and the trees are
carried into the port through the weight bridge. Teacher-forced logits and
the masked loss within 1e-4 (float32); ``generate`` at temperature 0 token-
and length-exact, with and without ``allowed_ids`` and ``prompt_ids``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.core.config import TwoTowerConfig as JaxTTConfig
from audax.core.config import WhisperConfig as JaxWhisperConfig
from audax.models import two_tower as JT
from audax.models.causal_lm import CausalLMConfig as JaxLMConfig
from audax.train import two_tower as JTrain
from audax_torch.core.config import TwoTowerConfig, WhisperConfig
from audax_torch.models import two_tower as PT
from audax_torch.models.bridge import params_from_numpy, two_tower_from_numpy
from audax_torch.models.causal_lm import CausalLMConfig
from audax_torch.models.whisper import tree_leaves, tree_map
from audax_torch.train.two_tower import (TwoTowerState,
                                         load_trainable_checkpoint,
                                         save_trainable_checkpoint)

TOL = 1e-4
LMS = {"qwen3": dict(vocab_size=300, d_model=128, layers=4, heads=4,
                     kv_heads=2, qk_norm=True),
       "qwen2": dict(vocab_size=300, d_model=128, layers=4, heads=4,
                     kv_heads=2, qkv_bias=True, tie_embeddings=False)}
AUDIO = dict(n_mels=80, n_audio_ctx=50, d_model=64, encoder_layers=1,
             decoder_layers=1, heads=2, vocab_size=400, n_text_ctx=16)
VOCAB = 310


def build(lm="qwen3", seed=0):
    """(JAX model, port model on the CPU) with the same weights."""
    jm = JT.build_two_tower(JaxTTConfig(), JaxWhisperConfig(**AUDIO),
                            JaxLMConfig(**LMS[lm]), VOCAB,
                            jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jm.params)
    for gate in ("out", "ffn_out"):          # open the zero gates
        k = params["adapter"][gate]["kernel"]
        params["adapter"][gate]["kernel"] = (
            rng.standard_normal(k.shape) / np.sqrt(k.shape[0])
        ).astype(np.float32)
    jm = jm._replace(params=jax.tree.map(jnp.asarray, params))
    lm_cfg = CausalLMConfig(**dict(LMS[lm], vocab_size=VOCAB))
    audio_cfg = WhisperConfig(**AUDIO)
    pm = PT.TwoTowerModel(
        params_from_numpy(jax.tree.map(np.asarray, jm.audio_params),
                          audio_cfg, device="cpu"),
        audio_cfg, two_tower_from_numpy(params, lm_cfg, device="cpu"),
        lm_cfg, TwoTowerConfig())
    return jm, pm


def _enc(jm, pm, b=2, seed=5):
    mel = np.random.default_rng(seed).standard_normal(
        (b, 100, 80)).astype(np.float32)
    jenc = jm.encode_audio(jnp.asarray(mel))
    enc = pm.encode_audio(torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=TOL,
                               rtol=0)
    return jenc, enc


@pytest.mark.parametrize("lm", list(LMS))
def test_forward_and_loss_match_jax(lm):
    jm, pm = build(lm)
    jenc, enc = _enc(jm, pm)
    ids = np.random.default_rng(6).integers(0, VOCAB, (2, 20))
    mask = np.ones((2, 20), np.int32)
    mask[0, 14:] = 0
    ref = jm.forward(jm.params, jenc, jnp.asarray(ids))
    ours = pm.forward(pm.params, enc, torch.from_numpy(ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    jloss = float(jm.loss(jm.params, jenc, jnp.asarray(ids),
                          jnp.asarray(mask)))
    loss = float(pm.loss(pm.params, enc, torch.from_numpy(ids),
                         torch.from_numpy(mask)))
    assert loss == pytest.approx(jloss, abs=TOL)
    total, count = pm.loss_sum(pm.params, enc, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    assert float(count) == mask[:, 1:].sum()


CASES = {"free": {}, "allowed": dict(allowed_ids=[7, 11, 13, 200]),
         "prompt": dict(prompt_ids=[4, 5, 6]),
         # a forced end_id never ends a row
         "prompt with end": dict(prompt_ids=[4, 2, 6]),
         "allowed+prompt": dict(allowed_ids=[7, 11, 13, 200],
                                prompt_ids=[4, 5])}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(case):
    jm, pm = build("qwen3", seed=1)
    jenc, enc = _enc(jm, pm, b=3)
    kw = dict(start_id=0, end_id=2, max_len=14, temperature=0.0,
              **CASES[case])
    jtok, jlen = jm.generate(jm.params, jenc, **kw)
    tok, lengths = pm.generate(pm.params, enc, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))
    if "prompt_ids" in kw:
        p = kw["prompt_ids"]
        assert (tok[:, 1: 1 + len(p)] == torch.tensor(p)).all()
    if "allowed_ids" in kw:
        gen = tok[:, 1 + len(kw.get("prompt_ids", [])):]
        assert set(gen.flatten().tolist()) <= set(kw["allowed_ids"]) | {2}


def test_generate_samples_reproducibly():
    _, pm = build("qwen3", seed=2)
    enc = pm.encode_audio(torch.randn(2, 100, 80,
                                      generator=torch.Generator().manual_seed(0)))
    kw = dict(start_id=0, end_id=2, max_len=10, temperature=0.9)
    a, _ = pm.generate(pm.params, enc, **kw,
                       generator=torch.Generator().manual_seed(3))
    b, _ = pm.generate(pm.params, enc, **kw,
                       generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)


def test_adapter_zero_gated_and_build():
    cfg, audio_cfg = TwoTowerConfig(), WhisperConfig(**AUDIO)
    lm_cfg = CausalLMConfig(**LMS["qwen3"])
    m = PT.build_two_tower(cfg, audio_cfg, lm_cfg, VOCAB,
                           torch.Generator().manual_seed(0), device="cpu")
    assert m.lm_cfg.vocab_size == VOCAB
    assert m.params["lm"]["embed"].shape == (VOCAB, 128)
    ad = m.params["adapter"]
    assert not ad["out"]["kernel"].any() and not ad["ffn_out"]["kernel"].any()
    text = torch.randn(2, 5, 128)
    audio = torch.randn(2, 50, 64)
    from audax_torch.models.whisper import layer_norm
    want = layer_norm(ad["ln2"], layer_norm(ad["ln1"], text))
    torch.testing.assert_close(PT.adapter_apply(ad, text, audio), want)
    # the audio tower's draw does not depend on whether the LM is given
    m2 = PT.build_two_tower(cfg, audio_cfg, lm_cfg, VOCAB,
                            torch.Generator().manual_seed(0),
                            lm_params=m.params["lm"], device="cpu")
    for a, b in zip(tree_leaves(m.audio_params), tree_leaves(m2.audio_params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(m.params["adapter"]),
                    tree_leaves(m2.params["adapter"])):
        assert torch.equal(a, b)


def _perturbed(pm, seed):
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + torch.randn(t.shape, generator=g),
                    pm.params)


@pytest.mark.parametrize("top_k", [2, 6])
def test_trainable_checkpoint_roundtrip(tmp_path, top_k):
    """The port's own format restores bit-exactly; only the top-K layers
    (clamped to the layer count: unclamped, K = 6 of 4 would save and
    merge the top two only) come from the checkpoint."""
    _, pm = build("qwen2")
    pm = pm._replace(cfg=TwoTowerConfig(top_k_unfrozen_layers=top_k))
    trained = _perturbed(pm, 0)
    state = TwoTowerState(step=7, params=trained,
                          opt_state={"mu": torch.ones(3)})
    save_trainable_checkpoint(str(tmp_path / "ck"), state, pm,
                              extra={"epoch": 2})
    out, saved = load_trainable_checkpoint(str(tmp_path / "ck"), pm,
                                           return_saved=True)
    assert saved["step"] == 7 and saved["extra"] == {"epoch": 2}
    assert torch.equal(saved["opt_state"]["mu"], torch.ones(3))
    k = min(top_k, 4)
    for name, full in out.params["lm"]["layers"].items():
        for key, t in full.items():
            assert torch.equal(t[4 - k:], trained["lm"]["layers"][name][key][4 - k:])
            assert torch.equal(t[: 4 - k], pm.params["lm"]["layers"][name][key][: 4 - k])
    for key in ("embed", "lm_head", "norm"):
        for a, b in zip(tree_leaves(out.params["lm"][key]),
                        tree_leaves(trained["lm"][key])):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(out.params["adapter"]),
                    tree_leaves(trained["adapter"])):
        assert torch.equal(a, b)
    pending = save_trainable_checkpoint(str(tmp_path / "ck2"), state, pm,
                                        save_optimizer=False, block=False)
    pending.wait_until_finished()
    _, saved = load_trainable_checkpoint(str(tmp_path / "ck2"), pm,
                                         return_saved=True)
    assert "opt_state" not in saved


def test_reads_jax_trainable_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (orbax) merges into the port's
    model to the same parameters as into JAX's."""
    jm, pm = build("qwen3")
    rng = np.random.default_rng(9)
    trained = jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jm.params)
    JTrain.save_trainable_checkpoint(
        str(tmp_path / "jax"), SimpleNamespace(step=jnp.int32(3),
                                               params=trained), jm,
        save_optimizer=False)
    jout = JTrain.load_trainable_checkpoint(str(tmp_path / "jax"), jm)
    out = load_trainable_checkpoint(str(tmp_path / "jax"), pm)
    ref = jax.tree.map(np.asarray, jout.params)
    for a, b in zip(tree_leaves(out.params), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), b)
