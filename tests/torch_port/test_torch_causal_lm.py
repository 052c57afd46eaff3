"""Port causal LM (``audax_torch/models/causal_lm.py``) vs the JAX package's
``audax/models/causal_lm.py`` and HF's Qwen2/Qwen3, on the CPU.

Weights are drawn by JAX and carried into the port through
``causal_lm_from_numpy``; tokens come from a numpy seed. Configs: the
command line's tiny LM (d_model 128, 4 layers, 4 query / 2 KV heads) as
Qwen3 (q/k norms, tied head) and as Qwen2 (q/k/v biases, a separate head),
and a head_dim-128 Qwen3 (the published width of a head). Teacher-forced
logits within 1e-4 (float32, summation order only), with and without a
padding mask; decode steps at a scalar and at per-slot positions against
JAX's; HF models built from random configs against HF's logits (1e-4) and
JAX's port of the same model.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audax.models import causal_lm as J
from audax_torch.models import causal_lm as P
from audax_torch.models.bridge import causal_lm_from_numpy

TOL = 1e-4

CONFIGS = {
    "qwen3-tiny": dict(vocab_size=320, d_model=128, layers=4, heads=4,
                       kv_heads=2, qk_norm=True),
    "qwen2-tiny": dict(vocab_size=320, d_model=128, layers=4, heads=4,
                       kv_heads=2, qkv_bias=True, tie_embeddings=False),
    "qwen3-hd128": dict(vocab_size=256, d_model=128, layers=2, heads=4,
                        kv_heads=2, head_dim=128, ffn_dim=256,
                        qk_norm=True),
}


def _pair(name, seed=0):
    jcfg = J.CausalLMConfig(**CONFIGS[name])
    jp = J.init_causal_lm(jcfg, jax.random.key(seed))
    if jcfg.qkv_bias:                      # non-zero biases and norms
        rng = np.random.default_rng(seed)
        for key in ("q", "k", "v"):
            jp["layers"][key]["bias"] = jnp.asarray(rng.standard_normal(
                jp["layers"][key]["bias"].shape).astype(np.float32) * 0.1)
    if jcfg.qk_norm:
        rng = np.random.default_rng(seed + 1)
        for key in ("q_norm", "k_norm"):
            jp["layers"][key]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(
                jp["layers"][key]["scale"].shape).astype(np.float32))
    cfg = P.CausalLMConfig(**CONFIGS[name])
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, jp, cfg, causal_lm_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, masked):
    jcfg, jp, cfg, p = _pair(name)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24))
    mask = None
    if masked:
        mask = np.ones((2, 24), np.int32)
        mask[1, 17:] = 0
    ref = np.asarray(J.lm_forward(jp, jcfg, jnp.asarray(tokens),
                                  None if mask is None else jnp.asarray(mask)))
    ours = P.lm_forward(p, cfg, torch.from_numpy(tokens),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("name", ["qwen3-tiny", "qwen2-tiny", "qwen3-hd128"])
def test_decode_step_matches_jax(name, per_slot):
    """Eight decode steps from embeddings; per-slot positions start the two
    rows at different depths (row 1 three steps behind row 0)."""
    jcfg, jp, cfg, p = _pair(name)
    rng = np.random.default_rng(2)
    b, steps, max_len = 2, 8, 16
    jcache = J.init_lm_cache(jcfg, b, max_len)
    cache = P.init_lm_cache(cfg, b, max_len, device="cpu")
    for s in range(steps):
        emb = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        if per_slot:
            pos = np.array([s + 3, s], np.int32)
            jpos, ppos = jnp.asarray(pos), torch.from_numpy(pos).long()
        else:
            jpos, ppos = jnp.int32(s), s
        ref, jcache = J.lm_decode_step(jp, jcfg, jnp.asarray(emb), jpos,
                                       jcache)
        ours, cache = P.lm_decode_step(p, cfg, torch.from_numpy(emb), ppos,
                                       cache)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=0, err_msg=f"step {s}")
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=TOL, rtol=0)


def test_decode_equals_forward():
    """Teacher-forcing one token a step through the cache gives the
    forward's logits, at a scalar and at per-slot positions."""
    _, _, cfg, p = _pair("qwen3-tiny")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    full = P.lm_forward(p, cfg, tokens)
    for per_slot in (False, True):
        cache = P.init_lm_cache(cfg, 2, 12, device="cpu")
        for s in range(12):
            pos = torch.full((2,), s) if per_slot else s
            out, cache = P.lm_decode_step(
                p, cfg, P.embed_tokens(p, tokens[:, s]), pos, cache)
            torch.testing.assert_close(out, full[:, s], atol=TOL, rtol=0)


def test_init_layout_and_resize():
    jcfg = J.CausalLMConfig(**CONFIGS["qwen2-tiny"])
    cfg = P.CausalLMConfig(**CONFIGS["qwen2-tiny"])
    jp = J.init_causal_lm(jcfg, jax.random.key(0))
    p = P.init_causal_lm(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert P.tree_map(lambda t: tuple(t.shape), p) == shapes
    assert float(p["layers"]["q"]["kernel"].std()) == pytest.approx(
        128 ** -0.5, rel=0.05)
    grown, gcfg = P.resize_embeddings(p, cfg, 400,
                                      torch.Generator().manual_seed(1))
    assert gcfg.vocab_size == 400 and grown["embed"].shape == (400, 128)
    assert grown["lm_head"]["kernel"].shape == (128, 400)
    new = grown["embed"][320:]
    mean = p["embed"].mean(0)
    assert float((new - mean).std()) == pytest.approx(0.02, rel=0.1)
    torch.testing.assert_close(grown["embed"][:320], p["embed"])
    cut, ccfg = P.resize_embeddings(p, cfg, 100,
                                    torch.Generator().manual_seed(1))
    assert ccfg.vocab_size == 100 and cut["lm_head"]["kernel"].shape[1] == 100


def test_qwen3_published_config():
    cfg = P.CausalLMConfig.qwen3_0_6b()
    assert (cfg.d_model, cfg.layers, cfg.heads, cfg.kv_heads, cfg.head_dim,
            cfg.ffn, cfg.vocab_size) == (1024, 28, 16, 8, 128, 3072, 151936)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.rope_theta == 1e6


def test_moe_raises():
    """MoE configs, which raised before the MoE slice, now build and run:
    the qwen3-tiny widths with 4 experts of 64 (top 2) drawn by JAX, the
    port's logits within 1e-4 of JAX's (``test_torch_moe.py`` holds the
    rest); the port's own draw has JAX's layout; a config without top-k
    still raises, as in JAX."""
    kw = dict(CONFIGS["qwen3-tiny"], num_experts=4, experts_per_tok=2,
              moe_ffn_dim=64)
    jcfg, cfg = J.CausalLMConfig(**kw), P.CausalLMConfig(**kw)
    jp = J.init_causal_lm(jcfg, jax.random.key(0))
    p = causal_lm_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    ref = np.asarray(J.lm_forward(jp, jcfg, jnp.asarray(tokens)))
    ours = P.lm_forward(p, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)
    own = P.init_causal_lm(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert P.tree_map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
    with pytest.raises(ValueError, match="experts_per_tok"):
        P.CausalLMConfig(num_experts=4)


def _hf(kind):
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=160, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=96, rope_theta=1e6,
                  max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(0)
    if kind == "qwen3":
        hc = transformers.Qwen3Config(head_dim=32, tie_word_embeddings=True,
                                      **common)
        return transformers.Qwen3ForCausalLM(hc).eval()
    hc = transformers.Qwen2Config(tie_word_embeddings=False, **common)
    model = transformers.Qwen2ForCausalLM(hc).eval()
    with torch.no_grad():                 # non-zero q/k/v biases
        for name, t in model.named_parameters():
            if name.endswith("proj.bias"):
                t.normal_(0, 0.1)
    return model


@pytest.mark.parametrize("kind", ["qwen3", "qwen2"])
def test_port_from_hf(kind):
    hf = _hf(kind)
    params, cfg = P.port_causal_lm_from_hf(hf, device="cpu")
    jparams, jcfg = J.port_causal_lm_from_hf(hf)
    assert cfg.qk_norm == (kind == "qwen3") == jcfg.qk_norm
    assert cfg.qkv_bias == (kind == "qwen2") and cfg.head_dim == jcfg.head_dim
    tokens = np.random.default_rng(4).integers(0, 160, (2, 20))
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens)).logits.numpy()
    ours = P.lm_forward(params, cfg, torch.from_numpy(tokens)).numpy()
    ref = np.asarray(J.lm_forward(jparams, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
